// One LP over a cooperative grid: the machinery shared by K1
// (batched_simplex.cu, a launch of one LP) and K2 (streaming_simplex.cu).
//
// Block 0, the leader, runs the whole simplex loop with block-uniform
// control flow, exactly as one block would.  Blocks 1..G-1 are workers:
// they sleep on a command word in global memory (`worker_loop`) and join the
// grid phases the leader posts (`post`).  A grid phase hands out its outputs
// by (rank, size) = (blockIdx.x, G), with a `grid_sync` before each step
// that reads what another block wrote, and ends on a `grid_sync`, so that a
// worker is back at its wait before the leader can post again.  Every output
// keeps the fma chain it has on one block, so results do not depend on G.
// With G = 1 a post is a block barrier and so is a grid barrier.  (K1 hands a
// pivot's phases to the leader's thread-block cluster instead, through
// `cluster_sync` and `cluster_map` below; the grid keeps its refresh.)
//
// Memory visibility: L1 is not coherent across SMs.  The leader publishes
// with a fence and a release store of the epoch, a worker takes it with an
// acquire load; a grid barrier fences on both sides.  Data the kernels write
// never goes through `__ldg` or `const __restrict__` pointers.

#pragma once

#include "simplex_common.cuh"

namespace {

constexpr int kMaxGrid = 1024;  // blocks a launch may have
constexpr unsigned kExit = 0;   // the command that ends a worker's loop

// Global-memory control block.  The launch zeroes its first four words
// (`zero_ctl`); the leader posts a command by writing `cmd` and then
// releasing `epoch` + 1, and a worker acquires the epoch it expects.
struct Ctl {
  unsigned cmd, epoch;  // the leader's command and its sequence number
  unsigned count, gen;  // grid barrier: arrivals, and the generation
  float tell[kMaxGrid]; // each block's share of a grid-wide value (K2's telltale)
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Every one of the `size` blocks of the grid waits here until all have
// arrived; the writes of each block before it are visible to every block
// after it.  Thread 0 of each block arrives and waits, between two block
// barriers and two fences (the pattern of cooperative_groups' grid sync),
// with a short sleep in the wait.  With size 1 it is a block barrier.
__device__ void grid_sync(Ctl* ctl, int size) {
  __syncthreads();
  if (size == 1) return;
  if (threadIdx.x == 0) {
    const unsigned g = ld_acquire(&ctl->gen);
    __threadfence();
    if (atomicAdd(&ctl->count, 1u) == (unsigned)size - 1) {
      atomicExch(&ctl->count, 0u);
      st_release(&ctl->gen, g + 1);
    } else {
      while (ld_acquire(&ctl->gen) == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The leader posts command `cmd` to the other size - 1 blocks (its writes so
// far become visible to the worker that acquires it); `epoch` counts the
// posts, uniform in the block.
__device__ void post(Ctl* ctl, unsigned& epoch, unsigned cmd, int size) {
  ++epoch;
  __syncthreads();
  if (threadIdx.x == 0 && size > 1) {
    __threadfence();
    ctl->cmd = cmd;
    st_release(&ctl->epoch, epoch);
  }
}

// A worker block: sleep until the leader posts, run(cmd) for its share of
// the phase, and wait again; return on kExit.  Thread 0 polls the epoch every
// `poll_ns`: a long sleep keeps the waiting blocks' polls off the leader's
// L2 bandwidth, a short one wakes them sooner for a short phase.  `slot` is
// an int in the block's shared memory; every phase that run() starts ends on
// a grid barrier, so thread 0 never rewrites it early.
template <class Run>
__device__ void worker_loop(Ctl* ctl, int& slot, unsigned poll_ns, Run run) {
  for (unsigned epoch = 1;; ++epoch) {
    if (threadIdx.x == 0) {
      while (ld_acquire(&ctl->epoch) != epoch) __nanosleep(poll_ns);
      slot = (int)ld_acquire(&ctl->cmd);
    }
    __syncthreads();
    const int cmd = slot;
    if (cmd == (int)kExit) return;
    run(cmd);
  }
}

// ---- one thread-block cluster (Hopper) -------------------------------------
// K1 hands its per-pivot phases to the blocks of the leader's cluster, which
// meet at the cluster's hardware barrier instead of the grid's atomics.

// Every thread of every block of this block's cluster waits here until all
// have arrived; the writes of each (global and shared memory) before it are
// visible to every thread of the cluster after it (release and acquire at
// cluster scope).  Block-uniform, like __syncthreads.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of `p`, an object in this block's shared memory, in the shared
// memory of block `rank` of the cluster (a generic pointer: distributed shared
// memory).  The object must not be read after its block has exited.
template <class T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
  unsigned long long r;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(r) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(r);
}

// Host side: zero the control block's command, epoch and barrier words on
// `stream`, ahead of a cooperative launch.
inline cudaError_t zero_ctl(Ctl* ctl, cudaStream_t stream) {
  return cudaMemsetAsync(ctl, 0, 4 * sizeof(unsigned), stream);
}

}  // namespace
