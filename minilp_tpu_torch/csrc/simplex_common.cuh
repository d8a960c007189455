// Helpers shared by the port's simplex kernels (K1 in batched_simplex.cu,
// K2 in streaming_simplex.cu, K3 in packed_simplex.cu): the status codes,
// the argmax order, the NaN rules and, for K1 and K2, block reductions.
//
// K1 and K2 run one LP in one thread block of kThreads threads, with
// block-uniform control flow: every loop scalar is the result of a block
// reduction and so identical in every thread.  The reductions below fold
// their per-warp partials in warp order in every thread, and each starts with
// a barrier that protects its shared scratch from the previous reader.  The
// scratch is a struct of the including kernel with members
// `float red_f[kWarps]` and `int red_i[kWarps]`.
//
// Semantics kept from the TPU kernels: lowest-index ties in argmax/argmin,
// NaN above everything in argmax, and NaN propagation in min/max where the
// TPU kernel used jnp.minimum/jnp.maximum.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;

// Status and VarStat codes (minilp_tpu_torch/status.py).
constexpr int RUNNING = 0, OPTIMAL = 1, INFEASIBLE = 2, UNBOUNDED = 3,
              MAX_ITER = 4, NUMERICAL = 5;
constexpr int AT_LOWER = 0, AT_UPPER = 1, FREE = 2, FIXED = 3, BASIC = 4;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);  // jnp.minimum semantics
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);  // jnp.maximum semantics
}

// argmax order: larger value first, NaN above everything, lower index on ties
// (lax.argmax / torch.argmax semantics).
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// x of a nonbasic variable from its status: AT_LOWER and FIXED rest at the
// lower bound, AT_UPPER at the upper, FREE (and BASIC) at zero.
__device__ __forceinline__ float nonbasic_x(int v, float l, float h) {
  if (v == AT_LOWER || v == FIXED) return l;
  if (v == AT_UPPER) return h;
  return 0.f;
}

template <class S>
__device__ float block_sum(float v, S& sm) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red_f[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = sm.red_f[0];
  for (int i = 1; i < kWarps; ++i) s += sm.red_f[i];
  return s;
}

template <class S>
__device__ int block_sum_int(int v, S& sm) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red_i[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int i = 0; i < kWarps; ++i) s += sm.red_i[i];
  return s;
}

template <class S>
__device__ int block_min_int(int v, S& sm) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red_i[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = sm.red_i[0];
  for (int i = 1; i < kWarps; ++i) s = min(s, sm.red_i[i]);
  return s;
}

template <class S>
__device__ float block_min_nan(float v, S& sm) {
  for (int o = 16; o > 0; o >>= 1) v = min_nan(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red_f[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = sm.red_f[0];
  for (int i = 1; i < kWarps; ++i) s = min_nan(s, sm.red_f[i]);
  return s;
}

template <class S>
__device__ float block_max_nan(float v, S& sm) {
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red_f[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = sm.red_f[0];
  for (int i = 1; i < kWarps; ++i) s = max_nan(s, sm.red_f[i]);
  return s;
}

// Block argmax of (v, idx) pairs under `better`; on return v and idx hold the
// winner in every thread.
template <class S>
__device__ void block_argmax_pair(float& v, int& idx, S& sm) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (better(ov, oi, v, idx)) { v = ov; idx = oi; }
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    sm.red_f[threadIdx.x >> 5] = v;
    sm.red_i[threadIdx.x >> 5] = idx;
  }
  __syncthreads();
  v = sm.red_f[0];
  idx = sm.red_i[0];
  for (int i = 1; i < kWarps; ++i)
    if (better(sm.red_f[i], sm.red_i[i], v, idx)) { v = sm.red_f[i]; idx = sm.red_i[i]; }
}

template <class S>
__device__ int block_argmax(float v, int idx, S& sm) {
  block_argmax_pair(v, idx, sm);
  return idx;
}

// ---- dense kernels on one LP ----------------------------------------------
// Pointers to data the kernel writes carry no __restrict__: the read-only
// (non-coherent) cache path must never serve them.

// A helper below run by `size` blocks together takes the share of block
// `rank` (the grid phases of K1 and K2); the default (0, 1) is the whole job
// in one block.
// Every output keeps one fixed-order sum whatever the share, so the results do
// not depend on (rank, size).

// f(i, sum_j M[i, j] x[j]) for each row i < rows: one warp per row, lanes
// stride the row (coalesced), fixed-order shuffle sum; lane 0 calls f.
template <typename F>
__device__ void matvec(const float* M, const float* x, int rows, int cols, F f,
                       int rank = 0, int size = 1) {
  const int lane = threadIdx.x & 31;
  for (int i = rank * kWarps + (threadIdx.x >> 5); i < rows; i += size * kWarps) {
    const float* row = M + (size_t)i * cols;
    float acc = 0.f;
    for (int j = lane; j < cols; j += 32) acc = fmaf(row[j], x[j], acc);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) f(i, acc);
  }
}

// f(j, sum_i y[i] M[i, j]) for each column j < cols: one thread per column
// (neighbouring threads read neighbouring addresses), four columns in flight
// per thread, each summed over i in order.
template <typename F>
__device__ void colsums(const float* y, const float* M, int rows, int cols, F f,
                        int rank = 0, int size = 1) {
  const int threads = size * kThreads;
  for (int j0 = rank * kThreads + threadIdx.x; j0 < cols; j0 += 4 * threads) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int jj[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) { jj[k] = j0 + k * threads; ok[k] = jj[k] < cols; }
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const float yi = y[i];
      const float* row = M + (size_t)i * cols;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ok[k]) acc[k] = fmaf(yi, row[jj[k]], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (ok[k]) f(jj[k], acc[k]);
  }
}

}  // namespace
