// K2, the streaming single-LP simplex kernel, in CUDA C++ for Hopper (sm_90a).
//
// Replaces minilp_tpu/ops/kernels/streaming_simplex.py::_stream_kernel, the
// Pallas TPU kernel launched by stream_kernel_call.  It computes the same
// thing: one Netlib-scale LP inside one launch.  A is held transposed (Aᵀ,
// n x m), so that column j of A is one contiguous row.  Each MAJOR iteration
// prices every column once against Aᵀ (phase 1: composite infeasibility
// costs; phase 2: reduced costs from y = c_B B^-1), picks the top `minor_k`
// candidates by projected steepest-edge score, forms their tableau block
// W[k] = B^-1 a_k, and runs up to `minor_k` MINOR pivots on W alone: exact
// candidate reduced costs (phase 2) or recomputed against sigma (phase 1),
// stale Devex weights synced on the entering and leaving lanes, the ratio
// test with bound flips, and (at m >= long_step_min_m) the phase-1 long
// step.  The pivots' eta vectors are composed in a ledger and folded into the
// dense f32 B^-1 once per major.  Every `refactor_period` pivots, and before
// any terminal claim, B^-1 is refreshed by Newton sweeps X <- 2X - (X B) X
// against B gathered from Aᵀ by basis index; the telltale |I - X B|_inf >
// 0.5 exits NUMERICAL.  The refresh recomputes x_B (with one refinement
// step), d and the steepest-edge weights 1 + |B^-1 a_j|^2.  Cold from the
// slack basis, or warm from (basis, vstat, B^-1): the chunk driver relaunches
// warm from the previous launch's outputs.
//
// Semantics kept from the TPU kernel: f32 arithmetic (no TF32, no fast math),
// lowest-index ties in every argmax/argmin, the ratio tie window
// ratio <= t*1.0001 + 1e-6, terminal claims believed only from a freshly
// refreshed state (fresh/force), the confirm/regress rule on the refreshed
// state, the suboptimization exit at minor_decay, phase-1 stall accounting by
// measured infeasibility progress, and NaN propagation wherever the TPU kernel
// used jnp.maximum/jnp.minimum.  What went: the TPU's one-hot selects and
// masked sums (an index is an index here: c_B/lo_B/hi_B, candidate columns
// and the basis rows are read by index), its DMA double buffers, and the
// candidate lanes past the selected count (inert on the TPU too, skipped).
//
// What bounds it on an H100, at the 25fv47 shape (m ~ 824, n ~ 2.4k): Aᵀ
// (8 MB) and B^-1 (2.7 MB) cannot live in an SM's 227 KB of shared memory, so
// they stay in global memory and, with the refresh scratch (3 m^2 floats,
// 8 MB), resident in the 50 MB L2.  Shared memory holds the reduction
// scratch, the double-buffered 16-deep GEMM slabs (in turn the column sums'
// staged chunks and the merge's list heads) and the candidate lanes (37 KB).
//
// One cooperative grid of G blocks (one per SM) runs one LP.  Block 0, the
// leader, runs the whole loop with block-uniform control flow (every loop
// scalar comes from a block reduction), exactly as one block would.  Blocks
// 1..G-1 are workers: they sleep on a command word in the workspace and join
// the phases the leader posts, each of which hands out output units, rows
// and columns over the grid with grid barriers between dependent steps:
// - the Newton refresh (two sweeps: 4 m x m products, 4.5 GFLOP at m = 824)
//   and the vector recompute (x_B, y, d and the steepest-edge weights, an
//   n x m x m product of 3.5 GFLOP).  Each product takes the unit shape,
//   from 128 x 128 down to 32 x 128, with the fewest waves over the G blocks
//   times a unit's time (`pick_unit`): at 25fv47 the Newton products run
//   91 units of 128 x 64 (49 tiles of 128 x 128 left 83 blocks idle) and
//   the steepest-edge product 133 tiles of 128 x 128 (whole row tiles left
//   113 idle).  A weight's sum of squares is left per row and 128-column
//   tile and summed over the tiles in order after a barrier.  The column
//   sums of b_eff and of x_B's refinement stage 32-column tiles through
//   shared memory as y's do;
// - a major's pricing (`price`): y = c_B B^-1 or sigma B^-1 (32-column
//   tiles of B^-1 staged through shared memory, one lane's chain a column),
//   then Aᵀ y and the scores (a warp a row of Aᵀ); each block keeps the top
//   `minor_k` (score, index) pairs of its own columns, and every block merges
//   the G lists into the major's candidates, exactly the pairs and order the
//   repeated argmax of one block picks, since `better` is a strict total
//   order; then W = B^-1 A_cand (a warp a row of B^-1 and eight candidates);
// - the fold of the eta ledger into B^-1 (`fold`): the gather of P, then
//   B^-1 -= etasᵀ P, entries over the grid's threads.
// Every output keeps the fma chain it has on one block, so the results are
// bit-identical for every G.  The minors (ratio test, long step, the
// updates of W, the ledger and x_B), the refresh decision and the terminal
// claims stay on the leader.  A major is then bounded by its minors (about
// three pivots at 25fv47, each a chain of block reductions on the leader's
// SM: some 45% of a major), by latency-bound chains on few blocks (y's
// column sums on 26 of 132 blocks, the merge on one warp) and by its five
// grid barriers and two posts, not by bytes; A is still dense in pricing
// and W though it is about 1% full.  The refresh is bounded by its
// products, in waves of units over the grid.  The grid's machinery (command
// word, barrier, worker loop) is shared with K1 in simplex_grid.cuh.
//
// Built with -DK2_CLOCKS, the leader also sums clock64() cycles per part of
// a major (`streaming_simplex_clocks`).  The normal build carries no clocks.

#include "simplex_common.cuh"
#include "simplex_grid.cuh"

namespace {

constexpr int kMaxK = 128;  // candidate lanes (minor_k <= kMaxK)
// GEMM tiling: output units of at most 128 x 128, 16-deep k slabs
// double-buffered in shared memory; the 512 threads (16 x 32) each own a
// patch of PR x PC outputs, so a unit is (32 PR) x (16 PC).
constexpr int kTM = 128, kTN = 128, kTK = 16;
// The refresh's products take units of the shapes (PR, PC) = (4, 8), (4, 4),
// (2, 8), (2, 4), (1, 8) (bits 0..4 of a mask; `pick_unit`): the Newton
// products (4, 8), (4, 4) and (2, 4) (for m x m outputs (2, 8) never has the
// fewest waves times cost); the steepest-edge product those of 128-column
// tiles (16 lanes of 8 columns), the tree of its sums of squares.
constexpr int kShapes = 5;
constexpr unsigned kNewtonShapes = 0b01011, kSeShapes = 0b10101;
// column sums: chunks of kCsRows rows of a 32-column tile staged in shared
// memory, kCsPer rows by each of warps 1..15
constexpr int kCsPer = 8, kCsRows = kCsPer * (kWarps - 1);

#ifdef K2_CLOCKS
// per part of a major: the leader's cycles summed over the launch; then the
// majors they cover.  The refresh's parts come first: its steps as the
// leader runs them (C_REF_SYNC: every grid barrier of the refresh, as the
// leader waits on it), then the rest (the post and the telltale)
enum Part {
  C_REF_GATHER, C_REF_NEWTON, C_REF_COPY, C_REF_BEFF, C_REF_Y, C_REF_MATVEC, C_REF_SE,
  C_REF_SYNC, C_REF_OTHER,
  C_PRICE_Y, C_PRICE_YSYNC, C_PRICE_D, C_PRICE_TOP, C_PRICE_SYNC, C_MERGE, C_TABLEAU, C_TABLEAU_SYNC,
  // the minors: phase 1's candidate costs, the lane scan, the ratio test
  // and its reductions, the leaving row (with the long step), the pivot's
  // or flip's update and its accounting
  C_MIN_COSTS, C_MIN_SCAN, C_MIN_RATIO, C_MIN_ROW, C_MIN_UPDATE,
  C_FOLD_GATHER, C_FOLD_SYNC, C_FOLD_SUM, C_FOLD_SYNC2,
  C_OTHER, kParts
};
__device__ unsigned long long g_clocks[kParts + 1];
#define K2_TICK(part)                 \
  do {                                \
    const long long now_ = clock64(); \
    clk[part] += now_ - clk_last;     \
    clk_last = now_;                  \
  } while (0)
#define K2_MARK(k) \
  if (blockIdx.x == 0 && threadIdx.x == 0) sm.mark[k] = clock64()
// parts first, first + 1, ... end at the marks 0, 1, ... of a phase
#define K2_SPANS(first, marks)                                          \
  do {                                                                  \
    for (int k_ = 0; k_ < (marks); ++k_)                                \
      clk[(first) + k_] += sm.mark[k_] - (k_ ? sm.mark[k_ - 1] : clk_last); \
    clk_last = sm.mark[(marks) - 1];                                    \
  } while (0)
// inside the refresh: the leader's step `part` ends here
#define K2_RSTART() \
  if (blockIdx.x == 0 && threadIdx.x == 0) sm.rlast = clock64()
#define K2_RSTEP(part)                                \
  if (blockIdx.x == 0 && threadIdx.x == 0) {          \
    const long long now_ = clock64();                 \
    sm.rclk[part] += now_ - sm.rlast;                 \
    sm.rlast = now_;                                  \
  }
// after the refresh: its steps into clk, the rest of it as C_REF_OTHER
#define K2_RTAKE()                                          \
  do {                                                      \
    if (threadIdx.x == 0) {                                 \
      const long long now_ = clock64();                     \
      long long rest_ = now_ - clk_last;                    \
      for (int k_ = 0; k_ < C_REF_OTHER; ++k_) {            \
        clk[k_] += sm.rclk[k_];                             \
        rest_ -= sm.rclk[k_];                               \
        sm.rclk[k_] = 0;                                    \
      }                                                     \
      clk[C_REF_OTHER] += rest_;                            \
      clk_last = now_;                                      \
    }                                                       \
  } while (0)
#define K2_RZERO()                                                         \
  if (threadIdx.x == 0)                                                    \
    for (int k_ = 0; k_ < C_REF_OTHER; ++k_) sm.rclk[k_] = 0
#else
#define K2_TICK(part) \
  do {                \
  } while (0)
#define K2_MARK(k) \
  do {             \
  } while (0)
#define K2_SPANS(first, marks) \
  do {                         \
  } while (0)
#define K2_RSTART() \
  do {              \
  } while (0)
#define K2_RSTEP(part) \
  do {                 \
  } while (0)
#define K2_RTAKE() \
  do {             \
  } while (0)
#define K2_RZERO() \
  do {             \
  } while (0)
#endif

struct Params {
  int m, n, slack0, max_iter, refactor_period, newton_sweeps, bland_after, minor_k;
  int se_weights, xb_refine, long_step, warm;
  float feas_tol, opt_tol, pivot_tol, devex_floor, devex_reset, regress_tol,
      minor_decay;
};

// One staged chunk of `colsums_staged`: kCsRows rows of a 32-column tile and
// their weights.
struct CsChunk {
  float M[kCsRows][32];
  float y[kCsRows];
};

// Shared scratch that the phases take in turn.
union Slab {
  struct {  // GEMM slabs, k-major; the padding keeps rows 16-byte aligned
    float As[2][kTK][kTM + 4];
    float Bs[2][kTK][kTN + 4];
  } g;
  CsChunk cs[2];  // column sums, double-buffered
  struct {
    float s[kThreads];  // a block's columns, a (score, column) a thread
    int j[kThreads];
    int pos[kMaxGrid];  // the merge: each block's list's head, at pos
    float hs[kMaxGrid];
    int hj[kMaxGrid];
  } merge;
};

struct Smem {
  float red_f[kWarps];
  int red_i[kWarps];
  alignas(16) Slab slab;
  // candidate lanes (the TPU kernel's (1, 128) lane records)
  int cand_ids[kMaxK];
  int vstat_cand[kMaxK];
  float d_cand[kMaxK];
  float wts_cand[kMaxK];
  float alpha[kMaxK];   // column r of W: the pivot row over the candidates
  float etacol[kMaxK];  // column r of the eta ledger
  int lane_i[3];        // lane scan: found, k_devex, k_bland
  float lane_f[1];      // lane scan: max candidate score
  int merged_i[2];      // the merge: eligible columns, candidates
  float merged_f;       // the merge: the top score
  int cmd;              // a worker's current command
#ifdef K2_CLOCKS
  long long mark[7];    // the leader's clock at the marks of a phase
  long long rclk[C_REF_OTHER];  // the leader's cycles per step of a refresh
  long long rlast;              // and its clock at the last step's end
#endif
};

// ---- the leader's commands to the grid (simplex_grid.cuh) ------------------
// A command's argument rides above its low kCmdBits bits: kPrice's flags,
// kFold's ledger length.
constexpr unsigned kRecompute = 1, kRefresh = 2, kPrice = 3, kFold = 4;
constexpr int kCmdBits = 4;
constexpr unsigned kP1 = 1, kDense = 2, kBland = 4;  // kPrice's flags

// One LP's global-memory state (the TPU kernel's VMEM scratch and outputs).
struct Lp {
  const float *AT, *b, *c, *lo, *hi;  // inputs, never written
  int *basis, *vstat, *mon;           // outputs
  float* Binv;                        // output: the maintained inverse
  float *BT, *H, *Xn;                 // m x m refresh scratch
  float *W, *etas, *P;                // minor_k x m
  float *xB, *loB, *hiB, *cB, *beff, *y, *ratio, *tgt;  // m
  float *d, *d1, *wts, *sc, *xn;      // n
  float* sep;                         // n x ceil(m / 128): steepest-edge partial sums
  float* lsc;                         // kMaxGrid x minor_k: each block's top scores
  int* lid;                           // kMaxGrid x minor_k: and their columns
  int* eta_rs;                        // minor_k: the leaving row of each ledger eta
  int* part;                          // kMaxGrid x 3: list length, eligible, lowest eligible
};

// v = the N floats at p in shared memory, 16-byte aligned for N >= 4: the
// four from v[4 c] on at p + c step.
template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const float* p, int step = 4) {
  if constexpr (N == 1) {
    v[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + q / 4 * step);
      v[q] = t.x;
      v[q + 1] = t.y;
      v[q + 2] = t.z;
      v[q + 3] = t.w;
    }
  }
}

// C (M x N) = A (M x K) * B (K x N), walked as output units of (32 PR) x
// (16 PC) in row-major order with k in order, so every output is the same
// fixed-order fma chain whatever the unit (zero padding past K adds nothing).
// A is row-major, (i, k) at A[i * lda + k]; B is (k, j) at B[k * ldb + j],
// or with kBT stored transposed, (k, j) at B[j * ldb + k].  Each slab load
// reads along the stored rows, and the next slab's loads are in flight while
// the current one is multiplied.  epi(i0, j0, acc) runs in every thread once
// per unit, with the thread's float[PR][PC] patch at rows i0 + PR ty + a and
// columns j0 + PC tx + c (ty = tid / 16, tx = tid % 16); entries outside
// M x N hold zeros and epi skips them.  Over a grid, block `rank` of `size`
// takes the units rank, rank + size, ...
template <bool kBT, int PR, int PC, class Epi>
__device__ void gemm(const float* A, int lda, const float* B, int ldb, int M, int N,
                     int K, Epi epi, Smem& sm, int rank, int size) {
  constexpr int TM = 32 * PR, TN = 16 * PC;
  constexpr int kPerA = TM * kTK / kThreads, kPerB = TN * kTK / kThreads;  // per thread
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * tiles_n;
  const int slabs = (K + kTK - 1) / kTK;
  float ra[kPerA], rb[kPerB];
  // element e of a slab: (row, k) of A and (k, col) of B, in load order
  auto a_at = [&](int e, int& r, int& k) {
    r = e / kTK;
    k = e % kTK;
  };
  auto b_at = [&](int e, int& k, int& cc) {
    k = kBT ? e % kTK : e / TN;
    cc = kBT ? e / kTK : e % TN;
  };
  // where column cc of a B slab sits in shared memory: with 8 columns a
  // thread, its first four at 4 tx and its last four at 64 + 4 tx, so that
  // each of its two float4 reads is contiguous across the lanes (no bank
  // conflict); with 4, in order
  auto b_col = [](int cc) { return PC == 8 ? (cc >> 2 & 1) * 64 + (cc >> 3) * 4 + (cc & 3) : cc; };
  for (int t = rank; t < tiles; t += size) {
    const int i0 = (t / tiles_n) * TM, j0 = (t % tiles_n) * TN;
    auto fetch = [&](int sl) {
      const int k0 = sl * kTK;
#pragma unroll
      for (int u = 0; u < kPerA; ++u) {
        int r, k;
        a_at(tid + u * kThreads, r, k);
        const int gi = i0 + r, gk = k0 + k;
        ra[u] = (gi < M && gk < K) ? A[(size_t)gi * lda + gk] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPerB; ++u) {
        int k, cc;
        b_at(tid + u * kThreads, k, cc);
        const int gk = k0 + k, gj = j0 + cc;
        rb[u] = (gk < K && gj < N)
                    ? (kBT ? B[(size_t)gj * ldb + gk] : B[(size_t)gk * ldb + gj]) : 0.f;
      }
    };
    auto stash = [&](int buf) {
#pragma unroll
      for (int u = 0; u < kPerA; ++u) {
        int r, k;
        a_at(tid + u * kThreads, r, k);
        sm.slab.g.As[buf][k][r] = ra[u];
      }
#pragma unroll
      for (int u = 0; u < kPerB; ++u) {
        int k, cc;
        b_at(tid + u * kThreads, k, cc);
        sm.slab.g.Bs[buf][k][b_col(cc)] = rb[u];
      }
    };
    float acc[PR][PC];
#pragma unroll
    for (int a = 0; a < PR; ++a)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[a][c] = 0.f;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int sl = 0; sl < slabs; ++sl) {
      const int buf = sl & 1;
      if (sl + 1 < slabs) fetch(sl + 1);
#pragma unroll
      for (int k = 0; k < kTK; ++k) {
        float av[PR], bv[PC];
        lds(av, &sm.slab.g.As[buf][k][ty * PR]);
        lds(bv, &sm.slab.g.Bs[buf][k][tx * 4], 64);  // as b_col placed them
#pragma unroll
        for (int a = 0; a < PR; ++a)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
      }
      if (sl + 1 < slabs) stash(buf ^ 1);
      __syncthreads();
    }
    epi(i0, j0, acc);
  }
}

// The unit shape of a product of M x N outputs over `size` blocks, of the
// shapes in `allowed`: the fewest waves of units over the blocks times a
// unit's time, the largest shape on a tie.  Every block computes the same
// from (M, N, size).
__device__ __forceinline__ int pick_unit(int M, int N, int size, unsigned allowed) {
  constexpr int pr[kShapes] = {4, 4, 2, 2, 1}, pc[kShapes] = {8, 4, 8, 4, 8};
  // the time of an output in each shape on one SM, relative (a unit's time
  // on an H100 at k = 824: 129-138, 78, 95-99, 58 and 91 µs)
  constexpr int cost_of[kShapes] = {100, 116, 145, 174, 272};
  int best = -1;
  long long best_cost = 0;
#pragma unroll
  for (int u = 0; u < kShapes; ++u) {
    if (!(allowed >> u & 1)) continue;
    const int tm = 32 * pr[u], tn = 16 * pc[u];
    const long long units = (long long)((M + tm - 1) / tm) * ((N + tn - 1) / tn);
    const long long cost = (units + size - 1) / size * tm * tn * cost_of[u];
    if (best < 0 || cost < best_cost) {
      best = u;
      best_cost = cost;
    }
  }
  return best;
}

// `gemm` over the grid in the unit shape that pick_unit gives, of `kAllowed`.
template <unsigned kAllowed, bool kBT, class Epi>
__device__ void gemm_grid(const float* A, int lda, const float* B, int ldb, int M, int N,
                          int K, Epi epi, Smem& sm, int rank, int size) {
  const int u = pick_unit(M, N, size, kAllowed);
  if constexpr (kAllowed & 1) if (u == 0) gemm<kBT, 4, 8>(A, lda, B, ldb, M, N, K, epi, sm, rank, size);
  if constexpr (kAllowed & 2) if (u == 1) gemm<kBT, 4, 4>(A, lda, B, ldb, M, N, K, epi, sm, rank, size);
  if constexpr (kAllowed & 4) if (u == 2) gemm<kBT, 2, 8>(A, lda, B, ldb, M, N, K, epi, sm, rank, size);
  if constexpr (kAllowed & 8) if (u == 3) gemm<kBT, 2, 4>(A, lda, B, ldb, M, N, K, epi, sm, rank, size);
  if constexpr (kAllowed & 16) if (u == 4) gemm<kBT, 1, 8>(A, lda, B, ldb, M, N, K, epi, sm, rank, size);
}

// Row i of a row-major matrix with leading dimension ld, as a `row` of
// colsums_staged.
struct Rows {
  const float* M;
  int ld;
  __device__ const float* operator()(int i) const { return M + (size_t)i * ld; }
};

// f(j, sum_i y(i) row(i)[j]) for each column j < cols, with the chain of
// `colsums` (simplex_common.cuh): fmaf over i in order from 0, and with
// kSkip the rows whose weight y(i) is 0 skipped (on finite data they add
// nothing).  A block takes 32-column tiles (rank, rank + size, ...); warps
// 1.. stage each chunk of kCsRows rows of the tile (kCsPer rows a warp,
// loaded together) and its weights in shared memory while warp 0 runs the
// previous chunk's chains, one column a lane.
template <bool kSkip, class Y, class Row, class F>
__device__ void colsums_staged(Y y, Row row, int rows, int cols, F f, Smem& sm, int rank,
                               int size) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (rows + kCsRows - 1) / kCsRows;
  for (int t = rank; t * 32 < cols; t += size) {
    const int j = t * 32 + lane;
    auto stage = [&](int c) {  // warps 1..kWarps-1
      CsChunk& ch = sm.slab.cs[c & 1];
      float v[kCsPer];
#pragma unroll
      for (int u = 0; u < kCsPer; ++u) {
        const int i = c * kCsRows + (warp - 1) + u * (kWarps - 1);
        v[u] = (i < rows && j < cols) ? row(i)[j] : 0.f;
      }
      const int r = threadIdx.x - 32;
      const float yr = (r < kCsRows && c * kCsRows + r < rows) ? y(c * kCsRows + r) : 0.f;
#pragma unroll
      for (int u = 0; u < kCsPer; ++u) ch.M[(warp - 1) + u * (kWarps - 1)][lane] = v[u];
      if (r < kCsRows) ch.y[r] = yr;
    };
    if (warp > 0) stage(0);
    __syncthreads();
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (warp == 0) {
        const CsChunk& ch = sm.slab.cs[c & 1];
        const int nr = min(kCsRows, rows - c * kCsRows);
#pragma unroll 8
        for (int r = 0; r < nr; ++r) {
          const float yr = ch.y[r];
          if (!kSkip || yr != 0.f) acc = fmaf(yr, ch.M[r][lane], acc);
        }
      } else if (c + 1 < chunks) {
        stage(c + 1);
      }
      __syncthreads();
    }
    if (warp == 0 && j < cols) f(j, acc);
  }
}

__device__ __forceinline__ float sigma_of(float x, float lb, float ub, float ftol) {
  return x < lb - ftol ? -1.f : (x > ub + ftol ? 1.f : 0.f);
}

__device__ __forceinline__ float viol_of(float x, float lb, float ub) {
  return max_nan(lb - x, 0.f) + max_nan(x - ub, 0.f);
}

// x_B (with one refinement step), the reduced costs d and the projected
// steepest-edge weights from B^-1 and the statuses (recompute_vectors), run by
// every block of the grid: each step hands out units, columns or rows, with
// a grid barrier before each step that reads what the last one wrote.
// Not inlined, nor is `refresh`: inlined into the kernel, the grid phases
// made ptxas spill in the leader's major loop (1552 B of spill stores, a
// major 13% slower); called, they are allocated on their own.
__device__ __noinline__ void recompute_vectors(const Lp& L, const Params& p, Smem& sm, Ctl* ctl) {
  const int m = p.m, n = p.n, rank = blockIdx.x, size = gridDim.x;
  const int gtid = rank * kThreads + threadIdx.x, threads = size * kThreads;
  const int se_tiles = (m + kTN - 1) / kTN;
  if (p.se_weights) {
    // gamma_j = 1 + |B^-1 a_j|^2, from the rows of Aᵀ B^-ᵀ: each output row
    // leaves its sum of squares over each 128-column tile in L.sep (a
    // thread's chain over its 8 columns, then a tree over the 16 lanes of
    // the row); the sum over the tiles, in order, comes after a barrier
    gemm_grid<kSeShapes, true>(
        L.AT, m, L.Binv, m, n, m, m,
        [&](int i0, int j0, auto& acc) {
          constexpr int PR = sizeof(acc) / sizeof(acc[0]), PC = sizeof(acc[0]) / sizeof(float);
          static_assert(PC * 16 == kTN, "a partial sums a 128-column tile");
          const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
          for (int a = 0; a < PR; ++a) {
            float s = 0.f;
#pragma unroll
            for (int cc = 0; cc < PC; ++cc)
              if (j0 + tx * PC + cc < m) s = fmaf(acc[a][cc], acc[a][cc], s);
            for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
            const int i = i0 + ty * PR + a;
            if (tx == 0 && i < n) L.sep[(size_t)i * se_tiles + j0 / kTN] = s;
          }
        },
        sm, rank, size);
    K2_RSTEP(C_REF_SE);
  }
  for (int j = gtid; j < n; j += threads) L.xn[j] = nonbasic_x(L.vstat[j], L.lo[j], L.hi[j]);
  K2_RSTEP(C_REF_BEFF);
  grid_sync(ctl, size);
  K2_RSTEP(C_REF_SYNC);
  // b_eff = b - A x_N = b - sum_j x_N[j] Aᵀ[j, :]
  colsums_staged<true>([&](int j) { return L.xn[j]; }, Rows{L.AT, m}, n, m,
                       [&](int k, float acc) { L.beff[k] = L.b[k] - acc; }, sm, rank, size);
  K2_RSTEP(C_REF_BEFF);
  grid_sync(ctl, size);
  K2_RSTEP(C_REF_SYNC);
  matvec(L.Binv, L.beff, m, m, [&](int i, float acc) { L.xB[i] = acc; }, rank, size);
  K2_RSTEP(C_REF_MATVEC);
  grid_sync(ctl, size);
  K2_RSTEP(C_REF_SYNC);
  if (p.xb_refine) {
    // r = b_eff - B x_B (B x_B = sum_i x_B[i] Aᵀ[basis[i], :]); x_B += B^-1 r
    colsums_staged<true>([&](int i) { return L.xB[i]; },
                         [&](int i) { return L.AT + (size_t)L.basis[i] * m; }, m, m,
                         [&](int k, float acc) { L.beff[k] = L.beff[k] - acc; }, sm, rank,
                         size);
    K2_RSTEP(C_REF_BEFF);
    grid_sync(ctl, size);
    K2_RSTEP(C_REF_SYNC);
    matvec(L.Binv, L.beff, m, m, [&](int i, float acc) { L.xB[i] = L.xB[i] + acc; },
           rank, size);
    K2_RSTEP(C_REF_MATVEC);
    grid_sync(ctl, size);
    K2_RSTEP(C_REF_SYNC);
  }
  colsums_staged<false>([&](int i) { return L.cB[i]; }, Rows{L.Binv, m}, m, m,
                        [&](int j, float acc) { L.y[j] = acc; }, sm, rank, size);
  K2_RSTEP(C_REF_Y);
  grid_sync(ctl, size);
  K2_RSTEP(C_REF_SYNC);
  matvec(L.AT, L.y, n, m, [&](int j, float acc) {
    L.d[j] = L.vstat[j] == BASIC ? 0.f : L.c[j] - acc;
  }, rank, size);
  K2_RSTEP(C_REF_MATVEC);
  if (p.se_weights) {
    for (int i = gtid; i < n; i += threads) {
      float g = 0.f;
      for (int t = 0; t < se_tiles; ++t) g = g + L.sep[(size_t)i * se_tiles + t];
      L.wts[i] = 1.f + g;
    }
    K2_RSTEP(C_REF_SE);
  }
  grid_sync(ctl, size);
  K2_RSTEP(C_REF_SYNC);
}

// `newton_sweeps` sweeps X <- 2X - (X B) X with B gathered from Aᵀ by basis
// index (once for all sweeps), run by every block of the grid; each block
// leaves its share of |I - X B|_inf of the last sweep in ctl->tell.  The
// sweeps write B^-1 and L.Xn in turn, so an odd count ends on a copy.
__device__ void newton_refresh(const Lp& L, const Params& p, Smem& sm, Ctl* ctl) {
  const int m = p.m, rank = blockIdx.x, size = gridDim.x;
  const size_t mm = (size_t)m * m;
  const size_t gtid = (size_t)rank * kThreads + threadIdx.x, threads = (size_t)size * kThreads;
  K2_RSTART();
  for (size_t e = gtid; e < mm; e += threads)
    L.BT[e] = L.AT[(size_t)L.basis[e / m] * m + e % m];  // Bᵀ row i = column basis[i]
  K2_RSTEP(C_REF_GATHER);
  grid_sync(ctl, size);
  K2_RSTEP(C_REF_SYNC);
  float tmax = 0.f;
  float *X = L.Binv, *Xn = L.Xn;
  for (int s = 0; s < p.newton_sweeps; ++s) {
    tmax = 0.f;
    // H = X B, with B(k, j) = Bᵀ[j, k]; the telltale reads I - H
    gemm_grid<kNewtonShapes, true>(
        X, m, L.BT, m, m, m, m,
        [&](int i0, int j0, auto& acc) {
          constexpr int PR = sizeof(acc) / sizeof(acc[0]), PC = sizeof(acc[0]) / sizeof(float);
          const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
          for (int a = 0; a < PR; ++a)
            for (int cc = 0; cc < PC; ++cc) {
              const int gi = i0 + ty * PR + a, gj = j0 + tx * PC + cc;
              if (gi >= m || gj >= m) continue;
              L.H[(size_t)gi * m + gj] = acc[a][cc];
              tmax = max_nan(tmax, fabsf((gi == gj ? 1.f : 0.f) - acc[a][cc]));
            }
        },
        sm, rank, size);
    K2_RSTEP(C_REF_NEWTON);
    grid_sync(ctl, size);
    K2_RSTEP(C_REF_SYNC);
    // X' = 2X - H X
    gemm_grid<kNewtonShapes, false>(
        L.H, m, X, m, m, m, m,
        [&](int i0, int j0, auto& acc) {
          constexpr int PR = sizeof(acc) / sizeof(acc[0]), PC = sizeof(acc[0]) / sizeof(float);
          const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
          for (int a = 0; a < PR; ++a)
            for (int cc = 0; cc < PC; ++cc) {
              const int gi = i0 + ty * PR + a, gj = j0 + tx * PC + cc;
              if (gi >= m || gj >= m) continue;
              const size_t e = (size_t)gi * m + gj;
              Xn[e] = 2.f * X[e] - acc[a][cc];
            }
        },
        sm, rank, size);
    K2_RSTEP(C_REF_NEWTON);
    grid_sync(ctl, size);
    K2_RSTEP(C_REF_SYNC);
    float* t = X;
    X = Xn;
    Xn = t;
  }
  if (X != L.Binv) {
    for (size_t e = gtid; e < mm; e += threads) L.Binv[e] = X[e];
    K2_RSTEP(C_REF_COPY);
    grid_sync(ctl, size);
    K2_RSTEP(C_REF_SYNC);
  }
  tmax = block_max_nan(tmax, sm);
  if (threadIdx.x == 0) ctl->tell[rank] = tmax;
}

// The refresh as one grid phase: the Newton sweeps, then the vectors.
// Returns the telltale |I - X B|_inf of the last sweep, the max of the
// blocks' shares (NaN-propagating, so independent of the order: a NaN
// telltale does not read as divergence, as on the TPU).
__device__ __noinline__ float refresh(const Lp& L, const Params& p, Smem& sm, Ctl* ctl) {
  newton_refresh(L, p, sm, ctl);
  recompute_vectors(L, p, sm, ctl);  // ends on a grid barrier
  float tell = ctl->tell[0];
  for (int r = 1; r < (int)gridDim.x; ++r) tell = max_nan(tell, ctl->tell[r]);
  return tell;
}

// What a major's pricing gives the leader.
struct Priced {
  int nelig, ncand;  // eligible columns; candidates taken (in sm.cand_ids)
  float best0;       // the top score, NaN-propagating; -inf when none is eligible
};

// A major's pricing, run by every block of the grid (`flags`: kP1 in phase 1,
// kDense to compute y and the reduced costs, kBland under Bland):
// 1. y = sigma B^-1 (phase 1) or c_B B^-1, a block's 32-column tiles;
// 2. d1 or d = the reduced costs over the block's rows of Aᵀ (matvec's
//    share), then their scores; the block's top `minor_k` (score, column)
//    pairs in `better`'s order (one under Bland), into its list in the
//    workspace with its eligible count and lowest eligible column: by rank
//    when each thread holds at most one column (a grid at Netlib scale),
//    else by repeated argmax over the block's columns;
// 3. every block merges the G lists into the candidates: `ncand` rounds of
//    a warp argmax over the list heads, each lane holding the heads of
//    blocks lane, lane + 32, ...; under Bland the candidate is the lowest
//    eligible column;
// 4. W[k, i] = Binv[i, :] . Aᵀ[q_k, :], a warp a row of B^-1 and a group of
//    eight candidates.
// Without kDense (phase 2 right after a refresh) d is already fresh and step
// 1 and the product of step 2 are skipped.  Inlined, as `fold` is: as calls,
// the two made ptxas save more of the leader's registers around them (176 B
// of spill stores in the kernel against 104 inlined).
__device__ __forceinline__ Priced price(const Lp& L, const Params& p, Smem& sm, Ctl* ctl,
                                     unsigned flags) {
  const int m = p.m, n = p.n, K = p.minor_k, tid = threadIdx.x;
  const int rank = blockIdx.x, size = gridDim.x;
  const bool p1 = flags & kP1, bland = flags & kBland;
  float* dcur = p1 ? L.d1 : L.d;
  if (flags & kDense) {
    if (p1)
      colsums_staged<false>(
          [&](int i) { return sigma_of(L.xB[i], L.loB[i], L.hiB[i], p.feas_tol); },
          Rows{L.Binv, m}, m, m, [&](int k, float acc) { L.y[k] = acc; }, sm, rank, size);
    else
      colsums_staged<false>([&](int i) { return L.cB[i]; }, Rows{L.Binv, m}, m, m,
                            [&](int k, float acc) { L.y[k] = acc; }, sm, rank, size);
    K2_MARK(0);
    grid_sync(ctl, size);
    K2_MARK(1);
    matvec(L.AT, L.y, n, m, [&](int j, float acc) {
      dcur[j] = L.vstat[j] == BASIC ? 0.f : (p1 ? -acc : L.c[j] - acc);
    }, rank, size);
    __syncthreads();  // the block's rows of d are written
  } else {
    K2_MARK(0);
    K2_MARK(1);
  }
  K2_MARK(2);
  // the block's columns: matvec's rows, warp w of pass t taking row
  // (t size + rank) kWarps + w; column number e of the block is own(e)
  auto own = [&](int e) { return ((e / kWarps) * size + rank) * kWarps + e % kWarps; };
  int ne = 0, first = n, bj = kIntMax;
  float bs = -INFINITY;
  for (int e = tid, j; (j = own(e)) < n; e += kThreads) {
    const int v = L.vstat[j];
    const float dj = dcur[j];
    const bool can_up = v == AT_LOWER || v == FREE;
    const bool can_dn = v == AT_UPPER || v == FREE;
    const bool elig = (can_up && dj < -p.opt_tol) || (can_dn && dj > p.opt_tol);
    const float g = p1 ? 1.f : L.wts[j];
    const float score = elig ? dj * dj / max_nan(g, p.devex_floor) : -INFINITY;
    L.sc[j] = score;
    ne += elig;
    if (elig && j < first) first = j;
    if (better(score, j, bs, bj)) { bs = score; bj = j; }
  }
  const int nelig_b = block_sum_int(ne, sm);
  const int first_b = block_min_int(first, sm);
  const int nlist = min(bland ? 1 : K, nelig_b);
  float* lsc = L.lsc + (size_t)rank * K;
  int* lid = L.lid + (size_t)rank * K;
  if (own(kThreads) >= n) {
    // at most one column a thread, on threads 0..ncols-1 (own is
    // increasing): each eligible column's place in the list is the count of
    // the block's columns that beat it
    int ncols = 0;
    for (int t = 0; t < kThreads / kWarps; ++t)
      ncols += min(kWarps, max(0, n - (t * size + rank) * kWarps));
    float* ss = sm.slab.merge.s;
    int* sj = sm.slab.merge.j;
    ss[tid] = bs;
    sj[tid] = bj;
    __syncthreads();
    if (bs != -INFINITY) {  // an eligible column
      int place = 0;
      for (int u = 0; u < ncols; ++u) place += better(ss[u], sj[u], bs, bj);
      if (place < nlist) {
        lsc[place] = bs;
        lid[place] = bj;
      }
    }
    __syncthreads();
  } else {
    // repeated argmax over the block's columns, lowest index first on ties
    block_argmax_pair(bs, bj, sm);
    for (int k = 0; k < nlist; ++k) {
      if (k > 0) {
        bs = -INFINITY;
        bj = kIntMax;
        for (int e = tid, j; (j = own(e)) < n; e += kThreads)
          if (better(L.sc[j], j, bs, bj)) { bs = L.sc[j]; bj = j; }
        block_argmax_pair(bs, bj, sm);
      }
      if (tid == 0) {
        lsc[k] = bs;
        lid[k] = bj;
        L.sc[bj] = -INFINITY;
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    L.part[3 * rank] = nlist;
    L.part[3 * rank + 1] = nelig_b;
    L.part[3 * rank + 2] = first_b;
  }
  K2_MARK(3);
  grid_sync(ctl, size);
  K2_MARK(4);

  if (tid < 32) {  // the merge, on warp 0
    const int lane = tid;
    int nelig = 0, q_b = n;
    for (int r = lane; r < size; r += 32) {
      nelig += L.part[3 * r + 1];
      q_b = min(q_b, L.part[3 * r + 2]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      nelig += __shfl_xor_sync(kFull, nelig, o);
      q_b = min(q_b, __shfl_xor_sync(kFull, q_b, o));
    }
    const int ncand = bland ? min(1, nelig) : min(K, nelig);
    auto& mg = sm.slab.merge;
    auto load = [&](int r) {  // the head of block r's list at mg.pos[r]
      const bool has = mg.pos[r] < L.part[3 * r];
      const size_t e = (size_t)r * K + mg.pos[r];
      mg.hs[r] = has ? L.lsc[e] : -INFINITY;
      mg.hj[r] = has ? L.lid[e] : kIntMax;
    };
    // the lane's best head (v, vj), of block vr's list: a column index is
    // in one list, so (v, vj) names its lane
    float v = -INFINITY;
    int vj = kIntMax, vr = -1;
    auto best_head = [&]() {
      v = -INFINITY;
      vj = kIntMax;
      vr = -1;
      for (int r = lane; r < size; r += 32)
        if (better(mg.hs[r], mg.hj[r], v, vj)) { v = mg.hs[r]; vj = mg.hj[r]; vr = r; }
    };
    for (int r = lane; r < size; r += 32) {
      mg.pos[r] = 0;
      load(r);
    }
    best_head();
    float best0 = -INFINITY;
    for (int k = 0; k < ncand; ++k) {
      float wv = v;
      int wj = vj;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, wv, o);
        const int oj = __shfl_xor_sync(kFull, wj, o);
        if (better(ov, oj, wv, wj)) { wv = ov; wj = oj; }
      }
      if (k == 0) best0 = wv;
      if (lane == 0) sm.cand_ids[k] = bland ? q_b : wj;
      if (vr >= 0 && vj == wj) {  // the winner's list moves on
        ++mg.pos[vr];
        load(vr);
        best_head();
      }
    }
    if (lane == 0) {
      sm.merged_i[0] = nelig;
      sm.merged_i[1] = ncand;
      sm.merged_f = best0;
    }
  }
  __syncthreads();
  K2_MARK(5);

  // W[k, i] = (B^-1 a_k)[i]: a warp takes a row of B^-1 and a group of eight
  // candidates, lanes striding the row
  const int ncand = sm.merged_i[1];
  const int lane = tid & 31, groups = (ncand + 7) / 8;
  for (int it = rank * kWarps + (tid >> 5); it < m * groups; it += size * kWarps) {
    const int i = it / groups, k0 = it % groups * 8;
    const int kn = min(8, ncand - k0);
    const float* brow = L.Binv + (size_t)i * m;
    const float* arow[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      arow[kk] = L.AT + (size_t)sm.cand_ids[k0 + (kk < kn ? kk : 0)] * m;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = lane; j < m; j += 32) {
      const float bv = brow[j];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        if (kk < kn) acc[kk] = fmaf(arow[kk][j], bv, acc[kk]);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float a = acc[kk];
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
      if (lane == 0 && kk < kn) L.W[(size_t)(k0 + kk) * m + i] = a;
    }
  }
  K2_MARK(6);
  Priced out;
  out.nelig = sm.merged_i[0];
  out.ncand = ncand;
  out.best0 = sm.merged_f;
  grid_sync(ctl, size);
  return out;
}

// The fold of the eta ledger into B^-1, run by every block of the grid:
// B^-1 -= etasᵀ P, with P the rows of the old B^-1 at the ledger's leaving
// rows (gathered over the grid's threads before any block writes B^-1).
// Each entry is one thread's chain fmaf over the ledger in order from 0, as
// `gemm` sums it (its zero padding adds +0 to a sum that is never -0), four
// entries in flight a thread.
__device__ __forceinline__ void fold(const Lp& L, const Params& p, Smem& sm, Ctl* ctl,
                                  int n_eta) {
  const int m = p.m, rank = blockIdx.x, size = gridDim.x;
  const size_t mm = (size_t)m * m;
  const size_t gtid = (size_t)rank * kThreads + threadIdx.x, threads = (size_t)size * kThreads;
  for (size_t e = gtid; e < (size_t)n_eta * m; e += threads)
    L.P[e] = L.Binv[(size_t)L.eta_rs[e / m] * m + e % m];
  K2_MARK(0);
  grid_sync(ctl, size);
  K2_MARK(1);
  for (size_t e0 = gtid; e0 < mm; e0 += 4 * threads) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t e = e0 + u * threads;
      if (e >= mm) continue;
      const int i = (int)(e / m), j = (int)(e % m);
      for (int k = 0; k < n_eta; ++k)
        acc[u] = fmaf(L.etas[(size_t)k * m + i], L.P[(size_t)k * m + j], acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t e = e0 + u * threads;
      if (e < mm) L.Binv[e] = L.Binv[e] - acc[u];
    }
  }
  K2_MARK(2);
  grid_sync(ctl, size);
}

// Phase-1 long step: walk the convex piecewise-linear phase-1 objective along
// the ray -s w to where its slope turns non-negative, so one pivot repairs
// many violated rows.  Each row's two events (e1: reaching the violated
// bound, e2: reaching the far bound) are recomputed from (x_B, bounds, delta)
// in every pass.
struct LongStep {
  bool active, cross;  // slope0 < 0; the slope turns within a finite step
  float t, tgt;        // step and the leaving row's target bound
  int r;               // leaving row
};

struct Events {
  float t1, w1, g1, t2, w2, g2;  // time, |delta| weight and target of e1, e2
  bool ok1, ok2;
};

__device__ __forceinline__ Events row_events(const float* xB, const float* loB,
                                             const float* hiB, const Params& p, float s,
                                             const float* w, int i) {
  const float x = xB[i], lb = loB[i], ub = hiB[i];
  const float delta = -s * w[i];
  const bool up = delta > p.pivot_tol, dn = delta < -p.pivot_tol;
  const bool below = x < lb - p.feas_tol, above = x > ub + p.feas_tol;
  const float sdelta = (up || dn) ? delta : 1.f;
  Events e;
  e.ok1 = (up && below) || (dn && above);
  e.g1 = up ? lb : ub;
  e.w1 = fabsf(e.ok1 ? delta : 0.f);
  e.t1 = e.ok1 ? max_nan((e.g1 - x) / sdelta, 0.f) : INFINITY;
  e.ok2 = (up && !above && isfinite(ub)) || (dn && !below && isfinite(lb));
  e.g2 = up ? ub : lb;
  e.w2 = fabsf(e.ok2 ? delta : 0.f);
  e.t2 = e.ok2 ? max_nan((e.g2 - x) / sdelta, 0.f) : INFINITY;
  return e;
}

// Not inlined: it runs only at m >= long_step_min_m, and inlined into the
// minor loop it made ptxas spill there.
__device__ __noinline__ LongStep long_step(const float* xB, const float* loB,
                                           const float* hiB, const Params& p, float s,
                                           const float* w, Smem& sm) {
  const int m = p.m, tid = threadIdx.x;
  float sl = 0.f, mx1 = -INFINITY, mx2 = -INFINITY, mn1 = INFINITY, mn2 = INFINITY;
  for (int i = tid; i < m; i += kThreads) {
    const float x = xB[i];
    sl += sigma_of(x, loB[i], hiB[i], p.feas_tol) * (-s * w[i]);
    const Events e = row_events(xB, loB, hiB, p, s, w, i);
    mx1 = max_nan(mx1, e.ok1 ? e.t1 : -INFINITY);
    mx2 = max_nan(mx2, e.ok2 ? e.t2 : -INFINITY);
    mn1 = min_nan(mn1, e.t1);
    mn2 = min_nan(mn2, e.t2);
  }
  const float slope0 = block_sum(sl, sm);
  const float tmax = max_nan(block_max_nan(mx1, sm), block_max_nan(mx2, sm));
  const float t_min = min_nan(block_min_nan(mn1, sm), block_min_nan(mn2, sm));

  auto g_at = [&](float tt) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = tid; i < m; i += kThreads) {
      const Events e = row_events(xB, loB, hiB, p, s, w, i);
      s1 += e.t1 <= tt ? e.w1 : 0.f;
      s2 += e.t2 <= tt ? e.w2 : 0.f;
    }
    const float a = block_sum(s1, sm);
    const float b = block_sum(s2, sm);
    return slope0 + a + b;
  };
  LongStep ls;
  ls.active = slope0 < 0.f;
  ls.cross = ls.active && isfinite(tmax) && g_at(tmax) >= 0.f;

  // the leaving event inside (tl, th]: largest |delta| first
  auto emit = [&](float tl, float th) {
    float v1 = -INFINITY, v2 = -INFINITY;
    int r1 = kIntMax, r2 = kIntMax;
    for (int i = tid; i < m; i += kThreads) {
      const Events e = row_events(xB, loB, hiB, p, s, w, i);
      const float ad = fabsf(-s * w[i]);
      const float s1 = (e.t1 > tl && e.t1 <= th) ? ad : -INFINITY;
      const float s2 = (e.t2 > tl && e.t2 <= th) ? ad : -INFINITY;
      if (better(s1, i, v1, r1)) { v1 = s1; r1 = i; }
      if (better(s2, i, v2, r2)) { v2 = s2; r2 = i; }
    }
    block_argmax_pair(v1, r1, sm);
    block_argmax_pair(v2, r2, sm);
    const bool use2 = v2 > v1;
    ls.r = use2 ? r2 : r1;
    const Events e = row_events(xB, loB, hiB, p, s, w, ls.r);
    ls.t = use2 ? e.t2 : e.t1;
    ls.tgt = use2 ? e.g2 : e.g1;
  };
  // first-breakpoint probe: when the slope is already non-negative at the
  // earliest event, that event is the crossing and the bisection is skipped
  const bool need = ls.cross && g_at(t_min) < 0.f;
  emit(-1.f, t_min);
  if (need) {
    float tl = -1.f, th = isfinite(tmax) ? tmax : 0.f;
    for (int it = 0; it < 22; ++it) {
      const float mid = 0.5f * (tl + th);
      if (g_at(mid) >= 0.f) th = mid; else tl = mid;
    }
    emit(tl, th);
  }
  return ls;
}

__global__ void __launch_bounds__(kThreads, 1)
stream_kernel(const float* __restrict__ AT, const float* __restrict__ b,
              const float* __restrict__ c, const float* __restrict__ lo,
              const float* __restrict__ hi, const int* __restrict__ basis0,
              const int* __restrict__ vstat0, const float* __restrict__ Binv0,
              int* basis, int* vstat, float* Binv, int* mon, float* ws, Params p) {
  __shared__ Smem sm;
  const int m = p.m, n = p.n, K = p.minor_k, tid = threadIdx.x;
  const size_t mm = (size_t)m * m;
  const float ftol = p.feas_tol;

  Lp L;
  L.AT = AT;
  L.b = b;
  L.c = c;
  L.lo = lo;
  L.hi = hi;
  L.basis = basis;
  L.vstat = vstat;
  L.mon = mon;
  L.Binv = Binv;
  L.BT = ws;
  L.H = ws + mm;
  L.Xn = ws + 2 * mm;
  L.W = ws + 3 * mm;
  L.etas = L.W + (size_t)K * m;
  L.P = L.etas + (size_t)K * m;
  L.xB = L.P + (size_t)K * m;
  L.loB = L.xB + m;
  L.hiB = L.loB + m;
  L.cB = L.hiB + m;
  L.beff = L.cB + m;
  L.y = L.beff + m;
  L.ratio = L.y + m;
  L.tgt = L.ratio + m;
  L.d = L.tgt + m;
  L.d1 = L.d + n;
  L.wts = L.d1 + n;
  L.sc = L.wts + n;
  L.xn = L.sc + n;
  L.sep = L.xn + n;
  L.lsc = L.sep + (size_t)n * ((m + kTN - 1) / kTN);
  L.lid = reinterpret_cast<int*>(L.lsc + (size_t)kMaxGrid * K);
  L.eta_rs = L.lid + (size_t)kMaxGrid * K;
  L.part = L.eta_rs + K;
  Ctl* ctl = reinterpret_cast<Ctl*>(L.part + 3 * kMaxGrid);
  if (blockIdx.x != 0) {  // a worker: its share of each phase the leader posts
    worker_loop(ctl, sm.cmd, 250, [&](int cmd) {
      const unsigned op = (unsigned)cmd & ((1u << kCmdBits) - 1), arg = (unsigned)cmd >> kCmdBits;
      if (op == kPrice) price(L, p, sm, ctl, arg);
      else if (op == kFold) fold(L, p, sm, ctl, (int)arg);
      else if (op == kRefresh) refresh(L, p, sm, ctl);
      else recompute_vectors(L, p, sm, ctl);
    });
    return;
  }
  // block 0, the leader: the whole loop; it posts the grid phases
  unsigned epoch = 0;
#ifdef K2_CLOCKS
  long long clk[kParts] = {};
  long long clk_last = clock64();
#endif

  // ---- start: warm state handed in, or the slack basis with B^-1 = I -------
  if (p.warm) {
    for (size_t e = tid; e < mm; e += kThreads) L.Binv[e] = Binv0[e];
    for (int i = tid; i < m; i += kThreads) L.basis[i] = basis0[i];
    for (int j = tid; j < n; j += kThreads) L.vstat[j] = vstat0[j];
  } else {
    for (size_t e = tid; e < mm; e += kThreads) L.Binv[e] = (e / m == e % m) ? 1.f : 0.f;
    for (int i = tid; i < m; i += kThreads) L.basis[i] = p.slack0 + i;
    // canonical.initial_vstat: fixed => FIXED, finite lower => AT_LOWER,
    // else finite upper => AT_UPPER, else FREE; the slack block is BASIC
    for (int j = tid; j < n; j += kThreads) {
      const float l = L.lo[j], h = L.hi[j];
      int v = isfinite(l) ? AT_LOWER : (isfinite(h) ? AT_UPPER : FREE);
      if (l == h) v = FIXED;
      if (j >= p.slack0 && j < p.slack0 + m) v = BASIC;
      L.vstat[j] = v;
    }
  }
  __syncthreads();
  for (int i = tid; i < m; i += kThreads) {
    const int k = L.basis[i];
    L.loB[i] = L.lo[k];
    L.hiB[i] = L.hi[k];
    L.cB[i] = L.c[k];
  }
  for (int j = tid; j < n; j += kThreads) L.wts[j] = 1.f;
  post(ctl, epoch, kRecompute, gridDim.x);
  recompute_vectors(L, p, sm, ctl);
  K2_RZERO();  // the start is no part of a refresh

  // Loop scalars live in registers, identical in every thread.  fresh = 1
  // <=> (B^-1, x_B, d) were recomputed since the last pivot: terminal claims
  // are believed only then; a warm start distrusts the handed-in inverse.
  int status = RUNNING, niter = 0, phase = 1, noimp = 0, force = 0, sref = 0;
  int fresh = p.warm ? 0 : 1;
  int n_major = 0, n_refresh = 0;
  float best_inf = INFINITY, tell = 0.f;
#ifdef K2_CLOCKS
  clk_last = clock64();  // the start is no part of a major
#endif

  while (status == RUNNING && niter < p.max_iter) {
    ++n_major;
    // ---- refresh decision: maintained-x_B feasibility only TRIGGERS the
    // refresh; the phase flip is confirmed on the refreshed state
    int nv = 0;
    for (int i = tid; i < m; i += kThreads) {
      const float x = L.xB[i];
      nv += (x < L.loB[i] - ftol) || (x > L.hiB[i] + ftol);
    }
    const bool feasible_pre = block_sum_int(nv, sm) == 0;
    const bool do_refresh =
        (phase == 1 && feasible_pre) || force == 1 || sref >= p.refactor_period;
    if (do_refresh) {
      ++n_refresh;
      K2_TICK(C_OTHER);
      post(ctl, epoch, kRefresh, gridDim.x);
      tell = refresh(L, p, sm, ctl);
      sref = 0;
      fresh = 1;
      K2_RTAKE();
    }
    const bool diverged = do_refresh && tell > 0.5f;
    if (do_refresh) {
      // ---- phase confirm/regress on the refreshed (exact) state
      int nr = 0;
      for (int i = tid; i < m; i += kThreads)
        nr += viol_of(L.xB[i], L.loB[i], L.hiB[i]) > p.regress_tol;
      const bool ok_now = block_sum_int(nr, sm) == 0;
      if ((phase == 1 && ok_now) || (phase == 2 && !ok_now)) {
        phase = ok_now ? 2 : 1;
        noimp = 0;
        best_inf = INFINITY;
      }
    }
    const bool p1 = phase == 1;

    // ---- major pricing over the grid: the candidates and their W
    const bool bland = noimp >= p.bland_after;
    const unsigned flags =
        (p1 ? kP1 : 0u) | (p1 || !do_refresh ? kDense : 0u) | (bland ? kBland : 0u);
    K2_TICK(C_OTHER);
    post(ctl, epoch, kPrice | flags << kCmdBits, gridDim.x);
    const Priced pr = price(L, p, sm, ctl, flags);
    K2_SPANS(C_PRICE_Y, 7);
    const float* dcur = p1 ? L.d1 : L.d;
    const float best0 = pr.best0;  // max(score0), NaN-propagating
    const bool found_any = pr.nelig > 0;
    const int ncand = pr.ncand;
    for (int k = tid; k < K; k += kThreads) {
      const bool valid = k < ncand;
      const int q = valid ? sm.cand_ids[k] : 0;
      if (!valid) sm.cand_ids[k] = -1;
      sm.d_cand[k] = valid ? dcur[q] : 0.f;
      sm.wts_cand[k] = valid ? L.wts[q] : 1.f;
      sm.vstat_cand[k] = valid ? L.vstat[q] : FIXED;
    }
    __syncthreads();
    K2_TICK(C_TABLEAU_SYNC);

    // ---- minor pivots on the candidates
    int n_eta = 0;
    bool stop = false, wexit = false;
    for (int jm = 0; jm < K && !stop && status == RUNNING && niter < p.max_iter; ++jm) {
      if (p1) {
        // candidate reduced costs against the current sigma: -W[k] . sigma
        const int lane = tid & 31;
        for (int k = tid >> 5; k < ncand; k += kWarps) {
          const float* wk = L.W + (size_t)k * m;
          float acc = 0.f;
          for (int i = lane; i < m; i += 32)
            acc = fmaf(wk[i], sigma_of(L.xB[i], L.loB[i], L.hiB[i], ftol), acc);
          for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
          if (lane == 0) sm.d_cand[k] = -acc;
        }
        __syncthreads();
      }
      K2_TICK(C_MIN_COSTS);
      // ---- lane scan on warp 0, thread l taking lanes l, l + 32, ...: the
      // best score under `better`, the top score, the lowest eligible column
      // (first lane on ties) and whether any is eligible; `better` is a
      // strict total order and the rest are min, max and or, so the warp's
      // tree gives what a scan in lane order gives
      if (tid < 32) {
        int fnd = 0, kd = kIntMax, kb = kIntMax, keyb = kIntMax;
        float bsc = -INFINITY, smx = -INFINITY;
        for (int k = tid; k < K; k += 32) {
          const int vc = sm.vstat_cand[k], cid = sm.cand_ids[k];
          const float dc = vc == BASIC ? 0.f : sm.d_cand[k];
          const bool can_up = vc == AT_LOWER || vc == FREE;
          const bool can_dn = vc == AT_UPPER || vc == FREE;
          const bool elig =
              cid >= 0 && ((can_up && dc < -p.opt_tol) || (can_dn && dc > p.opt_tol));
          const float g = p1 ? 1.f : sm.wts_cand[k];
          const float score = elig ? dc * dc / max_nan(g, p.devex_floor) : -INFINITY;
          if (better(score, k, bsc, kd)) { bsc = score; kd = k; }
          smx = max_nan(smx, score);
          const int key = elig ? cid : n;
          if (key < keyb) { keyb = key; kb = k; }
          fnd |= elig;
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float os = __shfl_xor_sync(kFull, bsc, o);
          const int od = __shfl_xor_sync(kFull, kd, o);
          if (better(os, od, bsc, kd)) { bsc = os; kd = od; }
          smx = max_nan(smx, __shfl_xor_sync(kFull, smx, o));
          const int okey = __shfl_xor_sync(kFull, keyb, o), okb = __shfl_xor_sync(kFull, kb, o);
          if (okey < keyb || (okey == keyb && okb < kb)) { keyb = okey; kb = okb; }
          fnd |= __shfl_xor_sync(kFull, fnd, o);
        }
        if (tid == 0) {
          sm.lane_i[0] = fnd;
          sm.lane_i[1] = kd;
          sm.lane_i[2] = kb;
          sm.lane_f[0] = smx;
        }
      }
      __syncthreads();
      K2_TICK(C_MIN_SCAN);
      // suboptimization exit: the best remaining candidate decayed well below
      // the major's top score
      const bool decayed = sm.lane_f[0] < best0 * p.minor_decay;
      const bool found = sm.lane_i[0] && (!decayed || bland);
      const int ksel = bland ? sm.lane_i[2] : sm.lane_i[1];
      const int q = sm.cand_ids[ksel];
      const int vq = sm.vstat_cand[ksel];
      const float dq = vq == BASIC ? 0.f : sm.d_cand[ksel];
      const float gq = max_nan(sm.wts_cand[ksel], 1.f);
      const float s = dq < 0.f ? 1.f : -1.f;
      const float* w = L.W + (size_t)ksel * m;

      // ---- ratio test (the megakernel's), with the pre-step statistics
      float tmin = INFINITY, xbs = 0.f, wmx = 0.f;
      int nreg = 0;
      for (int i = tid; i < m; i += kThreads) {
        const float x = L.xB[i], lb = L.loB[i], ub = L.hiB[i], wi = w[i];
        const float delta = -s * wi;
        const bool up = delta > p.pivot_tol, dn = delta < -p.pivot_tol;
        const bool below = x < lb - ftol, above = x > ub + ftol;
        const float tgt = up ? (below ? lb : ub) : (dn ? (above ? ub : lb) : 0.f);
        const bool blockable = ((up && !above) || (dn && !below)) && isfinite(tgt);
        float ratio = blockable ? (tgt - x) / ((up || dn) ? delta : 1.f) : INFINITY;
        ratio = max_nan(ratio, 0.f);
        L.ratio[i] = ratio;
        L.tgt[i] = tgt;
        tmin = min_nan(tmin, ratio);
        nreg += viol_of(x, lb, ub) > p.regress_tol;
        xbs = max_nan(xbs, fabsf(x));
        wmx = max_nan(wmx, fabsf(wi));
      }
      float t_rows = block_min_nan(tmin, sm);  // barriers publish ratio, tgt
      const bool feas_m = block_sum_int(nreg, sm) == 0;
      const float xb_scale = block_max_nan(xbs, sm);
      const float wabs = block_max_nan(wmx, sm);
      K2_TICK(C_MIN_RATIO);
      const float tie_cut = t_rows * 1.0001f + 1e-6f;
      int r;
      if (bland) {  // lowest basic column index among the ties
        int key = n;
        for (int i = tid; i < m; i += kThreads)
          if (L.ratio[i] <= tie_cut) key = min(key, L.basis[i]);
        key = block_min_int(key, sm);
        int ri = kIntMax;
        for (int i = tid; i < m; i += kThreads)
          if ((L.ratio[i] <= tie_cut ? L.basis[i] : n) == key) ri = min(ri, i);
        r = block_min_int(ri, sm);
      } else {  // largest |w| among the ties
        float bw = -INFINITY;
        int bi = kIntMax;
        for (int i = tid; i < m; i += kThreads) {
          const float v = L.ratio[i] <= tie_cut ? fabsf(w[i]) : -INFINITY;
          if (better(v, i, bw, bi)) { bw = v; bi = i; }
        }
        r = block_argmax(bw, bi, sm);
      }

      // ---- long-step phase-1 override
      bool ls_on = false;
      float ls_t = 0.f, ls_tgt = 0.f;
      if (p.long_step && p1 && !bland && found) {
        const LongStep ls = long_step(L.xB, L.loB, L.hiB, p, s, w, sm);
        if (ls.active) t_rows = ls.cross ? ls.t : INFINITY;
        if (ls.active && ls.cross) {
          ls_on = true;
          r = ls.r;
          ls_t = ls.t;
          ls_tgt = ls.tgt;
        }
      }
      const float lo_q = q >= 0 ? L.lo[q] : 0.f, hi_q = q >= 0 ? L.hi[q] : 0.f;
      const float rng_q = hi_q - lo_q;
      const bool flip = rng_q <= t_rows;
      const bool unbounded = !isfinite(min_nan(t_rows, rng_q));
      const float t = flip ? rng_q : (ls_on ? ls_t : L.ratio[r]);
      const bool do_pivot = found && !flip && !unbounded;
      const bool do_flip = found && flip && !unbounded;
      const float move = t * wabs;
      K2_TICK(C_MIN_ROW);

      if (do_pivot) {
        const int lv = L.basis[r];
        const float loB_r = L.loB[r], hiB_r = L.hiB[r];
        const float tgt_r = ls_on ? ls_tgt : L.tgt[r];
        const int lstat = loB_r == hiB_r ? FIXED : (tgt_r == hiB_r ? AT_UPPER : AT_LOWER);
        const float enter_base =
            (vq == AT_LOWER || vq == FIXED) ? lo_q : (vq == AT_UPPER ? hi_q : 0.f);
        const float x_enter = enter_base + s * t;
        const float wr = w[r];
        const float wr_safe = wr == 0.f ? 1.f : wr;
        const float rd = dq / wr_safe;
        const float w_lv = max_nan(gq / (wr_safe * wr_safe), 1.f);
        const bool reset = gq > p.devex_reset;
        const float c_q = L.c[q];
        // snapshots before any state changes: column r of W and of the ledger
        for (int k = tid; k < ncand; k += kThreads) sm.alpha[k] = L.W[(size_t)k * m + r];
        for (int k = tid; k < n_eta; k += kThreads) sm.etacol[k] = L.etas[(size_t)k * m + r];
        __syncthreads();  // every thread holds the pre-step scalars and the snapshots
        // each thread its rows i: the eta vector's g_i = (w_i - [i = r]) / w_r,
        // x_B, and the eta transform of W and of the ledger, which records g
        // as its new eta with its leaving row
        for (int i = tid; i < m; i += kThreads) {
          const float wi = w[i];
          const float g = (wi - (i == r ? 1.f : 0.f)) / wr_safe;
          L.xB[i] = i == r ? x_enter : L.xB[i] + t * (-s * wi);
          for (int k = 0; k < ncand; ++k) {
            float* wk = L.W + (size_t)k * m + i;
            *wk = *wk - sm.alpha[k] * g;
          }
          for (int k = 0; k < n_eta; ++k) {
            float* ek = L.etas + (size_t)k * m + i;
            *ek = *ek - sm.etacol[k] * g;
          }
          L.etas[(size_t)n_eta * m + i] = g;
        }
        // exact candidate reduced costs and Devex weights on the lanes
        for (int k = tid; k < ncand; k += kThreads) {
          const int cid = sm.cand_ids[k];
          float dc2 = sm.d_cand[k] - rd * sm.alpha[k];
          if (cid == q) dc2 = 0.f;
          if (cid == lv) dc2 = -rd;
          sm.d_cand[k] = dc2;
          const float tc = sm.alpha[k] / wr_safe;
          float wc = max_nan(sm.wts_cand[k], (tc * tc) * gq);
          if (cid == lv) wc = w_lv;
          if (cid == q) wc = 1.f;
          if (reset) wc = 1.f;
          sm.wts_cand[k] = wc;
          sm.vstat_cand[k] = cid == lv ? lstat : (cid == q ? BASIC : sm.vstat_cand[k]);
        }
        // stale Devex: only the leaving and entering columns sync to the full
        // weight vector (a reset clears all of it)
        if (reset)
          for (int j = tid; j < n; j += kThreads) L.wts[j] = 1.f;
        // the pivot's scalar writes: no other thread touches these words
        // between the barriers (the pre-step reads came before the first)
        if (tid == 0) {
          if (!reset) {
            L.wts[lv] = w_lv;
            L.wts[q] = 1.f;
          }
          L.basis[r] = q;
          L.vstat[lv] = lstat;
          L.vstat[q] = BASIC;
          L.loB[r] = lo_q;
          L.hiB[r] = hi_q;
          L.cB[r] = c_q;
          L.eta_rs[n_eta] = r;
        }
        __syncthreads();
      } else if (do_flip) {
        __syncthreads();  // every thread holds the pre-step scalars
        for (int i = tid; i < m; i += kThreads) L.xB[i] = L.xB[i] + t * (-s * w[i]);
        for (int k = tid; k < ncand; k += kThreads)
          if (sm.cand_ids[k] == q)
            sm.vstat_cand[k] = sm.vstat_cand[k] == AT_LOWER ? AT_UPPER : AT_LOWER;
        __syncthreads();
        if (tid == 0) L.vstat[q] = L.vstat[q] == AT_LOWER ? AT_UPPER : AT_LOWER;
        __syncthreads();
      }

      // ---- minor status and progress accounting; an UNBOUNDED claim needs a
      // fresh state and (phase 2) primal feasibility to the drift floor
      const bool believe = fresh == 1 && (p1 || feas_m);
      if (found && unbounded) {
        if (believe) status = p1 ? NUMERICAL : UNBOUNDED;
        else wexit = true;
      }
      const bool applied = found && !unbounded;
      if (applied) {
        fresh = 0;
        ++niter;
        ++sref;
        // phase 1 counts every pivot (the major resets on measured progress);
        // phase 2 counts steps that are degenerate relative to the iterate
        const bool degenerate = move <= 1e-7f * (1.f + xb_scale);
        noimp = (p1 || degenerate) ? noimp + 1 : 0;
      }
      if (do_pivot) ++n_eta;
      if (!found || unbounded || sref >= p.refactor_period || bland) stop = true;
      K2_TICK(C_MIN_UPDATE);
    }

    // ---- fold the ledger into B^-1 over the grid
    if (n_eta > 0) {
      post(ctl, epoch, kFold | (unsigned)n_eta << kCmdBits, gridDim.x);
      fold(L, p, sm, ctl, n_eta);
      K2_SPANS(C_FOLD_GATHER, 3);
    }
    K2_TICK(C_FOLD_SYNC2);

    // ---- phase-1 progress accounting (the noimp reset authority)
    float part = 0.f;
    for (int i = tid; i < m; i += kThreads) part += viol_of(L.xB[i], L.loB[i], L.hiB[i]);
    const float inf_now = block_sum(part, sm);
    if (p1) {
      if (inf_now < best_inf - 1e-6f * (1.f + best_inf)) noimp = 0;
      best_inf = min_nan(best_inf, inf_now);
    }

    // ---- major terminal claims (only from a fresh state)
    const bool believe = fresh == 1;
    if (!found_any && believe && status == RUNNING) status = p1 ? INFEASIBLE : OPTIMAL;
    force = ((!found_any || wexit) && !believe && status == RUNNING) ? 1 : 0;
    if (diverged) status = NUMERICAL;
  }
  if (status == RUNNING) status = MAX_ITER;
  post(ctl, epoch, kExit, gridDim.x);

  // ---- exit telemetry for the chunk driver: phase, remaining primal
  // infeasibility and the claimed objective c.x; the major and refresh
  // counts for measurement
  float inf_part = 0.f, obj_b = 0.f, obj_n = 0.f;
  for (int i = tid; i < m; i += kThreads) {
    inf_part += viol_of(L.xB[i], L.loB[i], L.hiB[i]);
    obj_b += L.cB[i] * L.xB[i];
  }
  for (int j = tid; j < n; j += kThreads) {
    const int v = L.vstat[j];
    obj_n += L.c[j] * (v == BASIC ? 0.f : nonbasic_x(v, L.lo[j], L.hi[j]));
  }
  const float infeas = block_sum(inf_part, sm);
  const float obj = block_sum(obj_b, sm) + block_sum(obj_n, sm);
  if (tid == 0) {
    L.mon[0] = status;
    L.mon[1] = niter;
    L.mon[2] = phase;
    L.mon[3] = __float_as_int(infeas);
    L.mon[4] = __float_as_int(obj);
    L.mon[5] = n_major;
    L.mon[6] = n_refresh;
#ifdef K2_CLOCKS
    for (int c = 0; c < kParts; ++c) atomicAdd(&g_clocks[c], (unsigned long long)clk[c]);
    atomicAdd(&g_clocks[kParts], (unsigned long long)n_major);
#endif
  }
}

}  // namespace

extern "C" {

// Floats of global scratch: three m x m (the gathered Bᵀ and two Newton
// temporaries), three minor_k x m (W, the eta ledger, the fold's P), eight
// m-vectors and five n-vectors; the steepest-edge partial sums, one for
// each row of Aᵀ and 128-column tile of B^-1; the pricing's lists, a score
// and a column for each of minor_k pairs of each of up to kMaxGrid blocks,
// and three ints a block; the ledger's minor_k leaving rows; then the grid's
// control block (its command word, epoch and barrier, and one telltale for
// each of up to kMaxGrid blocks).
size_t streaming_simplex_workspace_floats(int m, int n, int minor_k) {
  return 3 * (size_t)m * m + 3 * (size_t)minor_k * m + 8 * (size_t)m + 5 * (size_t)n +
         (size_t)n * ((m + kTN - 1) / kTN) + (2 * (size_t)kMaxGrid + 1) * minor_k +
         3 * (size_t)kMaxGrid + sizeof(Ctl) / sizeof(float);
}

// What bounds K2's grid on the current device: its SM count and how many
// blocks of the kernel one SM holds.  Returns a cudaError_t,
// cudaErrorNotSupported when the device cannot launch a cooperative grid.
int streaming_simplex_grid_limits(int* sm_count, int* per_sm) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, stream_kernel, kThreads, 0);
  return static_cast<int>(err);
}

// Launch K2 on `stream` for one LP.  AT (n, m), b (m), c/lo/hi (n), all f32;
// basis0/vstat0/Binv0 all null (cold) or all set (warm: (m) i32, (n) i32,
// (m, m) f32).  Outputs basis (m) i32, vstat (n) i32, Binv (m, m) f32 and
// monitor (7) i32 = [status, niter, phase, f32 bits of the primal
// infeasibility, f32 bits of the objective, majors, refreshes]; ws holds
// streaming_simplex_workspace_floats(m, n, minor_k) floats.  The kernel runs
// as one cooperative grid of `blocks` blocks (1 to kMaxGrid, all resident at
// once: at most streaming_simplex_grid_limits' sm_count x per_sm); the
// results do not depend on `blocks`.  Returns the cudaError_t of the launch
// (never a smaller grid instead); does not synchronise.
int streaming_simplex_launch(const float* AT, const float* b, const float* c,
                             const float* lo, const float* hi, const int* basis0,
                             const int* vstat0, const float* Binv0, int* basis,
                             int* vstat, float* Binv, int* monitor, float* ws, int m,
                             int n, int slack0, int max_iter, int refactor_period,
                             int newton_sweeps, int bland_after, int minor_k,
                             float feas_tol, float opt_tol, float pivot_tol,
                             float devex_floor, float devex_reset, float regress_tol,
                             float minor_decay, int se_weights, int xb_refine,
                             int long_step, int blocks, void* stream) {
  if (minor_k < 1 || minor_k > kMaxK || blocks < 1 || blocks > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.m = m;
  p.n = n;
  p.slack0 = slack0;
  p.max_iter = max_iter;
  p.refactor_period = refactor_period;
  p.newton_sweeps = newton_sweeps;
  p.bland_after = bland_after;
  p.minor_k = minor_k;
  p.se_weights = se_weights;
  p.xb_refine = xb_refine;
  p.long_step = long_step;
  p.warm = basis0 != nullptr;
  p.feas_tol = feas_tol;
  p.opt_tol = opt_tol;
  p.pivot_tol = pivot_tol;
  p.devex_floor = devex_floor;
  p.devex_reset = devex_reset;
  p.regress_tol = regress_tol;
  p.minor_decay = minor_decay;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t ctl_at = streaming_simplex_workspace_floats(m, n, minor_k) -
                        sizeof(Ctl) / sizeof(float);
  cudaError_t err = zero_ctl(reinterpret_cast<Ctl*>(ws + ctl_at), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&AT,   &b,     &c,    &lo,      &hi, &basis0, &vstat0,
                  &Binv0, &basis, &vstat, &Binv, &monitor, &ws, &p};
  err = cudaLaunchCooperativeKernel((void*)stream_kernel,
                                    dim3(blocks), dim3(kThreads), args, 0, st);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

const char* streaming_simplex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef K2_CLOCKS
// Copy the leader's cycle sums (kParts + 1 values: C_REF_GATHER .. C_OTHER, then
// the majors they cover) into `host` and zero them.  Synchronises.
int streaming_simplex_clocks(unsigned long long* host) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks));
  const unsigned long long zero[kParts + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
