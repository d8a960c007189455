// K1, the batched simplex megakernel, in CUDA C++ for Hopper (sm_90a).
//
// Replaces minilp_tpu/ops/kernels/batched_simplex.py::_simplex_kernel, the
// Pallas TPU kernel launched by simplex_kernel_call.  It computes the same
// thing: for each LP of the batch, the whole bounded two-phase primal simplex
// inside one launch — Dantzig pricing in phase 1, Devex in phase 2, Bland
// after `bland_after` stalls, FTRAN against a dense f32 B^-1, the ratio test
// with bound flips, a rank-1 product-form update of B^-1, and a Newton
// refresh (two sweeps X <- X + X(I - B X)) every `refactor_period` pivots,
// from a cold slack basis or a warm (basis, vstat, B^-1).  It writes (basis,
// vstat, status, niter) packed into one int32 row per LP; the host
// re-derives the vertex in f64.
//
// Semantics kept from the TPU kernel: f32 arithmetic (no TF32, no fast math),
// lowest-index tie-breaks in every argmax/argmin, the ratio tie window
// ratio <= t*1.0001 + 1e-6, terminal claims believed only from a freshly
// refreshed state (fresh/force), the Devex update with its reset at 1e6, and
// selects instead of products wherever a +-inf bound meets a product.
// What went: the TPU's one-hot selects and one-hot-matmul gathers.  On the
// GPU an index is an index, so c_B/lo_B/hi_B and the basis matrix are read
// by index, and the kernel skips the work a branch-free TPU body computed and
// threw away (phase-1 reduced costs in phase 2, the pivot row in phase 1, any
// pivot work when no column is eligible).
//
// What bounds it on an H100.  A (m x n) and B^-1 (m x m) sit in global
// memory (4.1 MB and 1.0 MB at the largest single-LP shape, 504 x 2048) and
// stay L2-resident.  Each pivot streams A once or twice (phase-1 reduced
// costs, or the phase-2 pivot row) and B^-1 two or three times; the Newton
// refresh is four m x m x m products (1 GFLOP at m = 504) every
// `refactor_period` pivots.  On one SM that is 25-29 GB/s of L2 per pivot
// and 73 GFLOP/s per refresh, so a launch of one LP on one block leaves the
// other 131 SMs idle.
//
// Two launch shapes.  A batch (grid = batch) runs one LP per block, as the
// TPU kernel ran one LP per program.  A launch of ONE LP runs as a
// cooperative grid of G blocks in thread-block clusters of C (16 where the
// card allows that size, else 8), with the machinery of simplex_grid.cuh:
// block 0, the leader, runs the loop and keeps everything that is O(m) or
// O(n) with a block-uniform result (the refresh decision, sigma and the
// infeasibility, pricing, the ratio test, the bound flip, the bookkeeping,
// the status), and posts the m^2- and m^3-class phases.  A pivot's phases
// (the phase-1 duals, FTRAN, and the rank-1 update of B^-1 with the phase-2
// pivot row) go to the leader's cluster, blocks 0..C-1, which meet at the
// cluster's hardware barrier: the leader puts the command and the pivot's
// scalars in its shared memory and arrives, the workers read them over
// distributed shared memory, and each phase ends on that barrier.  The
// Newton refresh and the recompute, once a refresh period, go to the whole
// grid, the blocks outside the cluster sleeping on the command word in
// global memory between them.  Each phase hands out 64 x 64 GEMM tiles,
// rows (one warp each), column sums (one thread each) or elements by rank,
// and every output keeps the one fixed-order sum it has on one block,
// so the results depend on neither G nor C, and a batch runs the same code
// with (rank, size) = (0, 1).  At the main path's shapes a pivot's phases
// are latency, not work: a column sum is one thread's in-order chain, so a
// sum over n columns has n / 32 warps to spread (64 at n = 2048, four a
// block of a cluster of 16), FTRAN's m rows are m warps, and the rank-1
// update is m^2 elements from L2, all of which C blocks hold; the grid's
// barrier and command word cost more than the rest of the blocks give.
// The refresh wants the grid: its 64 x 64 tiles number 36 at m = 384 and
// 64 at m = 504, more than one cluster holds at once.

#include "simplex_common.cuh"
#include "simplex_grid.cuh"

namespace {

#ifdef K1_CLOCKS
// Built with -DK1_CLOCKS, the leader sums clock64() cycles per part of a loop
// iteration (`batched_simplex_clocks`), apart for phase 1 and phase 2: its
// serial steps (the feasibility count and refresh decision, sigma and the
// infeasibility, pricing, the ratio test, the bookkeeping: the a_q gather,
// the flip or the pivot's scalars and row of B^-1, the basis, the status),
// the refresh whole, and each posted phase as its post, its work and the
// barriers it waits in.  The normal build carries no clocks.
enum Part {
  C_FEAS, C_REFRESH, C_SIGMA, C_DUALS_POST, C_DUALS_WORK, C_DUALS_SYNC, C_PRICE,
  C_FTRAN_POST, C_FTRAN_WORK, C_FTRAN_SYNC, C_RATIO, C_SWEEPS_POST, C_SWEEPS_WORK,
  C_SWEEPS_SYNC, C_BOOK, kParts
};
// phase 1's parts and iterations, phase 2's, then the start and the exit
constexpr int kClockWords = 2 * (kParts + 1) + 1;
__device__ unsigned long long g_clocks[kClockWords];
// thread 0 of the leader: the part that ends here, in the iteration's phase
#define K1_TICK(part)                         \
  if (tid == 0) {                             \
    const long long now_ = clock64();         \
    sm.clk[ph][part] += now_ - clk_last;      \
    clk_last = now_;                          \
  }
// a posted phase ends here: its time less the barriers it waited in, then
// those barriers (summed by Grid::sync into sm.clk_sync)
#define K1_PHASE(work, sync)                                   \
  if (tid == 0) {                                              \
    const long long now_ = clock64();                          \
    sm.clk[ph][work] += now_ - clk_last - sm.clk_sync;         \
    sm.clk[ph][sync] += sm.clk_sync;                           \
    sm.clk_sync = 0;                                           \
    clk_last = now_;                                           \
  }
#else
#define K1_TICK(part)
#define K1_PHASE(work, sync)
#endif

// Newton-refresh GEMM tiling: 64 x 64 output tile, 16-deep k slabs; each of
// the 512 threads owns a 2 x 4 patch of the tile.
constexpr int kTile = 64;
constexpr int kTileK = 16;

// the leader's commands to the grid of a one-LP launch
constexpr unsigned kRecompute = 1, kRefresh = 2, kDuals = 3, kFtran = 4, kPivot = 5;

struct Params {
  int m, n, slack0, max_iter, refactor_period, bland_after, warm;
  int wide;     // one LP over the launch's grid (else one LP per block)
  int cluster;  // blocks of a thread-block cluster of the launch (1: none)
  float feas_tol, opt_tol, pivot_tol;
};

// What a pivot's sweeps need besides the state: the leader's block-uniform
// scalars, which the cluster's workers read from the leader's shared memory.
struct Pivot {
  int q, r, lv, lstat, p1;
  float wr, t, s, x_enter, rd, gq;
};

struct Smem {
  float red_f[kWarps];
  int red_i[kWarps];
  float As[kTileK][kTile + 1];  // P tile, k-major; +1 breaks store conflicts
  alignas(16) float Bs[kTileK][kTile];
  int cmd;   // a worker's current command; the leader's, to its cluster
  Pivot piv; // the leader's pivot scalars, to its cluster
#ifdef K1_CLOCKS
  long long clk[2][kParts];  // the leader's cycles per part, by phase
  long long clk_sync;        // the barriers of the phase it runs
#endif
};

// This block's share of a phase of its LP: (rank, size) = (blockIdx.x, G)
// over the grid of a one-LP launch, (rank in the cluster, C) over the
// leader's cluster of C blocks (`cluster`: its steps meet at the cluster's
// barrier), (0, 1) for a block of a batch.
struct Grid {
  Ctl* ctl;
  int rank, size;
  bool cluster = false;
  long long* clk = nullptr;  // K1_CLOCKS: the leader's sum of its barrier waits
  __device__ size_t gtid() const { return (size_t)rank * kThreads + threadIdx.x; }
  __device__ size_t threads() const { return (size_t)size * kThreads; }
  __device__ void sync() const {
#ifdef K1_CLOCKS
    const long long t0 = clock64();
#endif
    if (cluster) cluster_sync();
    else grid_sync(ctl, size);
#ifdef K1_CLOCKS
    if (clk && threadIdx.x == 0) *clk += clock64() - t0;
#endif
  }
};

// C = base + sgn * P Q for m x m row-major matrices (base == nullptr: the
// identity).  The 64 x 64 output tiles go to the blocks of the grid in turn;
// k runs in order for every output, so the result is deterministic and does
// not depend on the share.  C must not alias P or Q.
__device__ void gemm(const float* P, const float* Q, float* C, const float* base,
                     float sgn, int m, Smem& sm, const Grid& g) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // 16 x 32 threads
  const int tiles = (m + kTile - 1) / kTile;
  for (int t = g.rank; t < tiles * tiles; t += g.size) {
    const int i0 = (t / tiles) * kTile, j0 = (t % tiles) * kTile;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < m; k0 += kTileK) {
      for (int e = threadIdx.x; e < kTile * kTileK; e += kThreads) {
        const int r = e / kTileK, k = e % kTileK, gi = i0 + r, gk = k0 + k;
        sm.As[k][r] = (gi < m && gk < m) ? P[(size_t)gi * m + gk] : 0.f;
      }
      for (int e = threadIdx.x; e < kTileK * kTile; e += kThreads) {
        const int k = e / kTile, cc = e % kTile, gk = k0 + k, gj = j0 + cc;
        sm.Bs[k][cc] = (gk < m && gj < m) ? Q[(size_t)gk * m + gj] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTileK; ++k) {
        const float a0 = sm.As[k][ty * 2], a1 = sm.As[k][ty * 2 + 1];
        const float4 bv = *reinterpret_cast<const float4*>(&sm.Bs[k][tx * 4]);
        acc[0][0] = fmaf(a0, bv.x, acc[0][0]);
        acc[0][1] = fmaf(a0, bv.y, acc[0][1]);
        acc[0][2] = fmaf(a0, bv.z, acc[0][2]);
        acc[0][3] = fmaf(a0, bv.w, acc[0][3]);
        acc[1][0] = fmaf(a1, bv.x, acc[1][0]);
        acc[1][1] = fmaf(a1, bv.y, acc[1][1]);
        acc[1][2] = fmaf(a1, bv.z, acc[1][2]);
        acc[1][3] = fmaf(a1, bv.w, acc[1][3]);
      }
      __syncthreads();
    }
    for (int a = 0; a < 2; ++a) {
      const int gi = i0 + ty * 2 + a;
      if (gi >= m) continue;
      for (int bb = 0; bb < 4; ++bb) {
        const int gj = j0 + tx * 4 + bb;
        if (gj >= m) continue;
        const size_t e = (size_t)gi * m + gj;
        const float bv = base ? base[e] : (gi == gj ? 1.f : 0.f);
        C[e] = bv + sgn * acc[a][bb];
      }
    }
  }
}

// f(j, sum_i y[i] M[i, j]) for each column j < cols: one thread per column,
// i in order (the chain of simplex_common.cuh's `colsums`, so the same bits),
// but laid out for a sum over few columns on a wide grid.  The columns go out
// in 32-column chunks, one warp each, to the blocks in turn (chunk c to block
// c % size, warp c / size), so 2048 columns reach 64 SMs rather than 4; and
// each thread keeps kAhead rows of loads in flight ahead of its fma chain, as
// one thread's column is too little work to hide L2 latency otherwise.
constexpr int kAhead = 32;
// columns of a row of B^-1 a lane of the rank-1 update keeps in flight
constexpr int kRow = 16;
template <typename F>
__device__ void colsums_spread(const float* y, const float* M, int rows, int cols, F f,
                               const Grid& g) {
  const int chunks = (cols + 31) / 32;
  for (int c = (threadIdx.x >> 5) * g.size + g.rank; c < chunks; c += g.size * kWarps) {
    const int j = c * 32 + (threadIdx.x & 31);
    if (j >= cols) continue;
    const float* col = M + j;
    float acc = 0.f;
    int i = 0;
    for (; i + kAhead <= rows; i += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) v[u] = col[(size_t)(i + u) * cols];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) acc = fmaf(y[i + u], v[u], acc);
    }
    for (; i < rows; ++i) acc = fmaf(y[i], col[(size_t)i * cols], acc);
    f(j, acc);
  }
}

// One LP's global-memory state (the TPU kernel's VMEM scratch).
struct Lp {
  const float *A, *b, *c, *lo, *hi;  // inputs, never written
  int* basis;
  int* vstat;
  int* res;  // [status, niter]
  float *Binv, *Bm, *T, *X2;               // m x m
  float *xB, *loB, *hiB, *cB, *w, *pr, *vm, *ym;  // m
  float *d, *wts, *dc;                     // n
};

// ---- the posted phases -----------------------------------------------------
// Each is run by every block of its Grid (the whole grid, or the leader's
// cluster) and ends on that Grid's barrier.
// Not inlined: called, they are register-allocated on their own and leave the
// leader's loop as it was (inlined grid phases made K2's loop spill).

// Exact (f32) xB and reduced costs from B^-1 and the statuses.
__device__ __noinline__ void recompute(const Lp& L, int m, int n, const Grid& g) {
  for (size_t j = g.gtid(); j < (size_t)n; j += g.threads())
    L.dc[j] = nonbasic_x(L.vstat[j], L.lo[j], L.hi[j]);
  g.sync();
  matvec(L.A, L.dc, m, n, [&](int i, float acc) { L.vm[i] = L.b[i] - acc; }, g.rank, g.size);
  g.sync();
  matvec(L.Binv, L.vm, m, m, [&](int i, float acc) { L.xB[i] = acc; }, g.rank, g.size);
  colsums_spread(L.cB, L.Binv, m, m, [&](int j, float acc) { L.ym[j] = acc; }, g);
  g.sync();
  colsums_spread(L.ym, L.A, m, n, [&](int j, float acc) {
    L.d[j] = L.vstat[j] == BASIC ? 0.f : L.c[j] - acc;
  }, g);
  g.sync();
}

// Two Newton sweeps on B^-1 against the basis matrix gathered by index, then
// the recompute.
__device__ __noinline__ void refresh(const Lp& L, int m, int n, Smem& sm, const Grid& g) {
  const size_t mm = (size_t)m * m;
  for (size_t e = g.gtid(); e < mm; e += g.threads())
    L.Bm[e] = L.A[(e / m) * n + L.basis[e % m]];
  g.sync();
  gemm(L.Bm, L.Binv, L.T, nullptr, -1.f, m, sm, g);  // T  = I - B X
  g.sync();
  gemm(L.Binv, L.T, L.X2, L.Binv, 1.f, m, sm, g);    // X2 = X + X T
  g.sync();
  gemm(L.Bm, L.X2, L.T, nullptr, -1.f, m, sm, g);    // T  = I - B X2
  g.sync();
  gemm(L.X2, L.T, L.Binv, L.X2, 1.f, m, sm, g);      // X  = X2 + X2 T
  g.sync();
  recompute(L, m, n, g);
}

// Phase-1 reduced costs d1 = -(sigma B^-1) A into dc, zero on basic columns,
// with sigma in vm.
__device__ __noinline__ void phase1_duals(const Lp& L, int m, int n, const Grid& g) {
  colsums_spread(L.vm, L.Binv, m, m, [&](int k, float acc) { L.ym[k] = acc; }, g);
  g.sync();
  colsums_spread(L.ym, L.A, m, n, [&](int j, float acc) {
    L.dc[j] = L.vstat[j] == BASIC ? 0.f : -acc;
  }, g);
  g.sync();
}

// FTRAN: w = B^-1 a_q, with a_q in vm.
__device__ __noinline__ void ftran(const Lp& L, int m, const Grid& g) {
  matvec(L.Binv, L.vm, m, m, [&](int i, float acc) { L.w[i] = acc; }, g.rank, g.size);
  g.sync();
}

// A pivot's sweeps, with pr = (row r of B^-1) / w_r already in place: the
// PFI rank-1 update of B^-1 (rows i -= (w_i - [i == r]) pr, so row r becomes
// pr; pr must be complete before any block starts, as row r is overwritten),
// x_B's step, and in phase 2 the incremental reduced costs and Devex weights
// from the pivot row alpha = w_r (pr A) = (old B^-1)_r A.  The statuses are
// read here and written only after the closing barrier.
__device__ __noinline__ void pivot_sweeps(const Lp& L, const Pivot& v, int m, int n,
                                          const Grid& g) {
  const int q = v.q, r = v.r, lv = v.lv, lstat = v.lstat;
  const float wr = v.wr, t = v.t, s = v.s, x_enter = v.x_enter, rd = v.rd, gq = v.gq;
  // On one block (a batch's LP) a flat loop, a few elements a thread at a
  // batch's m = 32, where rows would leave most lanes idle.  Spread over
  // blocks: a warp a row, its lanes along the row, kRow columns a lane in
  // flight.  A store to the row may alias pr as far as the compiler knows,
  // so the flat loop waits out a load before each store: on a cluster's few
  // blocks that is a round trip to L2 for every 32 columns.  In phase 2 the
  // pivot row's column sums take warps 0..busy-1 of each block
  // (colsums_spread's chunks) and the update the others, so that the two
  // run side by side.
  const size_t mm = g.size == 1 ? (size_t)m * m : 0;
  for (size_t e = threadIdx.x; e < mm; e += kThreads) {
    const int i = (int)(e / m);
    L.Binv[e] = L.Binv[e] - (L.w[i] - (i == r ? 1.f : 0.f)) * L.pr[e % m];
  }
  const int lane = threadIdx.x & 31;
  const int busy = v.p1 ? 0 : min((n + 32 * g.size - 1) / (32 * g.size), kWarps / 2);
  const int uw = kWarps - busy, warp = g.size == 1 ? -1 : (int)(threadIdx.x >> 5) - busy;
  for (int j0 = 0; j0 < m && warp >= 0; j0 += 32 * kRow) {
    float pv[kRow];
#pragma unroll
    for (int u = 0; u < kRow; ++u) {
      const int j = j0 + 32 * u + lane;
      pv[u] = j < m ? L.pr[j] : 0.f;
    }
    for (int i = g.rank * uw + warp; i < m; i += g.size * uw) {
      const float f = L.w[i] - (i == r ? 1.f : 0.f);
      float* row = L.Binv + (size_t)i * m;
      float x[kRow];
#pragma unroll
      for (int u = 0; u < kRow; ++u) {
        const int j = j0 + 32 * u + lane;
        x[u] = j < m ? row[j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRow; ++u) {
        const int j = j0 + 32 * u + lane;
        if (j < m) row[j] = x[u] - f * pv[u];
      }
    }
  }
  for (size_t i = g.gtid(); i < (size_t)m; i += g.threads())
    L.xB[i] = (int)i == r ? x_enter : L.xB[i] + t * (-s * L.w[i]);
  if (!v.p1) {
    const bool reset = gq > 1e6f;
    colsums_spread(L.pr, L.A, m, n, [&](int j, float acc) {
      const float alpha = acc * wr;
      const int vnew = j == q ? BASIC : (j == lv ? lstat : L.vstat[j]);
      float dn = L.d[j] - rd * alpha;
      if (j == q) dn = 0.f;
      if (j == lv) dn = -rd;
      if (vnew == BASIC) dn = 0.f;
      const float tcol = alpha / wr;
      float wc = fmaxf(L.wts[j], tcol * tcol * gq);
      if (j == lv) wc = fmaxf(gq / (wr * wr), 1.f);
      if (j == q) wc = 1.f;
      if (reset) wc = 1.f;
      L.d[j] = dn;
      L.wts[j] = wc;
    }, g);
  }
  g.sync();
}

__global__ void __launch_bounds__(kThreads, 1)
simplex_kernel(const float* __restrict__ A_all, const float* __restrict__ b_all,
               const float* __restrict__ c_all, const float* __restrict__ lo_all,
               const float* __restrict__ hi_all, const int* __restrict__ basis0_all,
               const int* __restrict__ vstat0_all, const float* __restrict__ Binv0_all,
               int* out_all, float* ws_all, size_t ws_stride, Ctl* ctl, Params p) {
  __shared__ Smem sm;
  const int m = p.m, n = p.n, tid = threadIdx.x;
  // the grid's share (the refresh and the recompute), and the leader's
  // cluster's (the per-pivot phases: C = 1 without a cluster)
  const int C = p.cluster;
  const Grid g{ctl, p.wide ? (int)blockIdx.x : 0, p.wide ? (int)gridDim.x : 1};
  const Grid gc{ctl, g.rank % C, C, C > 1};
  const size_t lp = p.wide ? 0 : blockIdx.x, mm = (size_t)m * m;
  const float ftol = p.feas_tol;

  Lp L;
  L.A = A_all + lp * m * n;
  L.b = b_all + lp * m;
  L.c = c_all + lp * n;
  L.lo = lo_all + lp * n;
  L.hi = hi_all + lp * n;
  L.basis = out_all + lp * (m + n + 2);
  L.vstat = L.basis + m;
  L.res = L.vstat + n;
  float* ws = ws_all + lp * ws_stride;
  L.Binv = ws;
  L.Bm = ws + mm;
  L.T = ws + 2 * mm;
  L.X2 = ws + 3 * mm;
  L.xB = ws + 4 * mm;
  L.loB = L.xB + m;
  L.hiB = L.loB + m;
  L.cB = L.hiB + m;
  L.w = L.cB + m;
  L.pr = L.w + m;
  L.vm = L.pr + m;
  L.ym = L.vm + m;
  L.d = L.ym + m;
  L.wts = L.d + n;
  L.dc = L.wts + n;

  if (g.rank >= C) {  // a worker outside the leader's cluster: the grid phases
    // a post every refresh period (about 1 ms at the main path's shapes)
    worker_loop(ctl, sm.cmd, 1000, [&](int cmd) {
      if (cmd == (int)kRecompute) recompute(L, m, n, g);
      else refresh(L, m, n, sm, g);
    });
    return;
  }
  if (g.rank != 0) {  // a worker of the leader's cluster: every phase
    const int* cmd_at = cluster_map(&sm.cmd, 0);
    const Pivot* piv_at = cluster_map(&sm.piv, 0);
    for (;;) {
      cluster_sync();  // the leader's post
      // thread 0 reads the leader's shared memory once for the block (every
      // thread's own reads would queue at the leader's SM), the scalars with
      // the command, as the leader writes them only before a kPivot post
      if (tid == 0) {
        sm.cmd = *cmd_at;
        sm.piv = *piv_at;
      }
      __syncthreads();
      const int cmd = sm.cmd;
      if (cmd == (int)kExit) break;
      if (cmd == (int)kRecompute) recompute(L, m, n, g);
      else if (cmd == (int)kRefresh) refresh(L, m, n, sm, g);
      else if (cmd == (int)kDuals) phase1_duals(L, m, n, gc);
      else if (cmd == (int)kFtran) ftran(L, m, gc);
      else pivot_sweeps(L, sm.piv, m, n, gc);
    }
    cluster_sync();  // the leader's shared memory outlives every read of it
    return;
  }
  // the LP's leader (block 0 of the grid, or the batch's block of this LP).
  // A post hands a phase over: the command (and a pivot's scalars) in its
  // shared memory for its cluster, whose barrier publishes them with the
  // leader's writes; a grid phase also goes to the blocks outside the
  // cluster through the global epoch, which counts only those posts.
  unsigned epoch = 0;
  const int outside = g.size > C ? g.size : 1;  // 1: no block outside the cluster
  auto post_cluster = [&](unsigned cmd) {
    if (C == 1) {
      __syncthreads();
      return;
    }
    if (tid == 0) sm.cmd = (int)cmd;
    cluster_sync();
  };
  auto post_grid = [&](unsigned cmd) {
    post(ctl, epoch, cmd, outside);
    post_cluster(cmd);
  };
#ifdef K1_CLOCKS
  const Grid gp{ctl, gc.rank, gc.size, gc.cluster, &sm.clk_sync};  // clocked
  int ph = 0;
  long long clk_last = clock64(), clk_start = 0;
  if (tid == 0) {
    for (int k = 0; k < 2 * kParts; ++k) sm.clk[k / kParts][k % kParts] = 0;
    sm.clk_sync = 0;
  }
#else
  const Grid& gp = gc;
#endif

  // ---- start: warm state handed in, or the slack basis with B^-1 = I -------
  if (p.warm) {
    const float* Binv0 = Binv0_all + lp * mm;
    for (size_t e = tid; e < mm; e += kThreads) L.Binv[e] = Binv0[e];
    for (int i = tid; i < m; i += kThreads) L.basis[i] = basis0_all[lp * m + i];
    for (int j = tid; j < n; j += kThreads) L.vstat[j] = vstat0_all[lp * n + j];
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
  for (int j = tid; j < n; j += kThreads) L.wts[j] = 1.f;  // Devex weights
  post_grid(kRecompute);
  recompute(L, m, n, g);

  // Scalars of the loop carry live in registers, identical in every thread
  // (each is computed from block-reduced or barrier-published values).
  // fresh = 1 <=> (B^-1, xB, d) were recomputed since the last pivot:
  // terminal claims are believed only then.  A warm start distrusts the
  // handed-in inverse.
  int status = RUNNING, niter = 0, phase = 1, noimp = 0, force = 0;
  int fresh = p.warm ? 0 : 1;
  float best = INFINITY;
#ifdef K1_CLOCKS
  if (tid == 0) {
    const long long now_ = clock64();
    clk_start += now_ - clk_last;
    clk_last = now_;
  }
  unsigned long long iters[2] = {0, 0};
#endif

  while (status == RUNNING && niter < p.max_iter) {
    // ---- refresh decision (transition, periodic, or exit-check) ------------
    int nviol = 0;
    for (int i = tid; i < m; i += kThreads) {
      const float x = L.xB[i];
      nviol += (x < L.loB[i] - ftol) || (x > L.hiB[i] + ftol);
    }
    const bool feasible = block_sum_int(nviol, sm) == 0;
    const bool transition = phase == 1 && feasible;
    if (transition) phase = 2;
#ifdef K1_CLOCKS
    ph = phase - 1;
#endif
    K1_TICK(C_FEAS);
    const bool do_refresh = transition || force == 1 ||
                            (niter > 0 && niter % p.refactor_period == 0);
    if (do_refresh) {
      post_grid(kRefresh);
      refresh(L, m, n, sm, g);
      K1_TICK(C_REFRESH);
    }

    // ---- phase-1 costs sigma (into vm) and total infeasibility -------------
    float part = 0.f;
    for (int i = tid; i < m; i += kThreads) {
      const float x = L.xB[i], lb = L.loB[i], ub = L.hiB[i];
      L.vm[i] = x < lb - ftol ? -1.f : (x > ub + ftol ? 1.f : 0.f);
      part += fmaxf(lb - x, 0.f) + fmaxf(x - ub, 0.f);
    }
    const float infeas = block_sum(part, sm);  // its barriers publish vm
    const bool p1 = phase == 1;
    K1_TICK(C_SIGMA);
    if (p1) {  // d1 = -(sigma B^-1) A, zero on basic columns
      post_cluster(kDuals);
      K1_TICK(C_DUALS_POST);
      phase1_duals(L, m, n, gp);
      K1_PHASE(C_DUALS_WORK, C_DUALS_SYNC);
    }
    const float* dcur = p1 ? L.dc : L.d;

    // ---- pricing: Dantzig (phase 1) / Devex (phase 2); Bland by stall ------
    const bool bland = noimp >= p.bland_after;
    float bs = -INFINITY;
    int bj = kIntMax, first = n;
    for (int j = tid; j < n; j += kThreads) {
      const int v = L.vstat[j];
      const float dj = dcur[j];
      const bool can_up = v == AT_LOWER || v == FREE;
      const bool can_dn = v == AT_UPPER || v == FREE;
      const bool elig = (can_up && dj < -p.opt_tol) || (can_dn && dj > p.opt_tol);
      const float gw = p1 ? 1.f : L.wts[j];
      const float score = elig ? dj * dj / fmaxf(gw, 1e-3f) : -INFINITY;
      if (better(score, j, bs, bj)) { bs = score; bj = j; }
      if (elig && j < first) first = j;
    }
    const int q_d = block_argmax(bs, bj, sm);
    const int q_b = block_min_int(first, sm);
    const bool found = q_b < n;
    const int q = bland ? q_b : q_d;
    K1_TICK(C_PRICE);

    bool unbounded = false;
    if (found) {
      const float dq = dcur[q];
      const float s = dq < 0.f ? 1.f : -1.f;

      // ---- FTRAN: w = B^-1 A[:, q] -----------------------------------------
      for (int i = tid; i < m; i += kThreads) L.vm[i] = L.A[(size_t)i * n + q];
      K1_TICK(C_BOOK);
      post_cluster(kFtran);  // its barrier publishes vm
      K1_TICK(C_FTRAN_POST);
      ftran(L, m, gp);
      K1_PHASE(C_FTRAN_WORK, C_FTRAN_SYNC);

      // ---- ratio test (unified phase rule); ratios into pr, targets into ym
      float tmin = INFINITY;
      for (int i = tid; i < m; i += kThreads) {
        const float x = L.xB[i], lb = L.loB[i], ub = L.hiB[i];
        const float delta = -s * L.w[i];
        const bool up = delta > p.pivot_tol, dn = delta < -p.pivot_tol;
        const bool below = x < lb - ftol, above = x > ub + ftol;
        const float tgt = up ? (below ? lb : ub) : (dn ? (above ? ub : lb) : 0.f);
        const bool blockable = ((up && !above) || (dn && !below)) && isfinite(tgt);
        float ratio = blockable ? (tgt - x) / ((up || dn) ? delta : 1.f) : INFINITY;
        ratio = isnan(ratio) ? ratio : fmaxf(ratio, 0.f);  // jnp.maximum
        L.pr[i] = ratio;
        L.ym[i] = tgt;
        tmin = min_nan(tmin, ratio);
      }
      const float t_rows = block_min_nan(tmin, sm);  // barriers publish pr, ym
      const float tie_cut = t_rows * 1.0001f + 1e-6f;
      float bw = -INFINITY;
      int bi = kIntMax;
      for (int i = tid; i < m; i += kThreads) {
        const float v = L.pr[i] <= tie_cut ? fabsf(L.w[i]) : -INFINITY;
        if (better(v, i, bw, bi)) { bw = v; bi = i; }
      }
      const int r = block_argmax(bw, bi, sm);
      const float lo_q = L.lo[q], hi_q = L.hi[q];
      const float rng_q = hi_q - lo_q;
      const bool flip = rng_q <= t_rows;
      unbounded = !isfinite(min_nan(t_rows, rng_q));
      const float t = flip ? rng_q : L.pr[r];
      const float tgt_r = L.ym[r];
      K1_TICK(C_RATIO);

      if (flip && !unbounded) {
        // ---- bound flip: the entering variable crosses to its other bound --
        for (int i = tid; i < m; i += kThreads) L.xB[i] = L.xB[i] + t * (-s * L.w[i]);
        if (tid == 0) L.vstat[q] = L.vstat[q] == AT_LOWER ? AT_UPPER : AT_LOWER;
        __syncthreads();
      } else if (!flip && !unbounded) {
        // ---- pivot: row r leaves, column q enters --------------------------
        const int lv = L.basis[r];
        const float loB_r = L.loB[r], hiB_r = L.hiB[r], wr = L.w[r];
        const int lstat = loB_r == hiB_r ? FIXED : (tgt_r == hiB_r ? AT_UPPER : AT_LOWER);
        const int vq = L.vstat[q];
        const float enter_base =
            (vq == AT_LOWER || vq == FIXED) ? lo_q : (vq == AT_UPPER ? hi_q : 0.f);
        const Pivot v{q, r, lv, lstat, p1 ? 1 : 0, wr, t, s, enter_base + s * t, dq / wr,
                      fmaxf(L.wts[q], 1.f)};
        const float c_q = L.c[q];
        __syncthreads();  // every thread holds the pre-pivot scalars
        for (int j = tid; j < m; j += kThreads) L.pr[j] = L.Binv[(size_t)r * m + j] / wr;
        if (tid == 0) sm.piv = v;
        K1_TICK(C_BOOK);
        post_cluster(kPivot);  // publishes pr and the scalars
        K1_TICK(C_SWEEPS_POST);
        pivot_sweeps(L, v, m, n, gp);
        K1_PHASE(C_SWEEPS_WORK, C_SWEEPS_SYNC);
        if (tid == 0) {
          L.basis[r] = q;
          L.loB[r] = lo_q;
          L.hiB[r] = hi_q;
          L.cB[r] = c_q;
          L.vstat[lv] = lstat;
          L.vstat[q] = BASIC;
        }
        __syncthreads();
      }
    }

    // ---- status transitions (terminal only from a fresh state) -------------
    const int fresh_now = do_refresh ? 1 : fresh;
    const bool believe = fresh_now == 1;
    const bool wants_exit = !found || unbounded;
    if (found) {
      if (unbounded && believe) status = p1 ? NUMERICAL : UNBOUNDED;
    } else if (believe) {
      status = p1 ? INFEASIBLE : OPTIMAL;
    }
    force = (wants_exit && !believe && status == RUNNING) ? 1 : 0;
    const bool applied = found && !unbounded;
    fresh = applied ? 0 : fresh_now;
    niter += applied ? 1 : 0;

    // ---- phase-1 stall counter ---------------------------------------------
    const bool improved = infeas < best - 1e-6f;
    noimp = p1 ? (improved ? 0 : noimp + 1) : 0;
    best = p1 ? min_nan(best, infeas) : best;
    K1_TICK(C_BOOK);
#ifdef K1_CLOCKS
    ++iters[ph];
#endif
  }
  if (status == RUNNING) status = MAX_ITER;
  post_grid(kExit);
  if (C > 1) cluster_sync();  // the cluster's workers have read the command
  if (tid == 0) {
    L.res[0] = status;
    L.res[1] = niter;
#ifdef K1_CLOCKS
    clk_start += clock64() - clk_last;
    for (int k = 0; k < 2 * kParts; ++k)
      atomicAdd(&g_clocks[(k / kParts) * (kParts + 1) + k % kParts],
                (unsigned long long)sm.clk[k / kParts][k % kParts]);
    atomicAdd(&g_clocks[kParts], iters[0]);
    atomicAdd(&g_clocks[2 * kParts + 1], iters[1]);
    atomicAdd(&g_clocks[2 * (kParts + 1)], (unsigned long long)clk_start);
#endif
  }
}

// Floats of global scratch one LP needs: four m x m (B^-1, the gathered basis
// matrix and two Newton temporaries), eight m-vectors, three n-vectors.
size_t lp_floats(int m, int n) { return 4 * (size_t)m * m + 8 * (size_t)m + 3 * (size_t)n; }

// The configuration of a launch of `blocks` blocks in clusters of `cluster`
// (1: none), cooperative (all its blocks resident at once) or not.
struct Launch {
  cudaLaunchAttribute a[2];
  cudaLaunchConfig_t cfg = {};
  Launch(int blocks, int cluster, bool cooperative, cudaStream_t st) {
    unsigned k = 0;
    if (cluster > 1) {
      a[k].id = cudaLaunchAttributeClusterDimension;
      a[k].val.clusterDim.x = cluster;
      a[k].val.clusterDim.y = 1;
      a[k++].val.clusterDim.z = 1;
    }
    if (cooperative) {
      a[k].id = cudaLaunchAttributeCooperative;
      a[k++].val.cooperative = 1;
    }
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = st;
    cfg.attrs = a;
    cfg.numAttrs = k;
  }
};

// The thread-block cluster of a one-LP launch on the current device: 16
// blocks where the device allows that non-portable size and holds at least
// one such cluster of the kernel, else the portable 8; and how many of them
// it holds at once.  Asked of the device once (a launch of a size 16 needs
// the attribute set first), then read from `known`.
cudaError_t cluster_limits(int* size, int* clusters) {
  constexpr int kDevices = 64;
  static int known[kDevices][2];  // (size, clusters) of a device asked; 0: not yet
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && known[dev][0] > 0) {
    *size = known[dev][0];
    *clusters = known[dev][1];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err != cudaSuccess) return err;
  const bool wide = cudaFuncSetAttribute(simplex_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed,
                                         1) == cudaSuccess;
  cudaGetLastError();  // a refused size 16 is no error of the launch
  for (int c = wide ? 16 : 8; c >= 8; c /= 2) {
    const Launch one(c, c, false, 0);
    int k = 0;
    err = cudaOccupancyMaxActiveClusters(&k, simplex_kernel, &one.cfg);
    if (err == cudaSuccess && k >= 1) {
      *size = c;
      *clusters = k;
      if (dev < kDevices) {
        known[dev][0] = c;
        known[dev][1] = k;
      }
      return cudaSuccess;
    }
    cudaGetLastError();
  }
  return err == cudaSuccess ? cudaErrorNotSupported : err;
}

}  // namespace

extern "C" {

// Floats of global scratch a launch of `batch` LPs needs: each LP's, then
// the grid's control block.
size_t batched_simplex_workspace_floats(int batch, int m, int n) {
  return (size_t)batch * lp_floats(m, n) + sizeof(Ctl) / sizeof(float);
}

// What bounds the grid of a one-LP launch on the current device: the blocks
// of its thread-block cluster and how many such clusters of the kernel it
// holds at once.  Returns a cudaError_t, cudaErrorNotSupported when the
// device cannot launch a cooperative grid or hold one cluster.
int batched_simplex_cluster_limits(int* size, int* clusters) {
  return static_cast<int>(cluster_limits(size, clusters));
}

// Launch K1 on `stream` for `batch` LPs.  A (batch, m, n), b (batch, m),
// c/lo/hi (batch, n), all f32; basis0/vstat0/Binv0 all null (cold) or all
// set (warm: (batch, m) i32, (batch, n) i32, (batch, m, m) f32).  out
// (batch, m + n + 2) i32 receives [basis | vstat | status | niter]; ws holds
// batched_simplex_workspace_floats(batch, m, n) floats and leaves each LP's
// final B^-1 in its first m * m.  A batch of one runs as one cooperative
// grid of `blocks` blocks, in thread-block clusters of the size that
// batched_simplex_cluster_limits gives (`blocks` a whole number of them, at
// most kMaxGrid, all resident at once: at most its clusters), or as one block
// with no cluster (`blocks` = 1); its results do not depend on `blocks`.  A
// larger batch runs one block per LP and takes `blocks` = 1 only.  Returns
// the cudaError_t of the launch (never a smaller grid instead); does not
// synchronise.
int batched_simplex_launch(const float* A, const float* b, const float* c,
                           const float* lo, const float* hi, const int* basis0,
                           const int* vstat0, const float* Binv0, int* out,
                           float* ws, int batch, int m, int n, int slack0,
                           int max_iter, int refactor_period, float feas_tol,
                           float opt_tol, float pivot_tol, int bland_after,
                           int blocks, void* stream) {
  if (batch < 1 || blocks < 1 || blocks > kMaxGrid || (batch > 1 && blocks != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.m = m;
  p.n = n;
  p.slack0 = slack0;
  p.max_iter = max_iter;
  p.refactor_period = refactor_period;
  p.bland_after = bland_after;
  p.warm = basis0 != nullptr;
  p.wide = batch == 1;
  p.cluster = 1;
  p.feas_tol = feas_tol;
  p.opt_tol = opt_tol;
  p.pivot_tol = pivot_tol;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t stride = lp_floats(m, n);
  Ctl* ctl = reinterpret_cast<Ctl*>(ws + (size_t)batch * stride);
  if (!p.wide) {
    simplex_kernel<<<batch, kThreads, 0, st>>>(A, b, c, lo, hi, basis0, vstat0, Binv0, out,
                                               ws, stride, ctl, p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaSuccess;
  if (blocks > 1) {  // a grid of other than whole clusters: the launch refuses it
    int clusters = 0;
    err = cluster_limits(&p.cluster, &clusters);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = zero_ctl(ctl, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&A,    &b,   &c,      &lo,   &hi,  &basis0, &vstat0,
                  &Binv0, &out, &ws, &stride, &ctl, &p};
  const Launch grid(blocks, p.cluster, true, st);
  err = cudaLaunchKernelExC(&grid.cfg, (const void*)simplex_kernel, args);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's
  return static_cast<int>(err == cudaSuccess ? last : err);
}

const char* batched_simplex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef K1_CLOCKS
// Copy the leaders' cycle sums (kClockWords values: phase 1's parts C_FEAS ..
// C_BOOK and its iterations, phase 2's, then the starts and exits) into
// `host` and zero them.  Synchronises.
int batched_simplex_clocks(unsigned long long* host) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks));
  const unsigned long long zero[kClockWords] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
