// K1, the batched simplex megakernel, in CUDA C++ for Hopper (sm_90a).
//
// Replaces minilp_tpu/ops/kernels/batched_simplex.py::_simplex_kernel, the
// Pallas TPU kernel launched by simplex_kernel_call.  It computes the same
// thing: one LP per thread block (grid = batch), and the whole bounded
// two-phase primal simplex of that LP inside one launch — Dantzig pricing in
// phase 1, Devex in phase 2, Bland after `bland_after` stalls, FTRAN against
// a dense f32 B^-1, the ratio test with bound flips, a rank-1 product-form
// update of B^-1, and a Newton refresh (two sweeps X <- X + X(I - B X)) every
// `refactor_period` pivots, from a cold slack basis or a warm
// (basis, vstat, B^-1).  It writes (basis, vstat, status, niter) packed into
// one int32 row per LP; the host re-derives the vertex in f64.
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
// What bounds it on an H100: one LP lives on one SM.  A (m x n) and B^-1
// (m x m) sit in global memory (4.1 MB and 1.0 MB at the largest single-LP
// shape, 504 x 2048) and stay L2-resident; each pivot streams A once or
// twice (phase-1 reduced costs, or the phase-2 pivot row) and B^-1 two or
// three times through that one SM's L2 bandwidth, so a pivot is bound by
// per-SM L2 bytes, not FLOPs.  The Newton refresh is four m x m x m
// products (about 1 GFLOP at m = 504) on that same SM's FP32 units every
// `refactor_period` pivots, and it dominates at m ~ 500.  The first design
// keeps the simple mapping (one block, shared-memory tiled GEMM, block
// reductions through shared memory); spreading one LP over a cluster of SMs
// is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;
// Newton-refresh GEMM tiling: 64 x 64 output tile, 16-deep k slabs; each of
// the 512 threads owns a 2 x 4 patch of the tile.
constexpr int kTile = 64;
constexpr int kTileK = 16;

// Status and VarStat codes (minilp_tpu_torch/status.py).
constexpr int RUNNING = 0, OPTIMAL = 1, INFEASIBLE = 2, UNBOUNDED = 3,
              MAX_ITER = 4, NUMERICAL = 5;
constexpr int AT_LOWER = 0, AT_UPPER = 1, FREE = 2, FIXED = 3, BASIC = 4;

struct Params {
  int m, n, slack0, max_iter, refactor_period, bland_after, warm;
  float feas_tol, opt_tol, pivot_tol;
};

struct Smem {
  float red_f[kWarps];
  int red_i[kWarps];
  float As[kTileK][kTile + 1];  // P tile, k-major; +1 breaks store conflicts
  alignas(16) float Bs[kTileK][kTile];
};

// ---- block reductions: every thread returns the same value -----------------
// Lane 0 of each warp publishes its warp's value; every thread then folds the
// kWarps values in warp order, so the result is identical in all threads.
// Each starts with a barrier that protects the scratch from its last reader.

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);  // jnp.minimum semantics
}

// argmax order: larger value first, NaN above everything, lower index on ties
// (lax.argmax / torch.argmax semantics).
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ float block_sum(float v, Smem& sm) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red_f[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = sm.red_f[0];
  for (int i = 1; i < kWarps; ++i) s += sm.red_f[i];
  return s;
}

__device__ int block_sum_int(int v, Smem& sm) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red_i[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int i = 0; i < kWarps; ++i) s += sm.red_i[i];
  return s;
}

__device__ int block_min_int(int v, Smem& sm) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red_i[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = sm.red_i[0];
  for (int i = 1; i < kWarps; ++i) s = min(s, sm.red_i[i]);
  return s;
}

__device__ float block_min_nan(float v, Smem& sm) {
  for (int o = 16; o > 0; o >>= 1) v = min_nan(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red_f[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = sm.red_f[0];
  for (int i = 1; i < kWarps; ++i) s = min_nan(s, sm.red_f[i]);
  return s;
}

__device__ int block_argmax(float v, int idx, Smem& sm) {
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
  return idx;
}

// ---- dense kernels on one LP ----------------------------------------------
// Pointers to data the kernel writes carry no __restrict__: the read-only
// (non-coherent) cache path must never serve them.

// f(i, sum_j M[i, j] x[j]) for each row i < rows: one warp per row, lanes
// stride the row (coalesced), fixed-order shuffle sum; lane 0 calls f.
template <typename F>
__device__ void matvec(const float* M, const float* x, int rows, int cols, F f) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows; i += kWarps) {
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
__device__ void colsums(const float* y, const float* M, int rows, int cols, F f) {
  for (int j0 = threadIdx.x; j0 < cols; j0 += 4 * kThreads) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int jj[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) { jj[k] = j0 + k * kThreads; ok[k] = jj[k] < cols; }
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

// C = base + sgn * P Q for m x m row-major matrices (base == nullptr: the
// identity).  The block walks the 64 x 64 output tiles in turn; k runs in
// order for every output, so the result is deterministic.  C must not alias
// P or Q.
__device__ void gemm(const float* P, const float* Q, float* C, const float* base,
                     float sgn, int m, Smem& sm) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // 16 x 32 threads
  const int tiles = (m + kTile - 1) / kTile;
  for (int t = 0; t < tiles * tiles; ++t) {
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

__device__ __forceinline__ float nonbasic_x(int v, float l, float h) {
  if (v == AT_LOWER || v == FIXED) return l;
  if (v == AT_UPPER) return h;
  return 0.f;
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

// Exact (f32) xB and reduced costs from B^-1 and the statuses.
__device__ void recompute(const Lp& L, int m, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads)
    L.dc[j] = nonbasic_x(L.vstat[j], L.lo[j], L.hi[j]);
  __syncthreads();
  matvec(L.A, L.dc, m, n, [&](int i, float acc) { L.vm[i] = L.b[i] - acc; });
  __syncthreads();
  matvec(L.Binv, L.vm, m, m, [&](int i, float acc) { L.xB[i] = acc; });
  colsums(L.cB, L.Binv, m, m, [&](int j, float acc) { L.ym[j] = acc; });
  __syncthreads();
  colsums(L.ym, L.A, m, n, [&](int j, float acc) {
    L.d[j] = L.vstat[j] == BASIC ? 0.f : L.c[j] - acc;
  });
  __syncthreads();
}

// Two Newton sweeps on B^-1 against the basis matrix gathered by index.
__device__ void newton_refresh(const Lp& L, int m, int n, Smem& sm) {
  const size_t mm = (size_t)m * m;
  for (size_t e = threadIdx.x; e < mm; e += kThreads)
    L.Bm[e] = L.A[(e / m) * n + L.basis[e % m]];
  __syncthreads();
  gemm(L.Bm, L.Binv, L.T, nullptr, -1.f, m, sm);  // T  = I - B X
  __syncthreads();
  gemm(L.Binv, L.T, L.X2, L.Binv, 1.f, m, sm);    // X2 = X + X T
  __syncthreads();
  gemm(L.Bm, L.X2, L.T, nullptr, -1.f, m, sm);    // T  = I - B X2
  __syncthreads();
  gemm(L.X2, L.T, L.Binv, L.X2, 1.f, m, sm);      // X  = X2 + X2 T
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
simplex_kernel(const float* __restrict__ A_all, const float* __restrict__ b_all,
               const float* __restrict__ c_all, const float* __restrict__ lo_all,
               const float* __restrict__ hi_all, const int* __restrict__ basis0_all,
               const int* __restrict__ vstat0_all, const float* __restrict__ Binv0_all,
               int* out_all, float* ws_all, size_t ws_stride, Params p) {
  __shared__ Smem sm;
  const int m = p.m, n = p.n, tid = threadIdx.x;
  const size_t lp = blockIdx.x, mm = (size_t)m * m;
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
  __syncthreads();
  recompute(L, m, n);

  // Scalars of the loop carry live in registers, identical in every thread
  // (each is computed from block-reduced or barrier-published values).
  // fresh = 1 <=> (B^-1, xB, d) were recomputed since the last pivot:
  // terminal claims are believed only then.  A warm start distrusts the
  // handed-in inverse.
  int status = RUNNING, niter = 0, phase = 1, noimp = 0, force = 0;
  int fresh = p.warm ? 0 : 1;
  float best = INFINITY;

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
    const bool do_refresh = transition || force == 1 ||
                            (niter > 0 && niter % p.refactor_period == 0);
    if (do_refresh) {
      newton_refresh(L, m, n, sm);
      recompute(L, m, n);
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
    if (p1) {  // d1 = -(sigma B^-1) A, zero on basic columns
      colsums(L.vm, L.Binv, m, m, [&](int k, float acc) { L.ym[k] = acc; });
      __syncthreads();
      colsums(L.ym, L.A, m, n, [&](int j, float acc) {
        L.dc[j] = L.vstat[j] == BASIC ? 0.f : -acc;
      });
      __syncthreads();
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
      const float g = p1 ? 1.f : L.wts[j];
      const float score = elig ? dj * dj / fmaxf(g, 1e-3f) : -INFINITY;
      if (better(score, j, bs, bj)) { bs = score; bj = j; }
      if (elig && j < first) first = j;
    }
    const int q_d = block_argmax(bs, bj, sm);
    const int q_b = block_min_int(first, sm);
    const bool found = q_b < n;
    const int q = bland ? q_b : q_d;

    bool unbounded = false;
    if (found) {
      const float dq = dcur[q];
      const float s = dq < 0.f ? 1.f : -1.f;

      // ---- FTRAN: w = B^-1 A[:, q] -----------------------------------------
      for (int i = tid; i < m; i += kThreads) L.vm[i] = L.A[(size_t)i * n + q];
      __syncthreads();
      matvec(L.Binv, L.vm, m, m, [&](int i, float acc) { L.w[i] = acc; });
      __syncthreads();

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
        const float x_enter = enter_base + s * t;
        const float gq = fmaxf(L.wts[q], 1.f);
        const float c_q = L.c[q];
        __syncthreads();  // every thread holds the pre-pivot scalars
        for (int j = tid; j < m; j += kThreads) L.pr[j] = L.Binv[(size_t)r * m + j] / wr;
        __syncthreads();
        // PFI rank-1 update: rows i -= (w_i - [i == r]) * pr  (row r -> ~pr)
        for (size_t e = tid; e < mm; e += kThreads) {
          const int i = (int)(e / m);
          L.Binv[e] = L.Binv[e] - (L.w[i] - (i == r ? 1.f : 0.f)) * L.pr[e % m];
        }
        for (int i = tid; i < m; i += kThreads)
          L.xB[i] = i == r ? x_enter : L.xB[i] + t * (-s * L.w[i]);
        if (!p1) {
          // phase-2 incremental reduced costs and Devex weights from the
          // pivot row alpha = wr * (pr A) = (old B^-1)_r A
          const float rd = dq / wr;
          const bool reset = gq > 1e6f;
          colsums(L.pr, L.A, m, n, [&](int j, float acc) {
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
          });
        }
        __syncthreads();
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
  }
  if (status == RUNNING) status = MAX_ITER;
  if (tid == 0) {
    L.res[0] = status;
    L.res[1] = niter;
  }
}

}  // namespace

extern "C" {

// Floats of global scratch one LP needs: four m x m (B^-1, the gathered basis
// matrix and two Newton temporaries), eight m-vectors, three n-vectors.
size_t batched_simplex_workspace_floats(int m, int n) {
  return 4 * (size_t)m * m + 8 * (size_t)m + 3 * (size_t)n;
}

// Launch K1 on `stream` for `batch` LPs.  A (batch, m, n), b (batch, m),
// c/lo/hi (batch, n), all f32; basis0/vstat0/Binv0 all null (cold) or all
// set (warm: (batch, m) i32, (batch, n) i32, (batch, m, m) f32).  out
// (batch, m + n + 2) i32 receives [basis | vstat | status | niter]; ws holds
// batch * batched_simplex_workspace_floats(m, n) floats.  Returns the
// cudaError_t of the launch; does not synchronise.
int batched_simplex_launch(const float* A, const float* b, const float* c,
                           const float* lo, const float* hi, const int* basis0,
                           const int* vstat0, const float* Binv0, int* out,
                           float* ws, int batch, int m, int n, int slack0,
                           int max_iter, int refactor_period, float feas_tol,
                           float opt_tol, float pivot_tol, int bland_after,
                           void* stream) {
  Params p;
  p.m = m;
  p.n = n;
  p.slack0 = slack0;
  p.max_iter = max_iter;
  p.refactor_period = refactor_period;
  p.bland_after = bland_after;
  p.warm = basis0 != nullptr;
  p.feas_tol = feas_tol;
  p.opt_tol = opt_tol;
  p.pivot_tol = pivot_tol;
  simplex_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, b, c, lo, hi, basis0, vstat0, Binv0, out, ws,
      batched_simplex_workspace_floats(m, n), p);
  return static_cast<int>(cudaGetLastError());
}

const char* batched_simplex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
