// K3, the packed simplex kernel, in CUDA C++ for Hopper (sm_90a).
//
// Replaces minilp_tpu/ops/kernels/packed_simplex.py::_packed_kernel, the
// Pallas TPU kernel launched by packed_kernel_call.  It computes the same
// thing: k LPs in lockstep per pack, each running K1's bounded two-phase
// primal simplex from the slack basis — Dantzig pricing in phase 1, Devex in
// phase 2, Bland after `bland_after` stalls, FTRAN against a dense f32 B^-1,
// the ratio test with bound flips, a rank-1 product-form update of B^-1 —
// with ONE refresh decision per pack and iteration: the pack refreshes (two
// Newton sweeps X <- X + X(I - B X) and an exact recompute of x_B and d) when
// any running member makes its phase-1 -> 2 transition or needs a forced exit
// check, or when the largest pivot count of the pack, finished members
// included, is a positive multiple of `refactor_period`.  A refresh makes
// every member fresh, and terminal claims are believed only from a fresh
// state, so an LP's pivots depend on its pack-mates.  It writes (basis,
// vstat, status, niter) packed into one int32 row per LP.
//
// What went: the TPU kernel's block-diagonal (km x km) inverse, its 0/1
// layout matmuls and one-hot gathers, and the f32 round trip of the basis —
// Mosaic workarounds for the ban on dynamic indexing.  Here each LP keeps
// its own m x m inverse and integer basis, and reads by index.  The
// off-diagonal blocks were exact zeros, so the only change is that an inf or
// NaN in one LP's block no longer reaches its pack-mates through 0 * inf.
// Semantics kept from K1: f32 without fast math, lowest-index ties in every
// argmax/argmin, the tie window ratio <= t*1.0001 + 1e-6, the fresh/force
// rule, the Devex reset at 1e6, and jnp.minimum/maximum's NaN rules.
//
// Mapping: one thread block per pack (grid = B / k), one warp per LP (k * 32
// threads, k <= 32).  A warp owns its LP's rows and columns in strides of 32;
// its reductions are xor shuffles (lowest index on ties, identical in every
// lane), and its steps are ordered by __syncwarp.  The only block barrier is
// the pack's refresh decision, once per iteration: each warp publishes
// (alive, transition, force, niter) into a double-buffered shared array, and
// every warp folds the k entries.  A finished warp keeps taking that barrier
// and does nothing else, until no LP of the pack is alive.
//
// What bounds it on an H100: at the bench's shape (k = 8, m = 32, n = 128) a
// pivot is a few thousand FMAs per LP (pricing, FTRAN, the rank-1 update, the
// pivot row) and the refresh four m^3 products; the whole batch of 1024 is
// about 4 GFLOP (counted from its 179k pivots), 0.05 ms at the card's f32
// peak, while the bytes (A read once, 17 MB) take 5 us.  What bounds it in
// practice is latency: one warp's dependent chain of loads, shuffles and
// __syncwarp per pivot, with the pack waiting on its slowest member
// (lockstep), 8 warps per SM.  So every operand a pivot reads sits in shared
// memory where the pack fits.  Three layouts, picked per launch by the host
// (`packed_simplex_layout_fits`, the first that fits):
//  - STAGED: each LP's A is copied into shared memory once, at the start,
//    with an odd row stride (n | 1, so FTRAN's column gather, lanes on rows,
//    hits 32 banks), beside the workspace.  The bench's shape: 225 280 B per
//    pack of 8.
//  - SHARED: the workspace in shared memory, A read from global memory (L2).
//  - GLOBAL: the workspace in global memory, for large packs.
// The workspace per LP is B^-1 and the Newton temporaries (m x m, odd row
// stride m | 1, so a warp reading a column of B^-1 hits 32 banks), eight
// m-vectors, three n-vectors, and the basis and statuses, which go to the
// output row at the end.  The basis matrix is never gathered: the refresh
// reads B[i][kk] = A[i][basis[kk]] by index.  For m <= 32 in a block of up
// to 8 LPs each lane keeps an 8 x 4 tile of T = I - B X in registers (the
// next product takes T's rows from the lanes by shuffles), so one temporary
// serves both sweeps, and a step of a product loads 12 operands for 32 FMAs;
// otherwise T and X2 stay in the workspace.  Every float output keeps one
// fixed-order chain (sums over the inner index in order, base + sgn * sum),
// so every layout and either form of the refresh gives the same bits.
// The kernel is templated on
// its block size (its `__launch_bounds__`, so that ptxas keeps 255 registers
// a thread at up to 256 threads) and on the layout (so that shared-memory
// operands are read as such).  More LPs per SM, or more warps per LP, are
// later steps.
//
// Built with -DK3_CLOCKS, the kernel also sums clock64() cycles per phase of
// an iteration over every running LP (`packed_simplex_clocks`); built with
// -DK3_PROBE, it records one LP's ratio test at one pivot
// (`packed_simplex_probe_at`, `packed_simplex_probe_read`).  The normal
// build carries neither.

#include "simplex_common.cuh"

namespace {

constexpr int kMaxPack = 32;                      // one warp per LP, 1024 threads
constexpr size_t kSmemBudget = 227 * 1024 - 1024;  // dynamic bytes a block may take

enum Layout { STAGED = 0, SHARED = 1, GLOBAL = 2 };

struct Params {
  int k, m, n, ld, slack0, max_iter, refactor_period, bland_after;
  size_t ws_stride;
  float feas_tol, opt_tol, pivot_tol;
};

// Row stride of the m x m matrices: odd, so lane i reading M[i * ld + j]
// and lane j reading M[i * ld + j] both touch 32 distinct banks.
__host__ __device__ inline int row_stride(int m) { return m | 1; }

// The register tiles of the refresh need m <= 32 and the registers of a
// block of at most 256 threads (8 LPs); a larger block (64 registers a
// thread) or m keeps T in the workspace.
constexpr int kTileThreads = 256;
__host__ __device__ inline bool newton_tiles(int k, int m) {
  return m <= 32 && k * 32 <= kTileThreads;
}

// Newton temporaries in the workspace: one with the register tiles, else two.
__host__ __device__ inline int newton_temps(int k, int m) { return newton_tiles(k, m) ? 1 : 2; }

#ifdef K3_CLOCKS
// per phase: cycles summed over every running LP's iterations; then the
// count of those iterations and of their refreshes
enum Phase { P_BARRIER, P_NEWTON, P_RECOMPUTE, P_DUALS, P_PRICING, P_FTRAN, P_RATIO, P_UPDATE,
             P_ROW, P_STATUS, kPhases };
__device__ unsigned long long g_clocks[kPhases + 2];
#define K3_TICK(ph)                                \
  do {                                             \
    const long long now_ = clock64();              \
    clk[ph] += now_ - clk_last;                    \
    clk_last = now_;                               \
  } while (0)
#else
#define K3_TICK(ph) \
  do {              \
  } while (0)
#endif

#ifdef K3_PROBE
// The LP (its index in the launch) and its pivot count before the step whose
// ratio test is recorded; the record: a header (written, q, r, t_rows, the
// tie window, flip, s, the entering range, phase, refresh, Bland, d_q), then
// (x_B, w, ratio, target) per row, for the first kProbeRows rows.
constexpr int kProbeHead = 12, kProbeRows = 64;
__device__ long long g_probe_at[2] = {-1, -1};
__device__ float g_probe[kProbeHead + 4 * kProbeRows];
#endif

// ---- warp reductions: fixed xor order, the result in every lane ----------

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min_nan(float v) {
  for (int o = 16; o > 0; o >>= 1) v = min_nan(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Argmax of (v, idx) pairs under `better` (NaN first, lower index on ties).
__device__ __forceinline__ int warp_argmax(float v, int idx) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (better(ov, oi, v, idx)) { v = ov; idx = oi; }
  }
  return idx;
}

// ---- dense kernels on one LP, run by its warp ----------------------------
// Pointers to data the kernel writes carry no __restrict__: the read-only
// cache path must never serve them.

// f(i, sum_j M[i * ldm + j] x[j]) for each row i: lane i owns row i (in
// strides of 32) and sums over j in order.  For the m x m matrices.
template <typename F>
__device__ void warp_rows(const float* M, int ldm, const float* x, int rows, int cols,
                          int lane, F f) {
  for (int i = lane; i < rows; i += 32) {
    const float* row = M + (size_t)i * ldm;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < cols; ++j) acc = fmaf(row[j], x[j], acc);
    f(i, acc);
  }
}

// The same for A: the lanes stride each row (coalesced) and a shuffle sums,
// four rows at a time; lane 0 calls f.
template <typename F>
__device__ void warp_rows_coalesced(const float* M, int ldm, const float* x, int rows,
                                    int cols, int lane, F f) {
  for (int i0 = 0; i0 < rows; i0 += 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = lane; j < cols; j += 32) {
      const float xj = x[j];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < rows) acc[u] = fmaf(M[(size_t)(i0 + u) * ldm + j], xj, acc[u]);
    }
    for (int o = 16; o > 0; o >>= 1)  // warp_sum's tree, four rows interleaved
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += __shfl_xor_sync(kFull, acc[u], o);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < rows) f(i0 + u, acc[u]);
  }
}

// f(j, sum_i y[i] M[i * ldm + j]) for each column j: lane j owns column j
// (in strides of 32, four columns in flight) and sums over i in order, the
// loads of eight rows issued together.
template <typename F>
__device__ void warp_cols(const float* y, const float* M, int ldm, int rows, int cols,
                          int lane, F f) {
  for (int j0 = lane; j0 < cols; j0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int jj[4];
    bool ok[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) { jj[t] = j0 + 32 * t; ok[t] = jj[t] < cols; }
#pragma unroll 8
    for (int i = 0; i < rows; ++i) {
      const float yi = y[i];
      const float* row = M + (size_t)i * ldm;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (ok[t]) acc[t] = fmaf(yi, row[jj[t]], acc[t]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (ok[t]) f(jj[t], acc[t]);
  }
}

// C = base + sgn * P Q for m x m matrices of row stride ld (base == nullptr:
// the identity); P(i, kk) reads the left operand.  Lane j owns column j; four
// rows share each load of Q; every output sums over kk in order.  C must not
// alias P, Q or base.
template <typename PF>
__device__ void warp_gemm(PF P, const float* Q, float* C, const float* base, float sgn,
                          int m, int ld, int lane) {
  for (int j = lane; j < m; j += 32) {
    for (int i0 = 0; i0 < m; i0 += 4) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < m; ++kk) {
        const float q = Q[(size_t)kk * ld + j];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (i0 + t < m) acc[t] = fmaf(P(i0 + t, kk), q, acc[t]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = i0 + t;
        if (i >= m) break;
        const size_t e = (size_t)i * ld + j;
        const float bv = base ? base[e] : (i == j ? 1.f : 0.f);
        C[e] = bv + sgn * acc[t];
      }
    }
  }
}

// One LP's state: its slices of the inputs, A (the staged copy in shared
// memory, or the input), its output row, and its workspace.
struct Lp {
  const float *A, *b, *c, *lo, *hi;  // never written
  int lda;                           // A's row stride
  int* out;                          // [basis | vstat | status | niter]
  int* basis;                        // m, in the workspace until the end
  int* vstat;                        // n, likewise
  float *Binv, *T, *X2;  // m x m, row stride ld (X2 only without the register tiles)
  float *xB, *loB, *hiB, *cB, *w, *pr, *vm, *ym;  // m
  float *d, *wts, *dc;                            // n
};

// Exact (f32) x_B and reduced costs from B^-1 and the statuses.
__device__ void recompute(const Lp& L, int m, int n, int ld, int lane) {
  for (int j = lane; j < n; j += 32) L.dc[j] = nonbasic_x(L.vstat[j], L.lo[j], L.hi[j]);
  __syncwarp();
  warp_rows_coalesced(L.A, L.lda, L.dc, m, n, lane,
                      [&](int i, float acc) { L.vm[i] = L.b[i] - acc; });
  __syncwarp();
  warp_rows(L.Binv, ld, L.vm, m, m, lane, [&](int i, float acc) { L.xB[i] = acc; });
  warp_cols(L.cB, L.Binv, ld, m, m, lane, [&](int j, float acc) { L.ym[j] = acc; });
  __syncwarp();
  warp_cols(L.ym, L.A, L.lda, m, n, lane, [&](int j, float acc) {
    L.d[j] = L.vstat[j] == BASIC ? 0.f : L.c[j] - acc;
  });
  __syncwarp();
}

// The m <= 32 refresh on register tiles: lane l = 8 rg + cg owns rows
// 8 rg .. 8 rg + 7 and columns 4 cg .. 4 cg + 3 of each product, so a step
// over kk loads 8 + 4 operands for 32 FMAs.  Every output keeps
// warp_gemm's chain: the sum over kk < m in order, then base + sgn * sum.

// T = I - B Q into the tile t (B gathered from A by index).
__device__ __forceinline__ void i_minus_bq_tile(const Lp& L, const float* Q, int m, int ld,
                                                int rg, int cg, float (&t)[8][4]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) t[a][b] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < m; ++kk) {
    const float* Bk = L.A + L.basis[kk];
    float bv[8], qv[4];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = 8 * rg + a;
      bv[a] = i < m ? Bk[(size_t)i * L.lda] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = 4 * cg + b;
      qv[b] = j < m ? Q[(size_t)kk * ld + j] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) t[a][b] = fmaf(bv[a], qv[b], t[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      t[a][b] = (8 * rg + a == 4 * cg + b ? 1.f : 0.f) + -1.f * t[a][b];
}

// C = P + P T with T in the lanes' tiles t: row kk of T comes from the lanes
// of row group kk / 8 by shuffles.  C must not alias P.
__device__ __forceinline__ void p_plus_pt_tile(const float* P, const float (&t)[8][4],
                                               float* C, int m, int ld, int rg, int cg) {
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 32; ++kk) {
    if (kk < m) {  // the same in every lane: the shuffles see the whole warp
      float tv[4], pv[8];
#pragma unroll
      for (int b = 0; b < 4; ++b) tv[b] = __shfl_sync(kFull, t[kk & 7][b], 8 * (kk >> 3) + cg);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = 8 * rg + a;
        pv[a] = i < m ? P[(size_t)i * ld + kk] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(pv[a], tv[b], acc[a][b]);
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = 8 * rg + a, j = 4 * cg + b;
      if (i < m && j < m) {
        const size_t e = (size_t)i * ld + j;
        C[e] = P[e] + 1.f * acc[a][b];
      }
    }
  }
}

// Two Newton sweeps on B^-1, the basis matrix read from A by index:
// T = I - B X, X2 = X + X T, T = I - B X2, X = X2 + X2 T.
template <bool kTiles>
__device__ void newton_refresh(const Lp& L, int m, int ld, int lane) {
  if (kTiles && m <= 32) {
    // T stays in the lanes' register tiles, X2 goes to T's place in the
    // workspace
    const int rg = lane >> 3, cg = lane & 7;
    float t[8][4];
    float* X2 = L.T;
    i_minus_bq_tile(L, L.Binv, m, ld, rg, cg, t);
    p_plus_pt_tile(L.Binv, t, X2, m, ld, rg, cg);
    __syncwarp();  // X2 complete; B^-1's last read is done
    i_minus_bq_tile(L, X2, m, ld, rg, cg, t);
    p_plus_pt_tile(X2, t, L.Binv, m, ld, rg, cg);
    __syncwarp();
    return;
  }
  const auto B = [&](int i, int kk) { return L.A[(size_t)i * L.lda + L.basis[kk]]; };
  const auto X = [&](int i, int kk) { return L.Binv[(size_t)i * ld + kk]; };
  const auto X2 = [&](int i, int kk) { return L.X2[(size_t)i * ld + kk]; };
  warp_gemm(B, L.Binv, L.T, nullptr, -1.f, m, ld, lane);  // T  = I - B X
  __syncwarp();
  warp_gemm(X, L.T, L.X2, L.Binv, 1.f, m, ld, lane);      // X2 = X + X T
  __syncwarp();
  warp_gemm(B, L.X2, L.T, nullptr, -1.f, m, ld, lane);    // T  = I - B X2
  __syncwarp();
  warp_gemm(X2, L.T, L.Binv, L.X2, 1.f, m, ld, lane);     // X  = X2 + X2 T
  __syncwarp();
}

template <int kThreads, int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
packed_kernel(const float* __restrict__ A_all, const float* __restrict__ b_all,
              const float* __restrict__ c_all, const float* __restrict__ lo_all,
              const float* __restrict__ hi_all, int* out_all, float* ws_all, Params p) {
  extern __shared__ float smem_ws[];
  // the pack's refresh decision, double-buffered by iteration parity: a warp
  // writes iteration it + 1's entry only after every warp has passed
  // iteration it's barrier, and reads iteration it's entries before it can
  // reach iteration it + 1's barrier
  __shared__ int sh_flags[2][kMaxPack];  // bit 0 alive, 1 transition, 2 force
  __shared__ int sh_niter[2][kMaxPack];

  const int m = p.m, n = p.n, ld = p.ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t lp = (size_t)blockIdx.x * p.k + warp, mm = (size_t)m * ld;
  const float ftol = p.feas_tol;
#ifdef K3_CLOCKS
  long long clk[kPhases + 2] = {};
  long long clk_last = clock64();
#endif

  Lp L;
  const float* A_lp = A_all + lp * m * n;
  L.b = b_all + lp * m;
  L.c = c_all + lp * n;
  L.lo = lo_all + lp * n;
  L.hi = hi_all + lp * n;
  L.out = out_all + lp * (m + n + 2);
  float* ws = kLayout == GLOBAL ? ws_all + lp * p.ws_stride : smem_ws + warp * p.ws_stride;
  if (kLayout == STAGED) {
    // A into shared memory once, row stride n | 1
    float* As = ws;
    L.lda = n | 1;
    for (int i = 0; i < m; ++i)
      for (int j = lane; j < n; j += 32) As[(size_t)i * L.lda + j] = A_lp[(size_t)i * n + j];
    L.A = As;
    ws += (size_t)m * L.lda;
  } else {
    L.A = A_lp;
    L.lda = n;
  }
  L.Binv = ws;
  L.T = ws + mm;
  L.X2 = newton_temps(p.k, m) == 2 ? ws + 2 * mm : nullptr;
  L.xB = ws + (1 + newton_temps(p.k, m)) * mm;
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
  L.basis = reinterpret_cast<int*>(L.dc + n);
  L.vstat = L.basis + m;

  // ---- cold start: the slack basis, B^-1 = I --------------------------------
  for (int i = 0; i < m; ++i)
    for (int j = lane; j < m; j += 32) L.Binv[(size_t)i * ld + j] = i == j ? 1.f : 0.f;
  for (int i = lane; i < m; i += 32) L.basis[i] = p.slack0 + i;
  // canonical.initial_vstat: fixed => FIXED, finite lower => AT_LOWER,
  // else finite upper => AT_UPPER, else FREE; the slack block is BASIC
  for (int j = lane; j < n; j += 32) {
    const float l = L.lo[j], h = L.hi[j];
    int v = isfinite(l) ? AT_LOWER : (isfinite(h) ? AT_UPPER : FREE);
    if (l == h) v = FIXED;
    if (j >= p.slack0 && j < p.slack0 + m) v = BASIC;
    L.vstat[j] = v;
    L.wts[j] = 1.f;  // Devex weights
  }
  for (int i = lane; i < m; i += 32) {
    const int k = p.slack0 + i;
    L.loB[i] = L.lo[k];
    L.hiB[i] = L.hi[k];
    L.cB[i] = L.c[k];
  }
  __syncwarp();
  recompute(L, m, n, ld, lane);

  // Scalars of the loop carry live in registers, identical in every lane of
  // the warp (each comes from a warp reduction or the pack's barrier).
  // fresh = 1 <=> (B^-1, x_B, d) were recomputed since the last pivot.
  int status = RUNNING, niter = 0, phase = 1, noimp = 0, force = 0, fresh = 1;
  float best = INFINITY;

  for (int it = 0;; ++it) {
    // running LPs: status RUNNING under the pivot cap (the cap is enforced in
    // the body, so only max_iter <= 0 tells the two apart)
    const bool alive = status == RUNNING && niter < p.max_iter;

    // ---- the pack's refresh decision (transition, forced, or periodic) ----
    int nviol = 0;
    if (alive && phase == 1) {
      for (int i = lane; i < m; i += 32) {
        const float x = L.xB[i];
        nviol += (x < L.loB[i] - ftol) || (x > L.hiB[i] + ftol);
      }
    }
    const bool transition = alive && phase == 1 && warp_sum_int(nviol) == 0;
    if (transition) phase = 2;
    const int buf = it & 1;
    if (lane == 0) {
      sh_flags[buf][warp] = (alive ? 1 : 0) | (transition ? 2 : 0) | (alive && force ? 4 : 0);
      sh_niter[buf][warp] = niter;
    }
    __syncthreads();
    int flags = 0, top = 0;
    for (int i = 0; i < p.k; ++i) {
      flags |= sh_flags[buf][i];
      top = max(top, sh_niter[buf][i]);
    }
    if (!(flags & 1)) break;  // no LP of the pack is alive
    if (!alive) continue;     // a finished LP is inert: its state is never read again
#ifdef K3_CLOCKS
    clk[kPhases] += 1;
#endif
    K3_TICK(P_BARRIER);
    const bool do_refresh =
        (flags & 6) != 0 || (top > 0 && top % p.refactor_period == 0);
    if (do_refresh) {
#ifdef K3_CLOCKS
      clk[kPhases + 1] += 1;
#endif
      newton_refresh<kThreads <= kTileThreads>(L, m, ld, lane);
      K3_TICK(P_NEWTON);
      recompute(L, m, n, ld, lane);
      K3_TICK(P_RECOMPUTE);
    }

    // ---- phase-1 costs sigma (into vm) and total infeasibility ------------
    float part = 0.f;
    for (int i = lane; i < m; i += 32) {
      const float x = L.xB[i], lb = L.loB[i], ub = L.hiB[i];
      L.vm[i] = x < lb - ftol ? -1.f : (x > ub + ftol ? 1.f : 0.f);
      part += fmaxf(lb - x, 0.f) + fmaxf(x - ub, 0.f);
    }
    const float infeas = warp_sum(part);
    __syncwarp();  // publish vm
    const bool p1 = phase == 1;
    if (p1) {  // d1 = -(sigma B^-1) A, zero on basic columns
      warp_cols(L.vm, L.Binv, ld, m, m, lane, [&](int k, float acc) { L.ym[k] = acc; });
      __syncwarp();
      warp_cols(L.ym, L.A, L.lda, m, n, lane, [&](int j, float acc) {
        L.dc[j] = L.vstat[j] == BASIC ? 0.f : -acc;
      });
      __syncwarp();
    }
    const float* dcur = p1 ? L.dc : L.d;
    K3_TICK(P_DUALS);

    // ---- pricing: Dantzig (phase 1) / Devex (phase 2); Bland by stall -----
    const bool bland = noimp >= p.bland_after;
    float bs = -INFINITY;
    int bj = kIntMax, first = n;
    for (int j = lane; j < n; j += 32) {
      const int v = L.vstat[j];
      const float dj = dcur[j];
      const bool can_up = v == AT_LOWER || v == FREE;
      const bool can_dn = v == AT_UPPER || v == FREE;
      const bool elig = (can_up && dj < -p.opt_tol) || (can_dn && dj > p.opt_tol);
      // phase 1 divides by max(1, 1e-3) = 1, which is exact: skipped
      const float score =
          elig ? (p1 ? dj * dj : dj * dj / fmaxf(L.wts[j], 1e-3f)) : -INFINITY;
      if (better(score, j, bs, bj)) { bs = score; bj = j; }
      if (elig && j < first) first = j;
    }
    const int q_d = warp_argmax(bs, bj);
    const int q_b = warp_min_int(first);
    const bool found = q_b < n;
    const int q = bland ? q_b : q_d;
    K3_TICK(P_PRICING);

    bool unbounded = false;
    if (found) {
      // the entering column's bounds and cost, from global memory while
      // FTRAN runs
      const float lo_q = L.lo[q], hi_q = L.hi[q], c_q = L.c[q];
      const float dq = dcur[q];
      const float s = dq < 0.f ? 1.f : -1.f;

      // ---- FTRAN: w = B^-1 A[:, q] -----------------------------------------
      for (int i = lane; i < m; i += 32) L.vm[i] = L.A[(size_t)i * L.lda + q];
      __syncwarp();
      warp_rows(L.Binv, ld, L.vm, m, m, lane, [&](int i, float acc) { L.w[i] = acc; });
      __syncwarp();
      K3_TICK(P_FTRAN);

      // ---- ratio test (unified phase rule); ratios into pr, targets into ym
      float tmin = INFINITY;
      for (int i = lane; i < m; i += 32) {
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
      const float t_rows = warp_min_nan(tmin);
      __syncwarp();  // publish pr, ym
      const float tie_cut = t_rows * 1.0001f + 1e-6f;
      float bw = -INFINITY;
      int bi = kIntMax;
      for (int i = lane; i < m; i += 32) {
        const float v = L.pr[i] <= tie_cut ? fabsf(L.w[i]) : -INFINITY;
        if (better(v, i, bw, bi)) { bw = v; bi = i; }
      }
      const int r = warp_argmax(bw, bi);
      const float rng_q = hi_q - lo_q;
      const bool flip = rng_q <= t_rows;
      unbounded = !isfinite(min_nan(t_rows, rng_q));
      const float t = flip ? rng_q : L.pr[r];
      const float tgt_r = L.ym[r];
#ifdef K3_PROBE
      // the last iteration at this pivot count is the one that steps
      if ((long long)lp == g_probe_at[0] && niter == g_probe_at[1]) {
        for (int i = lane; i < m && i < kProbeRows; i += 32) {
          float* row = g_probe + kProbeHead + 4 * i;
          row[0] = L.xB[i];
          row[1] = L.w[i];
          row[2] = L.pr[i];
          row[3] = L.ym[i];
        }
        if (lane == 0) {
          const float head[kProbeHead] = {1.f, (float)q, (float)r, t_rows, tie_cut,
                                          flip ? 1.f : 0.f, s, rng_q, (float)phase,
                                          do_refresh ? 1.f : 0.f, bland ? 1.f : 0.f, dq};
          for (int h = 0; h < kProbeHead; ++h) g_probe[h] = head[h];
        }
      }
#endif
      K3_TICK(P_RATIO);

      if (flip && !unbounded) {
        // ---- bound flip: the entering variable crosses to its other bound --
        for (int i = lane; i < m; i += 32) L.xB[i] = L.xB[i] + t * (-s * L.w[i]);
        if (lane == 0) L.vstat[q] = L.vstat[q] == AT_LOWER ? AT_UPPER : AT_LOWER;
        __syncwarp();
        K3_TICK(P_UPDATE);
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
        __syncwarp();  // every lane holds the pre-pivot scalars
        for (int j = lane; j < m; j += 32) L.pr[j] = L.Binv[(size_t)r * ld + j] / wr;
        __syncwarp();
        // PFI rank-1 update: rows i -= (w_i - [i == r]) * pr  (row r -> ~pr);
        // lane j updates column j only, eight rows' loads in flight
        for (int j = lane; j < m; j += 32) {
          const float prj = L.pr[j];
          for (int i0 = 0; i0 < m; i0 += 8) {
            float wv[8], bv[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (i0 + u < m) {
                wv[u] = L.w[i0 + u];
                bv[u] = L.Binv[(size_t)(i0 + u) * ld + j];
              }
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int i = i0 + u;
              if (i < m) {
                const float wi = wv[u] - (i == r ? 1.f : 0.f);
                L.Binv[(size_t)i * ld + j] = bv[u] - wi * prj;
              }
            }
          }
        }
        for (int i = lane; i < m; i += 32)
          L.xB[i] = i == r ? x_enter : L.xB[i] + t * (-s * L.w[i]);
        K3_TICK(P_UPDATE);
        if (!p1) {
          // phase-2 incremental reduced costs and Devex weights from the
          // pivot row alpha = wr * (pr A) = (old B^-1)_r A
          const float rd = dq / wr;
          const bool reset = gq > 1e6f;
          warp_cols(L.pr, L.A, L.lda, m, n, lane, [&](int j, float acc) {
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
        __syncwarp();
        if (lane == 0) {
          L.basis[r] = q;
          L.loB[r] = lo_q;
          L.hiB[r] = hi_q;
          L.cB[r] = c_q;
          L.vstat[lv] = lstat;
          L.vstat[q] = BASIC;
        }
        __syncwarp();
        K3_TICK(P_ROW);
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
    if (status == RUNNING && niter >= p.max_iter) status = MAX_ITER;

    // ---- phase-1 stall counter ---------------------------------------------
    const bool improved = infeas < best - 1e-6f;
    noimp = p1 ? (improved ? 0 : noimp + 1) : 0;
    best = p1 ? min_nan(best, infeas) : best;
    K3_TICK(P_STATUS);
  }
  if (status == RUNNING) status = MAX_ITER;
  __syncwarp();
  for (int i = lane; i < m; i += 32) L.out[i] = L.basis[i];
  for (int j = lane; j < n; j += 32) L.out[m + j] = L.vstat[j];
  if (lane == 0) {
    L.out[m + n] = status;
    L.out[m + n + 1] = niter;
  }
#ifdef K3_CLOCKS
  if (lane == 0)
    for (int ph = 0; ph < kPhases + 2; ++ph)
      atomicAdd(&g_clocks[ph], (unsigned long long)clk[ph]);
#endif
}

template <int kThreads, int kLayout>
cudaError_t launch(const float* A, const float* b, const float* c, const float* lo,
                   const float* hi, int* out, float* ws, int packs, size_t smem,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(packed_kernel<kThreads, kLayout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  packed_kernel<kThreads, kLayout><<<packs, p.k * 32, smem, stream>>>(A, b, c, lo, hi, out,
                                                                      ws, p);
  return cudaGetLastError();
}

template <int kThreads>
cudaError_t launch_layout(int layout, const float* A, const float* b, const float* c,
                          const float* lo, const float* hi, int* out, float* ws, int packs,
                          size_t smem, const Params& p, cudaStream_t stream) {
  switch (layout) {
    case STAGED:
      return launch<kThreads, STAGED>(A, b, c, lo, hi, out, ws, packs, smem, p, stream);
    case SHARED:
      return launch<kThreads, SHARED>(A, b, c, lo, hi, out, ws, packs, smem, p, stream);
    default:
      return launch<kThreads, GLOBAL>(A, b, c, lo, hi, out, ws, packs, smem, p, stream);
  }
}

}  // namespace

extern "C" {

// Floats of workspace one LP of a pack of k needs in `layout`: B^-1 and the
// Newton temporaries (m x m of row stride m | 1), eight m-vectors, three
// n-vectors, the basis and statuses (m + n ints), and for STAGED the copy
// of A (m rows of stride n | 1).
size_t packed_simplex_workspace_floats(int layout, int k, int m, int n) {
  size_t f = (size_t)(1 + newton_temps(k, m)) * m * row_stride(m) + 9 * (size_t)m +
             4 * (size_t)n;
  if (layout == STAGED) f += (size_t)m * (n | 1);
  return f;
}

// 1 when a pack of k LPs can run in `layout` (0 STAGED, 1 SHARED, 2 GLOBAL):
// GLOBAL always, the others when the pack's workspace fits the block's
// shared memory.
int packed_simplex_layout_fits(int layout, int k, int m, int n) {
  if (layout == GLOBAL) return 1;
  if (layout != STAGED && layout != SHARED) return 0;
  return (size_t)k * packed_simplex_workspace_floats(layout, k, m, n) * sizeof(float) <=
         kSmemBudget;
}

// Dynamic shared memory of one block in `layout`, in bytes.
size_t packed_simplex_smem_bytes(int layout, int k, int m, int n) {
  return layout == GLOBAL ? 0
                          : (size_t)k * packed_simplex_workspace_floats(layout, k, m, n) *
                                sizeof(float);
}

// Launch K3 on `stream` for `packs` packs of k LPs in `layout`.  A (packs,
// k * m, n), b (packs, k, m), c/lo/hi (packs, k, n), all f32.  out (packs,
// k, m + n + 2) i32 receives [basis | vstat | status | niter] per LP.  ws is
// null unless the layout is GLOBAL, where it holds packs * k *
// packed_simplex_workspace_floats(GLOBAL, k, m, n) floats.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a layout that does
// not fit); does not synchronise.
int packed_simplex_launch(const float* A, const float* b, const float* c,
                          const float* lo, const float* hi, int* out, float* ws,
                          int packs, int k, int m, int n, int layout, int slack0,
                          int max_iter, int refactor_period, float feas_tol, float opt_tol,
                          float pivot_tol, int bland_after, void* stream) {
  if (k < 1 || k > kMaxPack || m < 1 || n < m || refactor_period < 1 ||
      !packed_simplex_layout_fits(layout, k, m, n))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((layout == GLOBAL) != (ws != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (packs == 0) return 0;
  Params p;
  p.k = k;
  p.m = m;
  p.n = n;
  p.ld = row_stride(m);
  p.slack0 = slack0;
  p.max_iter = max_iter;
  p.refactor_period = refactor_period;
  p.bland_after = bland_after;
  p.ws_stride = packed_simplex_workspace_floats(layout, k, m, n);
  p.feas_tol = feas_tol;
  p.opt_tol = opt_tol;
  p.pivot_tol = pivot_tol;
  const size_t smem = packed_simplex_smem_bytes(layout, k, m, n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      k * 32 <= kTileThreads
          ? launch_layout<kTileThreads>(layout, A, b, c, lo, hi, out, ws, packs, smem, p, s)
          : launch_layout<kMaxPack * 32>(layout, A, b, c, lo, hi, out, ws, packs, smem, p, s);
  return static_cast<int>(err);
}

const char* packed_simplex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef K3_CLOCKS
// Copy the phase cycle sums (kPhases + 2 values: P_BARRIER .. P_STATUS, then
// the iterations they cover and their refreshes) into `host` and zero them.
// Synchronises.
int packed_simplex_clocks(unsigned long long* host) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks));
  const unsigned long long zero[kPhases + 2] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

#ifdef K3_PROBE
// Record the ratio test of LP `lp` (its index in the launch) at the step
// taken with `niter` pivots done, in the launches that follow; clears the
// record.  Synchronises.
int packed_simplex_probe_at(long long lp, long long niter) {
  const long long at[2] = {lp, niter};
  const float zero[kProbeHead + 4 * kProbeRows] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_probe_at, at, sizeof(at));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return static_cast<int>(err);
}

// Copy the record (kProbeHead + 4 * kProbeRows floats) into `host`.
// Synchronises.
int packed_simplex_probe_read(float* host) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
