// The f64 certificate, state and B^-1 of ONE LP's final basis, in CUDA C++
// for Hopper (sm_90a), over one cooperative grid.
//
// Replaces host numpy and SciPy, not a Pallas kernel: the single-LP routes
// of the JAX package check every answer on the host (`_verify_f64`,
// minilp_tpu/ops/kernels/batched_simplex.py:555, on one LP;
// `EngineHandle._certify_timed`, `_state_from_certified_basis` and
// `ensure_binv`, minilp_tpu/engine/driver.py; `_exact_host_inverse`,
// minilp_tpu/engine/incremental.py), because the TPU's f64 LU does not
// compile.  The H100 has native f64, so a card solve does it here, once per
// basis: from (basis, vstat) of an LP A (m x n), b, c, lo, hi it computes
//   x_N from vstat (AT_LOWER and FIXED -> lo, AT_UPPER -> hi, else 0),
//   rhs = b - A x_N, B = A[:, basis] and its LU with partial pivoting
//   (LAPACK's rule: the first row of largest |u_ik|, rows swapped whole),
//   B x_B = rhs, B^T y = c_B, d = c - A^T y, pfeas (x_B within its bounds)
//   and dfeas (d's sign at each nonbasic status), both at `tol`,
//   obj = c_B . x_B + c . x_N, x = x_N with x_B scattered into it,
//   `singular` on an exact zero pivot or a basis that repeats a column,
//   and on request the dense B^-1, row by row (B^T w = e_i), or one row of it.
// inf and NaN flow as in numpy (0 * inf is NaN; a NaN fails every check).
// Every product, sum and quotient is f64 through __dmul_rn / __dadd_rn /
// __dsub_rn / __ddiv_rn (no FMA), and every sum runs in one fixed order,
// so the bits do not depend on the grid's size: blocks = 1 and the full
// grid give the same output.
//
// Mapping (G blocks of kThreads, all resident; simplex_grid.cuh's
// grid_sync between phases):
//  1. grid-strided: x = x_N, B gathered column-major into the workspace
//     (LU[k * m + i] = B(i, k)), c_B, the count of each basis column, and
//     rhs a warp a row (lanes in strides of 32, then a fixed xor tree);
//  2. the LU, right-looking, column j owned by block j % G.  Step k: every
//     block reads the pivot row p of column k (found in step k - 1), the
//     multipliers l_i = B(i, k) / B(p, k) into shared memory (row p takes
//     row k's value: the swap), swaps rows k and p on its columns left of
//     k (laswp), and updates its columns right of k:
//     B(i, j) -= l_i * B(p, j) with rows k and p exchanged.  The owner of
//     column k + 1 updates that column first and picks its pivot (a block
//     reduction that keeps the first index of the largest |value|), so a
//     step ends on ONE grid barrier.  Column k's own multipliers are
//     written back by its owner at the start of step k + 1, when no block
//     reads column k any longer;
//  3. B x_B = rhs on block 0 (the swaps as one permutation, L forward and U
//     back, a thread a row, one block barrier a step) while block 1 solves
//     B^T y = c_B (U^T forward and L^T back as dot products over the
//     column, each a fixed block reduction);
//  4. d a thread a column (its sum over the rows in index order), dfeas by
//     an atomic OR of each block's violations; B^-1 a warp a row: U^T s =
//     e_i forward from row i, L^T v = s back, w = P^T v, each step a dot
//     over a column of the LU (lane-strided, then the xor tree); one row
//     alone on request, with the same bits as in the whole inverse;
//  5. block 0 writes obj and the flags.
//
// What bounds it on an H100: the LU's 2m^3/3 flops (at m = 3136, 20.6
// GFLOP: 0.31 ms at the FP64 tensor-core peak) and its trailing-update
// traffic, m^3/3 elements read and written (at m = 3136 about 164 GB, most
// of it from HBM since B alone is 79 MB, about 50 ms at 3.35 TB/s; at m =
// 824 3 GB, L2-resident); then m grid barriers (a few us each) and the
// triangular solves' chains of m dependent steps.  This design is the
// simple one: no blocked panels, no DMMA, no TMA.

#include "simplex_grid.cuh"

namespace {

// scalars at the end of the packed output
enum { OUT_OBJ = 0, OUT_PFEAS, OUT_DFEAS, OUT_SINGULAR, OUT_VERIFIED, kScalars };
// int words the launch zeroes: a violation of dfeas seen by some block
enum { F_BAD_D = 0, kFlags };
// elements a thread of the trailing update loads before it stores
constexpr int kIlp = 8;

struct Params {
  const double* A;  // (m, n) row-major
  const double* b;
  const double* c;
  const double* lo;
  const double* hi;
  const int* basis;
  const int* vstat;
  double* out;   // [x (n) | d (n) | x_B (m) | y (m) | kScalars]
  double* Binv;  // null, or (m, m) row-major; one row when binv_row >= 0
  int binv_row;  // -1: every row of B^-1; else only this one
  double* LU;    // (m, m) column-major workspace
  int* piv;      // m: the pivot row of each step
  int* count;    // n: how often each column is basic (zeroed by the launch)
  int* flags;    // kFlags (zeroed by the launch)
  Ctl* ctl;
  int m, n, cols, status;  // cols: the most columns one block owns
  double tol;
};

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ double nonbasic(int v, double l, double h) {
  return (v == AT_LOWER || v == FIXED) ? l : v == AT_UPPER ? h : 0.0;
}

// The sum of a warp's 32 values by a fixed xor tree; every lane gets the
// same bits (a + b and b + a round alike).
__device__ __forceinline__ double warp_sum(double s) {
  for (int off = 16; off > 0; off >>= 1) s = add(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// The block's sum: each warp's tree, then the warp partials in warp order,
// in every thread.  Starts with a barrier that protects `red` from the
// previous call's readers.
__device__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = red[0];
  for (int w = 1; w < kWarps; ++w) s = add(s, red[w]);
  return s;
}

// The first index i in [k, m) of the largest |col[i]| (a NaN never wins; an
// all-NaN column keeps row k), in every thread of the block.
__device__ int pivot_row(const double* col, int k, int m, double* red_v, int* red_i) {
  double best = -1.0;  // below every |value|
  int at = -1;
  for (int i = k + threadIdx.x; i < m; i += kThreads) {
    const double v = fabs(col[i]);
    if (v > best) best = v, at = i;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, best, off);
    const int oa = __shfl_xor_sync(kFull, at, off);
    if (ov > best || (ov == best && oa < at)) best = ov, at = oa;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red_v[threadIdx.x >> 5] = best, red_i[threadIdx.x >> 5] = at;
  __syncthreads();
  best = red_v[0];
  at = red_i[0];
  for (int w = 1; w < kWarps; ++w)
    if (red_v[w] > best || (red_v[w] == best && red_i[w] < at)) best = red_v[w], at = red_i[w];
  return at < 0 ? k : at;
}

// The first index >= from that is congruent to `lane` modulo `stride`.
__device__ __forceinline__ int first_from(int from, int lane, int stride) {
  return from + ((lane - from) % stride + stride) % stride;
}

__global__ void __launch_bounds__(kThreads) basis_kernel(Params p) {
  extern __shared__ double smem[];
  __shared__ double red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int m = p.m, n = p.n, G = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gtid = rank * kThreads + tid, gthreads = G * kThreads;
  const int gwarp = rank * kWarps + warp, gwarps = G * kWarps;
  double* l = smem;                // m: a step's multipliers; a solve's vector
  double* u = l + m;               // cols: row p of the block's columns right of k
  double* ak = u + p.cols;         // cols: row k of the same columns
  int* perm = reinterpret_cast<int*>(ak + p.cols);  // m: the original row at each position
  double* x = p.out;
  double* d = x + n;
  double* xB = d + n;  // rhs, then x_B
  double* y = xB + m;  // c_B, then y
  double* sc = y + m;
  double* LU = p.LU;
  const double tol = p.tol;
  auto valid = [n](int j) { return j >= 0 && j < n; };

  // ---- 1. x_N, B, c_B, the basis counts, rhs ------------------------------
  for (int j = gtid; j < n; j += gthreads) x[j] = nonbasic(p.vstat[j], p.lo[j], p.hi[j]);
  // B: an index outside [0, n) gathers a zero column; kIlp loads in flight
  for (size_t e0 = gtid; e0 < (size_t)m * m; e0 += (size_t)kIlp * gthreads) {
    double v[kIlp];
#pragma unroll
    for (int q = 0; q < kIlp; ++q) {
      const size_t e = e0 + (size_t)q * gthreads;
      v[q] = 0.0;
      if (e < (size_t)m * m) {
        const int k = (int)(e / m), i = (int)(e - (size_t)k * m), j = p.basis[k];
        if (valid(j)) v[q] = __ldg(&p.A[(size_t)i * n + j]);
      }
    }
#pragma unroll
    for (int q = 0; q < kIlp; ++q) {
      const size_t e = e0 + (size_t)q * gthreads;
      if (e < (size_t)m * m) LU[e] = v[q];
    }
  }
  for (int k = gtid; k < m; k += gthreads) {
    const int j = p.basis[k];
    y[k] = valid(j) ? p.c[j] : 0.0;
    if (valid(j)) atomicAdd(&p.count[j], 1);
  }
  for (int i = gwarp; i < m; i += gwarps) {
    double s = 0.0;
    for (int j = lane; j < n; j += 32)
      s = add(s, mul(p.A[(size_t)i * n + j], nonbasic(p.vstat[j], p.lo[j], p.hi[j])));
    s = warp_sum(s);
    if (lane == 0) xB[i] = sub(p.b[i], s);
  }
  for (int i = tid; i < m; i += kThreads) perm[i] = i;
  grid_sync(p.ctl, G);

  // ---- 2. the LU ------------------------------------------------------------
  // a basis that repeats a column is singular; every block reads the same
  // counts and so takes the same branch
  int rep = 0;
  for (int k = tid; k < m; k += kThreads) {
    const int j = p.basis[k];
    rep |= valid(j) && p.count[j] > 1;
  }
  bool singular = __syncthreads_or(rep);
  if (!singular) {
    if (rank == 0) {
      const int r = pivot_row(LU, 0, m, red_v, red_i);
      if (tid == 0) p.piv[0] = r;
    }
    grid_sync(p.ctl, G);
  }
  double pv_prev = 0.0;
  for (int k = 0; k < m && !singular; ++k) {
    const double* colk = LU + (size_t)k * m;
    const int pr = p.piv[k];
    const double pv = colk[pr], a_kk = colk[k];
    if (pv == 0.0) {  // an exact zero pivot: every block sees it
      singular = true;
      break;
    }
    // column k - 1's multipliers (still in l) and its diagonal
    if (k > 0 && (k - 1) % G == rank) {
      double* col = LU + (size_t)(k - 1) * m;
      for (int i = k + tid; i < m; i += kThreads) col[i] = l[i];
      if (tid == 0) col[k - 1] = pv_prev;
    }
    if (tid == 0 && pr != k) {
      const int t = perm[k];
      perm[k] = perm[pr];
      perm[pr] = t;
    }
    __syncthreads();
    if (pr != k) {  // rows k and pr of the block's columns left of k (L)
      for (int j = first_from(0, rank, G) + tid * G; j < k; j += kThreads * G) {
        double* col = LU + (size_t)j * m;
        const double t = col[k];
        col[k] = col[pr];
        col[pr] = t;
      }
    }
    for (int i = k + 1 + tid; i < m; i += kThreads) l[i] = quo(i == pr ? a_kk : colk[i], pv);
    // the block's columns right of k: j0, j0 + G, ...
    const int j0 = first_from(k + 1, rank, G);
    const int ncols = j0 < m ? (m - j0 + G - 1) / G : 0;
    for (int s = tid; s < ncols; s += kThreads) {
      const double* col = LU + (size_t)(j0 + s * G) * m;
      u[s] = col[pr];
      ak[s] = col[k];
    }
    __syncthreads();
    const int len = m - k - 1;
    // the trailing update of slots [s0, s1): B(i, j) -= l_i u_j for i > k,
    // row pr taking row k's old value; row k takes u.  Each thread loads
    // kIlp elements before it stores any (independent loads in flight).
    auto update = [&](int s0, int s1) {
      const unsigned L = (unsigned)len, total = (unsigned)(s1 - s0) * L;
      for (unsigned e0 = tid; e0 < total; e0 += kIlp * kThreads) {
        double v[kIlp], lv[kIlp], uv[kIlp];
        double* at[kIlp];
#pragma unroll
        for (int q = 0; q < kIlp; ++q) {
          const unsigned e = e0 + q * kThreads;
          at[q] = nullptr;
          if (e < total) {
            const int s = s0 + (int)(e / L), i = k + 1 + (int)(e % L);
            double* col = LU + (size_t)(j0 + s * G) * m;
            at[q] = col + i;
            v[q] = i == pr ? ak[s] : col[i];
            lv[q] = l[i];
            uv[q] = u[s];
          }
        }
#pragma unroll
        for (int q = 0; q < kIlp; ++q)
          if (at[q] != nullptr) *at[q] = sub(v[q], mul(lv[q], uv[q]));
      }
      for (int s = s0 + tid; s < s1; s += kThreads) LU[(size_t)(j0 + s * G) * m + k] = u[s];
    };
    if (ncols > 0 && j0 == k + 1) {
      // the next pivot column first, then its pivot
      update(0, 1);
      __syncthreads();
      const int r = pivot_row(LU + (size_t)(k + 1) * m, k + 1, m, red_v, red_i);
      if (tid == 0) p.piv[k + 1] = r;
      update(1, ncols);
    } else {
      update(0, ncols);
    }
    pv_prev = pv;
    grid_sync(p.ctl, G);
  }

  // ---- 3. B x_B = rhs (block 0) and B^T y = c_B (block 1 % G) ---------------
  double* z = l;
  if (rank == 0) {
    if (singular) {
      for (int k = tid; k < m; k += kThreads) xB[k] = 0.0;
    } else {
      for (int k = tid; k < m; k += kThreads) z[k] = xB[perm[k]];  // P rhs
      for (int k = 0; k < m; ++k) {  // L (unit) forward, thread i % kThreads owns z[i]
        __syncthreads();
        const double zk = z[k];
        const double* col = LU + (size_t)k * m;
        for (int i = first_from(k + 1, tid, kThreads); i < m; i += kThreads)
          z[i] = sub(z[i], mul(col[i], zk));
      }
      for (int k = m - 1; k >= 0; --k) {  // U back; z[k] is final at step k
        __syncthreads();
        const double* col = LU + (size_t)k * m;
        const double xk = quo(z[k], col[k]);
        for (int i = tid; i < k; i += kThreads) z[i] = sub(z[i], mul(col[i], xk));
        if (tid == 0) xB[k] = xk;
      }
    }
    __syncthreads();
    // pfeas; x_B scattered into x (a repeated index is singular: all zeros);
    // obj = c_B . x_B + c . x_N
    int good = 1;
    double s1 = 0.0, s2 = 0.0;
    for (int k = tid; k < m; k += kThreads) {
      const int j = p.basis[k];
      const double loB = valid(j) ? p.lo[j] : 0.0, hiB = valid(j) ? p.hi[j] : 0.0;
      good &= xB[k] >= sub(loB, tol) && xB[k] <= add(hiB, tol);
      s1 = add(s1, mul(valid(j) ? p.c[j] : 0.0, xB[k]));
    }
    for (int j = tid; j < n; j += kThreads)
      s2 = add(s2, mul(p.c[j], nonbasic(p.vstat[j], p.lo[j], p.hi[j])));
    good = __syncthreads_and(good);
    s1 = block_sum(s1, red_v);
    s2 = block_sum(s2, red_v);
    if (tid == 0) {
      for (int k = 0; k < m; ++k) {
        const int j = p.basis[k];
        if (valid(j)) x[j] = xB[k];
      }
      sc[OUT_OBJ] = add(s1, s2);
      sc[OUT_PFEAS] = good ? 1.0 : 0.0;
    }
  }
  if (rank == (G > 1 ? 1 : 0)) {
    if (singular) {
      for (int k = tid; k < m; k += kThreads) y[k] = 0.0;
    } else {
      for (int k = 0; k < m; ++k) {  // U^T forward: z_k = (c_B,k - sum_{i<k} U(i,k) z_i) / U(k,k)
        const double* col = LU + (size_t)k * m;
        double s = 0.0;
        for (int i = tid; i < k; i += kThreads) s = add(s, mul(col[i], z[i]));
        s = block_sum(s, red_v);
        if (tid == k % kThreads) z[k] = quo(sub(y[k], s), col[k]);
      }
      for (int k = m - 1; k >= 0; --k) {  // L^T back: z_k -= sum_{i>k} L(i,k) z_i
        const double* col = LU + (size_t)k * m;
        double s = 0.0;
        for (int i = first_from(k + 1, tid, kThreads); i < m; i += kThreads)
          s = add(s, mul(col[i], z[i]));
        s = block_sum(s, red_v);
        if (tid == k % kThreads) z[k] = sub(z[k], s);
      }
      __syncthreads();
      for (int k = tid; k < m; k += kThreads) y[perm[k]] = z[k];  // y = P^T v
    }
  }
  grid_sync(p.ctl, G);

  // ---- 4. d and dfeas; B^-1 ---------------------------------------------------
  for (int i = tid; i < m; i += kThreads) l[i] = y[i];
  __syncthreads();
  int bad = 0;
  for (int j = gtid; j < n; j += gthreads) {
    double s = 0.0;
    for (int i = 0; i < m; ++i) s = add(s, mul(p.A[(size_t)i * n + j], l[i]));
    const double dj = sub(p.c[j], s);
    d[j] = dj;
    const int v = p.vstat[j];
    if (v == AT_LOWER) bad |= !(dj >= -tol);
    else if (v == AT_UPPER) bad |= !(dj <= tol);
    else if (v == FREE) bad |= !(fabs(dj) <= tol);
  }
  if (__syncthreads_or(bad) && tid == 0) atomicOr(&p.flags[F_BAD_D], 1);
  if (p.Binv != nullptr && !singular) {
    // row i of B^-1 solves B^T w = e_i: U^T s = e_i (s_k = 0 below i),
    // L^T v = s, w[perm[k]] = v_k.  s and v live in the row itself at
    // perm[k]; lane (k - i) mod 32 owns index k, so each lane reads back
    // only what it wrote.
    const int r0 = p.binv_row < 0 ? 0 : p.binv_row, r1 = p.binv_row < 0 ? m : r0 + 1;
    for (int i = r0 + gwarp; i < r1; i += gwarps) {
      double* row = p.Binv + (size_t)(i - r0) * m;
      for (int k = i; k < m; ++k) {
        const double* col = LU + (size_t)k * m;
        double s = 0.0;
        for (int q = i + lane; q < k; q += 32) s = add(s, mul(col[q], row[perm[q]]));
        s = warp_sum(s);
        if (lane == (k - i) % 32) row[perm[k]] = quo(sub(k == i ? 1.0 : 0.0, s), col[k]);
      }
      for (int k = m - 1; k >= 0; --k) {
        const double* col = LU + (size_t)k * m;
        double s = 0.0;
        for (int q = first_from(k + 1, (i + lane) % 32, 32); q < m; q += 32)
          s = add(s, mul(col[q], row[perm[q]]));
        s = warp_sum(s);
        if (lane == (((k - i) % 32) + 32) % 32) row[perm[k]] = sub(k >= i ? row[perm[k]] : 0.0, s);
      }
    }
  }
  grid_sync(p.ctl, G);

  // ---- 5. the flags -----------------------------------------------------------
  if (rank == 0 && tid == 0) {
    const bool dfeas = p.flags[F_BAD_D] == 0;
    const bool pfeas = sc[OUT_PFEAS] != 0.0;
    sc[OUT_DFEAS] = dfeas ? 1.0 : 0.0;
    sc[OUT_SINGULAR] = singular ? 1.0 : 0.0;
    sc[OUT_VERIFIED] = (pfeas && dfeas && !singular && p.status == OPTIMAL) ? 1.0 : 0.0;
  }
}

inline int owned_cols(int m, int blocks) { return (m + blocks - 1) / blocks; }

inline size_t smem_bytes(int m, int cols) {
  return (size_t)(m + 2 * cols) * sizeof(double) + (size_t)m * sizeof(int);
}

// workspace: LU (m * m doubles) | Ctl | flags | count (n) | piv (m)
inline size_t zeroed_bytes(int n) { return sizeof(Ctl) + (size_t)(kFlags + n) * sizeof(int); }

inline size_t workspace_bytes(int m, int n) {
  return (size_t)m * m * sizeof(double) + zeroed_bytes(n) + (size_t)m * sizeof(int);
}

}  // namespace

extern "C" {

// Bytes of workspace of a launch at (m, n).
size_t basis_f64_workspace_bytes(int m, int n) { return workspace_bytes(m, n); }

// Dynamic shared memory of one block of a launch of `blocks` at m rows.
size_t basis_f64_smem_bytes(int m, int blocks) { return smem_bytes(m, owned_cols(m, blocks)); }

// What bounds the grid: the SM count, and how many blocks of the kernel one
// SM holds with the shared memory of a launch of `blocks` at m rows.
// Returns a cudaError_t, cudaErrorNotSupported without cooperative launch.
int basis_f64_grid_limits(int m, int blocks, int* sm_count, int* per_sm) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = basis_f64_smem_bytes(m, blocks);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(basis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, basis_kernel, kThreads, smem);
  return static_cast<int>(err);
}

// The certificate of one LP on `stream`, as one cooperative grid of
// `blocks` blocks (1 to kMaxGrid, all resident: at most
// basis_f64_grid_limits' sm_count x per_sm).  A (m, n), b (m), c/lo/hi (n)
// f64; basis (m), vstat (n) int32; all C order.  out holds 2n + 2m +
// kScalars doubles ([x | d | x_B | y | obj, pfeas, dfeas, singular,
// verified]); Binv is null, or (m, m) doubles, row-major, with binv_row
// = -1, or row binv_row of B^-1 (m doubles) with 0 <= binv_row < m; ws holds
// basis_f64_workspace_bytes(m, n) bytes.  The results do not depend on
// `blocks`.  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a shape it does not take); does not synchronise.
int basis_f64_launch(const double* A, const double* b, const double* c, const double* lo,
                     const double* hi, const int* basis, const int* vstat, int status, double tol,
                     double* out, double* Binv, int binv_row, void* ws, int m, int n,
                     int blocks, void* stream) {
  if (m < 1 || n < m || blocks < 1 || blocks > kMaxGrid || binv_row < -1 || binv_row >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* w = static_cast<char*>(ws);
  Params p;
  p.A = A;
  p.b = b;
  p.c = c;
  p.lo = lo;
  p.hi = hi;
  p.basis = basis;
  p.vstat = vstat;
  p.out = out;
  p.Binv = Binv;
  p.binv_row = binv_row;
  p.LU = reinterpret_cast<double*>(w);
  p.ctl = reinterpret_cast<Ctl*>(w + (size_t)m * m * sizeof(double));
  p.flags = reinterpret_cast<int*>(p.ctl + 1);
  p.count = p.flags + kFlags;
  p.piv = p.count + n;
  p.m = m;
  p.n = n;
  p.cols = owned_cols(m, blocks);
  p.status = status;
  p.tol = tol;
  cudaError_t err = cudaMemsetAsync(p.ctl, 0, zeroed_bytes(n), st);
  const size_t smem = smem_bytes(m, p.cols);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(basis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)basis_kernel, dim3(blocks), dim3(kThreads), args, smem,
                                    st);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

const char* basis_f64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
