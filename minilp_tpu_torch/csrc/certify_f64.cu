// The f64 certificate of a batch of LP bases, in CUDA C++ for Hopper (sm_90a).
//
// Replaces the host numpy check `_verify_f64`
// (minilp_tpu/ops/kernels/batched_simplex.py:555, copied into the port's
// batched_simplex.py), not a Pallas kernel: the JAX package ran it on the
// host because the TPU's f64 linear algebra neither compiled quickly nor, at
// some shapes, correctly.  K1 (batch mode) and K3 find each LP's final basis
// in f32; the basis is combinatorial, so this kernel recomputes each lane's
// answer exactly in f64, as `_verify_f64` does:
//   B = A[:, basis]; x_N from vstat (AT_LOWER and FIXED -> lo, AT_UPPER ->
//   hi, BASIC and FREE -> 0); rhs = b - A x_N; an LU of B with partial
//   pivoting; B x_B = rhs and B^T y = c_B; d = c - A^T y; pfeas: x_B within
//   [lo - 1e-7, hi + 1e-7]; dfeas: d >= -1e-7 at lower, d <= 1e-7 at upper,
//   |d| <= 1e-7 free; obj = c_B . x_B + c . x_N; ok = pfeas & dfeas &
//   status == OPTIMAL & !singular; x = x_N with x_B scattered into it.
// Semantics kept from numpy and LAPACK: the pivot of column k is the first
// row of largest |u_ik| (idamax); a singular lane gets x_B = y = 0; inf and
// NaN flow through the arithmetic as in numpy (0 * inf is NaN, every product
// of A x_N and A^T y is taken, and a NaN fails every comparison).  Every
// product, sum and quotient is f64 through __dmul_rn / __dadd_rn / __dsub_rn
// / __ddiv_rn, so none is fused into an FMA and both layouts below give the
// same bits.
// The deviation, recorded: an exact zero pivot marks ITS lane singular.
// numpy's batched solve raises for the whole batch, and the host check then
// fails every lane.  A basis that repeats a column is singular as such, and
// an index outside [0, n) reads a zero column (numpy raises IndexError).
//
// Mapping: one thread block of 256 threads per lane (grid = batch).  x_N,
// the gathered B and c_B are written by all threads; rhs takes a warp per
// row over n (lanes in strides of 32, then a fixed xor tree).  The LU runs
// m steps, each a pivot search, row swap and multiplier column on warp 0,
// a barrier, the trailing rank-1 update over all threads, a barrier.  Then
// warp 0 solves B x_B = rhs (the swaps, L forward, U back) while warp 1
// solves B^T y = c_B (U^T forward, L^T back, the swaps in reverse), each
// column by column with __syncwarp between steps, so every element's sum
// runs in index order.  d takes a thread per column, its sum over i in
// order.  The checks fold through __syncthreads_and, obj's two sums on warp
// 0 with the same xor tree.
//
// What bounds it on an H100: at the bench's batch (1024 lanes of 32 x 128)
// the bytes, A read once (33.5 MB) with the vectors and x, take about 11 us
// at 3.35 TB/s; the flops (2m^3/3 for the LU, 4m^2 for the solves, 4mn for
// rhs and d, 43 MFLOP in all) under 1 us.  What bounds it in practice is
// latency: the LU's 2m block barriers and the solves' chains of 2m
// dependent steps on one warp.  So the workspace sits in shared memory
// where it fits.  Two layouts, picked by size on the host
// (`certify_f64_layout_fits`), never as a fallback on failure:
//  - SHARED: the LU (m rows of stride m | 1, odd in 8-byte words, so a warp
//    reading a column touches each bank pair once per half-warp), x_N, rhs
//    / x_B, c_B / y and the pivots in dynamic shared memory (m <= ~160 at
//    227 KB);
//  - GLOBAL: the same workspace per lane in global memory.
// Both run one template in one order of operations.  Several lanes per
// block and DMMA for the trailing updates are later steps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// one block's opt-in shared memory on sm_90 (227 KB), less room for the
// static shared memory
constexpr size_t kSmemBudget = 232448 - 1024;
constexpr double kTol = 1e-7;           // `_verify_f64`'s tolerance
constexpr int kOptimal = 1;             // Status.OPTIMAL
enum { AT_LOWER = 0, AT_UPPER = 1, FREE = 2, FIXED = 3, BASIC = 4 };  // VarStat
enum { SHARED = 0, GLOBAL = 1 };

inline int row_stride(int m) { return m | 1; }

// Doubles of workspace per lane: the LU (m x (m | 1)), x_N (n), rhs / x_B
// (m), c_B / y (m), and the m int pivots in (m + 1) / 2 doubles.
inline size_t workspace_doubles(int m, int n) {
  return (size_t)m * row_stride(m) + n + 2 * (size_t)m + (m + 1) / 2;
}

struct Params {
  int m, n, ld;
  size_t ws_stride;  // doubles per lane of the GLOBAL workspace
};

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// The sum of a warp's 32 values by a fixed xor tree; every lane gets the
// same bits (a + b and b + a round alike).
__device__ __forceinline__ double warp_sum(double s) {
  for (int off = 16; off > 0; off >>= 1) s = add(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
certify_kernel(const double* __restrict__ A, const double* __restrict__ b,
               const double* __restrict__ c, const double* __restrict__ lo,
               const double* __restrict__ hi, const int* __restrict__ basis,
               const int* __restrict__ vstat, const int* __restrict__ status,
               double* __restrict__ obj, unsigned char* __restrict__ verified,
               double* __restrict__ x, double* ws_global, Params p) {
  extern __shared__ double smem[];
  __shared__ int s_singular;
  const int m = p.m, n = p.n, ld = p.ld;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t l = blockIdx.x;
  double* ws = kShared ? smem : ws_global + l * p.ws_stride;
  double* LU = ws;
  double* xN = LU + (size_t)m * ld;
  double* r = xN + n;  // rhs, then x_B
  double* y = r + m;   // c_B, then y
  int* piv = reinterpret_cast<int*>(y + m);
  const double* Al = A + l * m * n;
  const double* cl = c + l * n;
  const double* lol = lo + l * n;
  const double* hil = hi + l * n;
  const int* bas = basis + l * m;
  const int* vs = vstat + l * n;
  auto valid = [n](int j) { return j >= 0 && j < n; };

  // x_N, B = A[:, basis] and c_B; a basis that repeats a column is singular
  for (int j = tid; j < n; j += kThreads) {
    const int v = vs[j];
    xN[j] = (v == AT_LOWER || v == FIXED) ? lol[j] : v == AT_UPPER ? hil[j] : 0.0;
  }
  for (int e = tid; e < m * m; e += kThreads) {
    const int i = e / m, k = e - i * m, j = bas[k];
    LU[i * ld + k] = valid(j) ? Al[(size_t)i * n + j] : 0.0;
  }
  int repeated = 0;
  for (int k = tid; k < m; k += kThreads) {
    const int j = bas[k];
    y[k] = valid(j) ? cl[j] : 0.0;
    for (int k2 = 0; k2 < k; ++k2) repeated |= bas[k2] == j;
  }
  if (tid == 0) s_singular = 0;
  repeated = __syncthreads_or(repeated);
  if (repeated && tid == 0) s_singular = 1;

  // rhs = b - A x_N: a warp per row
  for (int i = warp; i < m; i += kWarps) {
    double s = 0.0;
    for (int j = lane; j < n; j += 32) s = add(s, mul(Al[(size_t)i * n + j], xN[j]));
    s = warp_sum(s);
    if (lane == 0) r[i] = sub(b[l * m + i], s);
  }
  __syncthreads();

  // LU with partial pivoting.  s_singular is written (to 1 only) by warp 0
  // before the step's first barrier and read by every thread after it.
  for (int k = 0; k < m; ++k) {
    if (warp == 0) {
      double best = -1.0;  // below every |u|; a NaN never wins
      int at = -1;
      for (int i = k + lane; i < m; i += 32) {
        const double v = fabs(LU[i * ld + k]);
        if (v > best) best = v, at = i;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double ov = __shfl_xor_sync(kFull, best, off);
        const int oa = __shfl_xor_sync(kFull, at, off);
        if (ov > best || (ov == best && oa < at)) best = ov, at = oa;
      }
      const int pr = at < 0 ? k : at;  // an all-NaN column keeps row k
      const double pv = LU[pr * ld + k];
      __syncwarp();  // every lane holds pv before the swap moves it
      if (pv == 0.0) {
        if (lane == 0) s_singular = 1;
      } else {
        if (pr != k) {
          for (int j = lane; j < m; j += 32) {
            const double t = LU[k * ld + j];
            LU[k * ld + j] = LU[pr * ld + j];
            LU[pr * ld + j] = t;
          }
        }
        __syncwarp();
        for (int i = k + 1 + lane; i < m; i += 32) LU[i * ld + k] = __ddiv_rn(LU[i * ld + k], pv);
      }
      if (lane == 0) piv[k] = pr;
    }
    __syncthreads();
    if (s_singular) break;
    const int t = m - k - 1;
    for (int e = tid; e < t * t; e += kThreads) {
      const int i = k + 1 + e / t, j = k + 1 + e % t;
      LU[i * ld + j] = sub(LU[i * ld + j], mul(LU[i * ld + k], LU[k * ld + j]));
    }
    __syncthreads();
  }
  const bool singular = s_singular;

  if (singular) {
    for (int k = tid; k < m; k += kThreads) r[k] = 0.0, y[k] = 0.0;
  } else if (warp == 0) {
    // B x_B = rhs: the row swaps, then L (unit) forward, then U back
    if (lane == 0) {
      for (int k = 0; k < m; ++k) {
        const int pr = piv[k];
        if (pr != k) {
          const double t = r[k];
          r[k] = r[pr];
          r[pr] = t;
        }
      }
    }
    __syncwarp();
    for (int k = 0; k < m; ++k) {
      const double rk = r[k];
      for (int i = k + 1 + lane; i < m; i += 32) r[i] = sub(r[i], mul(LU[i * ld + k], rk));
      __syncwarp();
    }
    for (int k = m - 1; k >= 0; --k) {
      if (lane == 0) r[k] = __ddiv_rn(r[k], LU[k * ld + k]);
      __syncwarp();
      const double xk = r[k];
      for (int i = lane; i < k; i += 32) r[i] = sub(r[i], mul(LU[i * ld + k], xk));
      __syncwarp();
    }
  } else if (warp == 1) {
    // B^T y = c_B: U^T forward, then L^T (unit) back, then the swaps in reverse
    for (int k = 0; k < m; ++k) {
      if (lane == 0) y[k] = __ddiv_rn(y[k], LU[k * ld + k]);
      __syncwarp();
      const double zk = y[k];
      for (int j = k + 1 + lane; j < m; j += 32) y[j] = sub(y[j], mul(LU[k * ld + j], zk));
      __syncwarp();
    }
    for (int k = m - 1; k >= 0; --k) {
      const double wk = y[k];
      for (int i = lane; i < k; i += 32) y[i] = sub(y[i], mul(LU[k * ld + i], wk));
      __syncwarp();
    }
    if (lane == 0) {
      for (int k = m - 1; k >= 0; --k) {
        const int pr = piv[k];
        if (pr != k) {
          const double t = y[k];
          y[k] = y[pr];
          y[pr] = t;
        }
      }
    }
  }
  __syncthreads();

  // dfeas over the nonbasic columns (d = c - A^T y, a thread per column),
  // pfeas over x_B
  int good = 1;
  for (int j = tid; j < n; j += kThreads) {
    double s = 0.0;
    for (int i = 0; i < m; ++i) s = add(s, mul(Al[(size_t)i * n + j], y[i]));
    const double d = sub(cl[j], s);
    const int v = vs[j];
    if (v == AT_LOWER) good &= d >= -kTol;
    else if (v == AT_UPPER) good &= d <= kTol;
    else if (v == FREE) good &= fabs(d) <= kTol;
  }
  for (int k = tid; k < m; k += kThreads) {
    const int j = bas[k];
    const double loB = valid(j) ? lol[j] : 0.0, hiB = valid(j) ? hil[j] : 0.0;
    good &= r[k] >= sub(loB, kTol) && r[k] <= add(hiB, kTol);
  }
  const bool ok = __syncthreads_and(good) && !singular && status[l] == kOptimal;

  // x = x_N with x_B scattered in basis order (a repeated index: the last
  // wins, as in numpy); obj = c_B . x_B + c . x_N
  double* xl = x + l * n;
  for (int j = tid; j < n; j += kThreads) xl[j] = xN[j];
  __syncthreads();
  if (warp == 0) {
    double s1 = 0.0, s2 = 0.0;
    for (int k = lane; k < m; k += 32) {
      const int j = bas[k];
      s1 = add(s1, mul(valid(j) ? cl[j] : 0.0, r[k]));
    }
    for (int j = lane; j < n; j += 32) s2 = add(s2, mul(cl[j], xN[j]));
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      for (int k = 0; k < m; ++k) {
        const int j = bas[k];
        if (valid(j)) xl[j] = r[k];
      }
      obj[l] = add(s1, s2);
      verified[l] = ok ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// Doubles of workspace per lane (either layout).
size_t certify_f64_workspace_doubles(int m, int n) { return workspace_doubles(m, n); }

// 1 when lanes of m x n can run in `layout` (0 SHARED, 1 GLOBAL): GLOBAL
// always, SHARED when one lane's workspace fits the block's shared memory.
int certify_f64_layout_fits(int layout, int m, int n) {
  if (layout == GLOBAL) return 1;
  if (layout != SHARED) return 0;
  return workspace_doubles(m, n) * sizeof(double) <= kSmemBudget;
}

// Dynamic shared memory of one block in `layout`, in bytes.
size_t certify_f64_smem_bytes(int layout, int m, int n) {
  return layout == SHARED ? workspace_doubles(m, n) * sizeof(double) : 0;
}

// Certify `batch` lanes on `stream` in `layout`.  A (batch, m, n), b
// (batch, m), c/lo/hi (batch, n) f64; basis (batch, m), vstat (batch, n),
// status (batch) int32; all C order.  Writes obj (batch) f64, verified
// (batch) uint8 and x (batch, n) f64.  ws is null unless the layout is
// GLOBAL, where it holds batch * certify_f64_workspace_doubles(m, n)
// doubles.  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a shape or layout it does not take); does not synchronise.
int certify_f64_launch(const double* A, const double* b, const double* c, const double* lo,
                       const double* hi, const int* basis, const int* vstat, const int* status,
                       double* obj, unsigned char* verified, double* x, double* ws, int batch,
                       int m, int n, int layout, void* stream) {
  if (batch < 0 || m < 1 || n < m || !certify_f64_layout_fits(layout, m, n))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((layout == GLOBAL) != (ws != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const Params p{m, n, row_stride(m), workspace_doubles(m, n)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == SHARED) {
    const size_t smem = certify_f64_smem_bytes(SHARED, m, n);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          certify_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    certify_kernel<true><<<batch, kThreads, smem, s>>>(A, b, c, lo, hi, basis, vstat, status,
                                                         obj, verified, x, nullptr, p);
  } else {
    certify_kernel<false><<<batch, kThreads, 0, s>>>(A, b, c, lo, hi, basis, vstat, status,
                                                       obj, verified, x, ws, p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* certify_f64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
