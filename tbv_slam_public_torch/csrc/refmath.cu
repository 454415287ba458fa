// The reference's float32 math, bit for bit, as one elementwise kernel for
// sm_90a.
//
// Not a TPU kernel: the JAX package leaves these functions to its compiler,
// and its CPU program computes them with code of its own (XLA's inline
// float32 exp, log and log1p) or calls the C library (glibc 2.36's sinf,
// cosf, sincosf in their FMA variant, and atan2f).  CUDA's sinf, expf or
// __logf round otherwise.  This kernel runs those algorithms with the same
// operations: every multiply, add and fused multiply-add is an explicit
// __f*_rn / __d*_rn / __fma*_rn intrinsic, so nvcc's contraction (on by
// default) changes no rounding.  The reference's threads flush subnormals
// (DAZ and FTZ); daz() reproduces that where it shows in a result.  What
// the reference does at each site, and how that was read from its compiled
// program, is the table in tbv_slam_public_torch/core/refmath.py, whose
// plain PyTorch versions run the same steps on the CPU.  The device
// functions are in refmath.cuh, which the registration kernel (lm_solve.cu)
// inlines too.
//
// One launch per call: an op code, one to three float32 inputs, one or two
// outputs (sincos writes both).  fma is the fused multiply-add that the
// reference's compiler makes of a product feeding an add, its subnormal
// operands and result flushed as vfmadd flushes them on the reference's
// threads (DAZ and FTZ); sqrt is the IEEE
// square root, which the reference's program computes (torch's CPU sqrt
// does not: the plain version rounds a float64 root).
// refmath_loop_dot_launch is the logistic gradient's sum in the reference's
// vectorised loop's order; refmath_lu_solve_launch its Newton step's solve
// as the reference's LAPACK and BLAS routines round it;
// refmath_ceres_covariance_launch ceres_covariance's tail after its
// Hessian.  refmath_lm_update_launch is the LM step theta - H^{-1} g in the
// reference's closed form, a thread a system.  refmath_dot_launch is the small matrix
// product whose terms the reference adds one at a time.  Bound: bytes, 8-16 B a value read and 4-8 B
// written against 20-60 float or double operations; the call sites pass a
// few to a few thousand values, so a launch is latency.
#include "refmath.cuh"

namespace {

enum Op {
  kExp = 0, kLog, kLog1p, kSigmoid, kSinCos, kAtan2, kWrap, kFma, kSqrt, kFtz
};

__global__ void refmath_kernel(int op, const float* __restrict__ x,
                               const float* __restrict__ y,
                               const float* __restrict__ z,
                               float* __restrict__ out0,
                               float* __restrict__ out1, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = x[i], s, c;
    switch (op) {
      case kExp: out0[i] = ref_exp(v); break;
      case kLog: out0[i] = ref_log(v); break;
      case kLog1p: out0[i] = ref_log1p(v); break;
      case kSigmoid: out0[i] = ref_sigmoid(v); break;
      case kSinCos: ref_sincos(v, &s, &c); out0[i] = s; out1[i] = c; break;
      case kAtan2: out0[i] = ref_atan2(v, y[i]); break;
      case kWrap: ref_sincos(v, &s, &c); out0[i] = ref_atan2(s, c); break;
      case kFma: out0[i] = ref_fma(v, y[i], z[i]); break;
      case kSqrt: out0[i] = __fsqrt_rn(daz(v)); break;
      case kFtz: out0[i] = daz(v); break;
    }
  }
}

// out[r, c] = sum_k a[r, k] * b[c, k], one fused multiply-add a term in k
// order from zero, subnormal operands and results flushed: a thread an
// output.
__global__ void refmath_dot_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   float* __restrict__ out, long long rows,
                                   int cols, int depth) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < rows * cols; i += (long long)gridDim.x * blockDim.x) {
    const float* ar = a + (i / cols) * depth;
    const float* bc = b + (i % cols) * (long long)depth;
    float acc = 0.0f;
    for (int k = 0; k < depth; ++k)
      acc = fma_ftz(daz(ar[k]), daz(bc[k]), acc);
    out[i] = acc;
  }
}

// theta - a^{-1} b for n systems theta [n, 3], a [n, 3, 3], b [n, 3]
// (lm_update3), a thread a system.
__global__ void refmath_lm_update_kernel(const float* __restrict__ theta,
                                         const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         float* __restrict__ out, long long n,
                                         bool one_system) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    lm_update3(theta + 3 * i, a + 9 * i, b + 3 * i, one_system, out + 3 * i);
}

// out[c] = sum_k x[c, k] v[k] for x [rows, n], added as the reference's
// vectorised loop adds the logistic gradient's terms (mode 0: in order;
// 1: 8-lane chunks of ic accumulators reassociated into one chain; 2: the
// ic accumulators summed after the loop; then a halving lane tree, an
// epilogue of vf-lane chunks and the last terms one at a time:
// core/refmath.py::loop_dot_shape), subnormal operands and results
// flushed: a thread a row.
__device__ float lane_tree(float* a, int w) {
  for (int h = w / 2; h >= 1; h /= 2)
    for (int l = 0; l < h; ++l) a[l] = daz(__fadd_rn(a[l], a[l + h]));
  return a[0];
}

__global__ void refmath_loop_dot_kernel(const float* __restrict__ x,
                                        const float* __restrict__ v,
                                        float* __restrict__ out, int rows,
                                        int n, int mode, int ic, int vf) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= rows) return;
  const float* xr = x + (long long)c * n;
  float s = 0.0f;
  int done = 0;
  if (mode != 0) {
    const int passes = (n - 1) / (8 * ic);
    float acc[8];
    for (int l = 0; l < 8; ++l) acc[l] = 0.0f;
    for (int j = 0; j < ic; ++j) {
      float a[8];
      for (int l = 0; l < 8; ++l) a[l] = mode == 1 ? acc[l] : 0.0f;
      for (int t = 0; t < passes; ++t) {
        // unrolled: the second chunk of each later accumulator first
        const int i = (mode == 1 && j > 0 && t < 2 && passes >= 2) ? 1 - t
                                                                   : t;
        const int at = 8 * (ic * i + j);
#pragma unroll
        for (int l = 0; l < 8; ++l)
          a[l] = fma_ftz(daz(xr[at + l]), daz(v[at + l]), a[l]);
      }
      for (int l = 0; l < 8; ++l)
        acc[l] = (mode == 1 || j == 0) ? a[l] : daz(__fadd_rn(acc[l], a[l]));
    }
    s = lane_tree(acc, 8);
    done = 8 * ic * passes;
    const int m = vf > 0 && n > done ? (n - done - 1) / vf : 0;
    if (m > 0) {
      float e[8];
      e[0] = s;
      for (int l = 1; l < 8; ++l) e[l] = 0.0f;
      for (int i = 0; i < m; ++i)
        for (int l = 0; l < vf; ++l)
          e[l] = fma_ftz(daz(xr[done + vf * i + l]),
                               daz(v[done + vf * i + l]), e[l]);
      s = lane_tree(e, vf);
      done += vf * m;
    }
  }
  for (int k = done; k < n; ++k) s = fma_ftz(daz(xr[k]), daz(v[k]), s);
  out[c] = s;
}

// h^{-1} g for n systems h [n, k, k], g [n, k], k <= 7, rounded as the
// reference's OpenBLAS sgetrf (unblocked, left-looking) and strsm on the
// unit lower and the upper factor (core/refmath.py::lu_solve; lu_factor
// and lu_apply in refmath.cuh), a thread a system.
__global__ void refmath_lu_solve_kernel(const float* __restrict__ h,
                                        const float* __restrict__ g,
                                        float* __restrict__ out, long long n,
                                        int k) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x) {
    float a[kLuMax][kLuMax], x[kLuMax];
    int piv[kLuMax];
    for (int r = 0; r < k; ++r)
      for (int c = 0; c < k; ++c) a[r][c] = daz(h[(s * k + r) * k + c]);
    lu_factor(k, a, piv);
    for (int q = 0; q < k; ++q) x[q] = daz(g[s * k + q]);
    lu_apply(k, a, piv, x);
    for (int q = 0; q < k; ++q) out[s * k + q] = x[q];
  }
}

// ops/registration.py::ceres_covariance after its Hessian, a thread a row,
// as core/refmath.py::ceres_covariance: h flushed, ok where the smallest
// eigenvalue (la_eigvalsh3, jaxlib's ssyevd) is above 1e-9 and the
// residual dimension less 3 is positive, the scale (30 final_score) /
// max(denominator, 1), the inverse of h (plus the identity where not ok)
// by lu_factor and lu_apply against each column of the identity (sgetrf,
// strsm), every result flushed; the default diagonal where not ok.
__global__ void refmath_ceres_covariance_kernel(
    const float* __restrict__ h, const float* __restrict__ final_score,
    const long long* __restrict__ n_res, float* __restrict__ cov,
    bool* __restrict__ ok_out, long long n, int p2l, float f0, float f1,
    float f2) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x) {
    float hs[9];
    for (int k = 0; k < 9; ++k) hs[k] = daz(h[9 * s + k]);
    float w[3];
    la_eigvalsh3(hs, w);
    const float tiny = 1e-9f;
    const float denom = __ll2float_rn((p2l ? 1LL : 2LL) * n_res[s] - 3LL);
    const bool ok = w[0] > tiny && w[1] > tiny && w[2] > tiny && denom > 0.0f;
    const float scale = daz(__fdiv_rn(daz(__fmul_rn(30.0f, final_score[s])),
                                      fmaxf(denom, 1.0f)));
    float a[kLuMax][kLuMax];
    int piv[kLuMax];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        a[r][c] = daz(__fadd_rn(hs[3 * r + c], r == c && !ok ? 1.0f : 0.0f));
    lu_factor(3, a, piv);
    const float fallback[3] = {f0, f1, f2};
    float* out = cov + 9 * s;
    for (int j = 0; j < 3; ++j) {
      float x[kLuMax] = {j == 0 ? 1.0f : 0.0f, j == 1 ? 1.0f : 0.0f,
                         j == 2 ? 1.0f : 0.0f};
      lu_apply(3, a, piv, x);
      for (int r = 0; r < 3; ++r)
        out[3 * r + j] = ok ? daz(__fmul_rn(scale, x[r]))
                            : (r == j ? fallback[r] : 0.0f);
    }
    ok_out[s] = ok;
  }
}

}  // namespace

// out [n, k] = h^{-1} g for h [n, k, k], g [n, k], k <= 7, as above.
extern "C" int refmath_lu_solve_launch(const void* h, const void* g, void* out,
                                       long long n, int k, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kLuMax) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  refmath_lu_solve_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)h, (const float*)g, (float*)out, n, k);
  return (int)cudaGetLastError();
}

// cov [n, 3, 3] and ok [n] of ceres_covariance from h [n, 3, 3],
// final_score [n], n_res [n] (int64), as above; f0..f2 the default
// covariance's diagonal.
extern "C" int refmath_ceres_covariance_launch(
    const void* h, const void* final_score, const void* n_res, void* cov,
    void* ok, long long n, int p2l, float f0, float f1, float f2,
    void* stream) {
  if (n <= 0) return 0;
  const int threads = 64;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  refmath_ceres_covariance_kernel<<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
      (const float*)h, (const float*)final_score, (const long long*)n_res,
      (float*)cov, (bool*)ok, n, p2l, f0, f1, f2);
  return (int)cudaGetLastError();
}

// out [n, 3] = theta - a^{-1} b for theta [n, 3], a [n, 3, 3], b [n, 3], as
// above.
extern "C" int refmath_lm_update_launch(const void* theta, const void* a,
                                        const void* b, void* out, long long n,
                                        int one_system, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  refmath_lm_update_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)a, (const float*)b, (float*)out, n,
      one_system != 0);
  return (int)cudaGetLastError();
}

// out [rows] = x [rows, n] . v [n] in the reference's loop's order (above).
extern "C" int refmath_loop_dot_launch(const void* x, const void* v, void* out,
                                       int rows, int n, int mode, int ic,
                                       int vf, void* stream) {
  if (rows <= 0) return 0;
  const int threads = 64;
  refmath_loop_dot_kernel<<<(rows + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)x, (const float*)v, (float*)out, rows, n, mode, ic, vf);
  return (int)cudaGetLastError();
}

// out [rows, cols] = a [rows, depth] . b [cols, depth]^T in the order above.
extern "C" int refmath_dot_launch(const void* a, const void* b, void* out,
                                  long long rows, int cols, int depth,
                                  void* stream) {
  long long n = rows * cols;
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  refmath_dot_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, rows, cols, depth);
  return (int)cudaGetLastError();
}

// out0 = f(x) (atan2: f(x, y); fma: x * y + z with one rounding); sincos
// also writes out1 = cos(x).
extern "C" int refmath_launch(int op, const void* x, const void* y,
                              const void* z, void* out0, void* out1,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  refmath_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      op, (const float*)x, (const float*)y, (const float*)z, (float*)out0,
      (float*)out1, n);
  return (int)cudaGetLastError();
}
