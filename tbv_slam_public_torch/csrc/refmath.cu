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
// reference's compiler makes of a product feeding an add; sqrt is the IEEE
// square root, which the reference's program computes (torch's CPU sqrt
// does not: the plain version rounds a float64 root).
// refmath_loop_dot_launch is the logistic gradient's sum in the reference's
// vectorised loop's order; refmath_lu_solve_launch its Newton step's solve
// as the reference's LAPACK and BLAS routines round it.  refmath_lm_update_launch is the LM step theta - H^{-1} g in the
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
      case kFma: out0[i] = __fmaf_rn(v, y[i], z[i]); break;
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
      acc = daz(__fmaf_rn(daz(ar[k]), daz(bc[k]), acc));
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
          a[l] = daz(__fmaf_rn(daz(xr[at + l]), daz(v[at + l]), a[l]));
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
          e[l] = daz(__fmaf_rn(daz(xr[done + vf * i + l]),
                               daz(v[done + vf * i + l]), e[l]));
      s = lane_tree(e, vf);
      done += vf * m;
    }
  }
  for (int k = done; k < n; ++k) s = daz(__fmaf_rn(daz(xr[k]), daz(v[k]), s));
  out[c] = s;
}

// h^{-1} g for n systems h [n, k, k], g [n, k], k <= 7, rounded as the
// reference's OpenBLAS sgetrf (unblocked, left-looking) and strsm on the
// unit lower and the upper factor (core/refmath.py::lu_solve), a thread a
// system.
constexpr int kLuMax = 7;

// The library runs on the reference's thread, which flushes subnormals
// (DAZ and FTZ): the operands are flushed once as they are read, and every
// float result below is flushed (daz).
// sdot of x (stride 1 here) and y: pairs fma(x0, y0, x1 * y1) added into a
// double from zero, an odd last product alone, rounded to float once.
__device__ float lu_strided_dot(const float* x, const float* y, int n) {
  double acc = 0.0;
  int p = 0;
  for (; p + 1 < n; p += 2)
    acc = __dadd_rn(acc, (double)daz(__fmaf_rn(
                             x[p], y[p], daz(__fmul_rn(x[p + 1], y[p + 1])))));
  if (n & 1) acc = __dadd_rn(acc, (double)daz(__fmul_rn(x[n - 1], y[n - 1])));
  return daz(__double2float_rn(acc));
}

// y - sum_c a[c] x[c], the sum one fused multiply-add a term from zero.
__device__ float lu_chain(float y, const float* a, const float* x, int from,
                          int to) {
  float acc = 0.0f;
  for (int c = from; c < to; ++c) acc = daz(__fmaf_rn(a[c], x[c], acc));
  return daz(__fsub_rn(y, acc));
}

__global__ void refmath_lu_solve_kernel(const float* __restrict__ h,
                                        const float* __restrict__ g,
                                        float* __restrict__ out, long long n,
                                        int k) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x) {
    float a[kLuMax][kLuMax], col[kLuMax], x[kLuMax];
    int piv[kLuMax];
    for (int r = 0; r < k; ++r)
      for (int c = 0; c < k; ++c) a[r][c] = daz(h[(s * k + r) * k + c]);
    for (int j = 0; j < k; ++j) {
      for (int r = 0; r < k; ++r) col[r] = a[r][j];
      for (int q = 0; q < j; ++q) {
        const float t = col[q];
        col[q] = col[piv[q]];
        col[piv[q]] = t;
      }
      for (int q = 1; q < j; ++q)
        col[q] = daz(__fsub_rn(col[q], lu_strided_dot(a[q], col, q)));
      for (int r = j; r < k; ++r) col[r] = lu_chain(col[r], a[r], col, 0, j);
      for (int r = 0; r < k; ++r) a[r][j] = col[r];
      // the first largest magnitude (a NaN above every number)
      int p = j;
      float best = fabsf(col[j]);
      for (int r = j + 1; r < k; ++r) {
        const float v = fabsf(col[r]);
        if (v > best || (isnan(v) && !isnan(best))) {
          best = v;
          p = r;
        }
      }
      piv[j] = p;
      const float t = col[p];
      if (t != 0.0f && fabsf(t) >= 1.17549435e-38f) {
        for (int c = 0; c <= j; ++c) {
          const float u = a[j][c];
          a[j][c] = a[p][c];
          a[p][c] = u;
        }
        const float rcp = daz(__fdiv_rn(1.0f, t));
        for (int q = j + 1; q < k; ++q) a[q][j] = daz(__fmul_rn(a[q][j], rcp));
      }
    }
    for (int q = 0; q < k; ++q) x[q] = daz(g[s * k + q]);
    for (int q = 0; q < k; ++q) {
      const float t = x[q];
      x[q] = x[piv[q]];
      x[piv[q]] = t;
    }
    int lo[3], hi[3], nb = 0, r0 = 0;
    for (int w = 4; w >= 1; w /= 2)
      if (k & w) {
        lo[nb] = r0;
        hi[nb++] = r0 + w;
        r0 += w;
      }
    for (int b = 0; b < nb; ++b) {  // the unit lower factor, from the top
      for (int r = lo[b]; r < hi[b]; ++r)
        x[r] = lu_chain(x[r], a[r], x, 0, lo[b]);
      for (int i = lo[b]; i < hi[b]; ++i)
        for (int q = i + 1; q < hi[b]; ++q)
          x[q] = daz(__fmaf_rn(-x[i], a[q][i], x[q]));
    }
    for (int b = nb - 1; b >= 0; --b) {  // the upper factor, from the bottom
      for (int r = lo[b]; r < hi[b]; ++r)
        x[r] = lu_chain(x[r], a[r], x, hi[b], k);
      for (int i = hi[b] - 1; i >= lo[b]; --i) {
        x[i] = daz(__fmul_rn(x[i], daz(__fdiv_rn(1.0f, a[i][i]))));
        for (int q = lo[b]; q < i; ++q)
          x[q] = daz(__fmaf_rn(-x[i], a[q][i], x[q]));
      }
    }
    for (int q = 0; q < k; ++q) out[s * k + q] = x[q];
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
