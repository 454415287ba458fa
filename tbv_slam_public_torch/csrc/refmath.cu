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
// The elementwise ops, one kernel an op (a template on the op, so each has
// its own register count and occupancy): exp, log, log1p, sigmoid, sincos
// (two outputs), atan2, wrap_angle, fma (the fused multiply-add that the
// reference's compiler makes of a product feeding an add, its subnormal
// operands and result flushed as vfmadd flushes them on the reference's
// DAZ / FTZ threads), sqrt (the IEEE square root, which the reference's
// program computes; torch's CPU sqrt does not: the plain version rounds a
// float64 root), ftz (the flush) and mul (a lone product, mul.rn.ftz: its
// operands and its result flushed as the reference's threads flush them,
// the result by its exact value).  Each op has three kernels.  Operands
// contiguous, of the output's shape and 16-byte aligned take float4 loads
// and stores (the vector kernel), 4 values a thread (two vectors in flight
// where the grid is full), the last n % 4 values one a thread; the heavy
// ops (sigmoid, sincos, atan2, wrap_angle), and every op at up to 4,096
// values, take a value a thread instead (the flat kernel: their time is a
// thread's latency); any other operand (offset, strided, broadcast) is
// read through its strides, up to 6 dimensions, a value a thread, into a
// contiguous output (the strided kernel).  Grid-stride loops over at most
// 4 waves of the blocks the multiprocessors hold at the op's occupancy.
// Bound: bytes (4-12 B read and 4-8 B written a value); the operation
// counts of atan2 and wrap_angle (glibc's reduction, polynomials and IEEE
// divisions, partly in double; chip_smoke.py's REFMATH_FLOPS) come within
// a factor of two of it.
//
#include "refmath.cuh"

namespace {

enum Op {
  kExp = 0, kLog, kLog1p, kSigmoid, kSinCos, kAtan2, kWrap, kFma, kSqrt, kFtz,
  kMul, kOps
};

__host__ __device__ constexpr int op_inputs(int op) {
  return op == kFma ? 3 : (op == kAtan2 || op == kMul) ? 2 : 1;
}

constexpr int kOpThreads = 256;
constexpr int kOpDims = 6;

// refmath_op_launch's description of a call (kernels/refmath.py OP_ARGS):
// the inputs, the outputs, the values, the output's shape (6 dimensions,
// left-padded with 1) and each input's strides in elements (0 where it is
// broadcast); shape and strides are read by the strided path only.
struct OpArgs {
  const float* in[3];
  float* out[2];
  long long n;
  long long shape[kOpDims];
  long long stride[3][kOpDims];
};

// op on one value (x, y, z its inputs); sincos writes *o1 too.
template <int OP>
__device__ __forceinline__ float op_value(float x, float y, float z,
                                          float* o1) {
  if constexpr (OP == kExp) return ref_exp(x);
  if constexpr (OP == kLog) return ref_log(x);
  if constexpr (OP == kLog1p) return ref_log1p(x);
  if constexpr (OP == kSigmoid) return ref_sigmoid(x);
  if constexpr (OP == kSinCos) {
    float s, c;
    ref_sincos(x, &s, &c);
    *o1 = c;
    return s;
  }
  if constexpr (OP == kAtan2) return ref_atan2(x, y);
  if constexpr (OP == kWrap) {
    float s, c;
    ref_sincos(x, &s, &c);
    return ref_atan2(s, c);
  }
  if constexpr (OP == kFma) return ref_fma(x, y, z);
  if constexpr (OP == kSqrt) return __fsqrt_rn(daz(x));
  if constexpr (OP == kFtz) return daz(x);
  if constexpr (OP == kMul) return mul_ftz(x, y);
  return 0.0f;
}

// the 4 values of input k's vector i (contiguous path)
template <int OP>
__device__ __forceinline__ void load_vec(const OpArgs& a, long long i,
                                         float4* v) {
#pragma unroll
  for (int k = 0; k < op_inputs(OP); ++k)
    v[k] = __ldg(reinterpret_cast<const float4*>(a.in[k]) + i);
}

template <int OP>
__device__ __forceinline__ void op_vec(const OpArgs& a, long long i,
                                       const float4* v) {
  const float4 x = v[0];
  const float4 y = op_inputs(OP) > 1 ? v[1] : x;
  const float4 z = op_inputs(OP) > 2 ? v[2] : x;
  float4 r, c;
  r.x = op_value<OP>(x.x, y.x, z.x, &c.x);
  r.y = op_value<OP>(x.y, y.y, z.y, &c.y);
  r.z = op_value<OP>(x.z, y.z, z.z, &c.z);
  r.w = op_value<OP>(x.w, y.w, z.w, &c.w);
  reinterpret_cast<float4*>(a.out[0])[i] = r;
  if constexpr (OP == kSinCos) reinterpret_cast<float4*>(a.out[1])[i] = c;
}

template <int OP>
__device__ __forceinline__ void op_scalar(const OpArgs& a, long long i,
                                          long long ox, long long oy,
                                          long long oz) {
  const float x = __ldg(a.in[0] + ox);
  const float y = op_inputs(OP) > 1 ? __ldg(a.in[1] + oy) : x;
  const float z = op_inputs(OP) > 2 ? __ldg(a.in[2] + oz) : x;
  float c;
  a.out[0][i] = op_value<OP>(x, y, z, &c);
  if constexpr (OP == kSinCos) a.out[1][i] = c;
}

// Contiguous, aligned operands: float4 vectors in a grid-stride loop, two
// in flight a thread, then the last n % 4 values one a thread.
template <int OP>
__global__ void __launch_bounds__(kOpThreads)
    refmath_op_vec_kernel(const OpArgs a) {
  const long long nv = a.n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long i = tid;
  for (; i + stride < nv; i += 2 * stride) {
    float4 v0[3], v1[3];
    load_vec<OP>(a, i, v0);
    load_vec<OP>(a, i + stride, v1);
    op_vec<OP>(a, i, v0);
    op_vec<OP>(a, i + stride, v1);
  }
  if (i < nv) {
    float4 v[3];
    load_vec<OP>(a, i, v);
    op_vec<OP>(a, i, v);
  }
  const long long t = 4 * nv + tid;
  if (t < a.n) op_scalar<OP>(a, t, t, t, t);
}

// Contiguous operands, a value a thread (the heavy ops, and every op at up
// to 4,096 values, where a thread's latency is the launch's).
template <int OP>
__global__ void __launch_bounds__(kOpThreads)
    refmath_op_flat_kernel(const OpArgs a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < a.n; i += (long long)gridDim.x * blockDim.x)
    op_scalar<OP>(a, i, i, i, i);
}

// Any other operands: value i of the contiguous output reads each input at
// the offset its strides give i's index (stride 0 where broadcast).
template <int OP>
__global__ void __launch_bounds__(kOpThreads)
    refmath_op_strided_kernel(const OpArgs a) {
  constexpr int NI = op_inputs(OP);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < a.n; i += (long long)gridDim.x * blockDim.x) {
    long long off[3] = {0, 0, 0}, r = i;
#pragma unroll
    for (int d = kOpDims - 1; d >= 0; --d) {
      const long long size = a.shape[d];
      if (size == 1) continue;
      const long long q = r / size, k = r - q * size;
      r = q;
#pragma unroll
      for (int j = 0; j < NI; ++j) off[j] += k * a.stride[j][d];
    }
    op_scalar<OP>(a, i, off[0], off[1], off[2]);
  }
}

typedef void (*OpKernel)(const OpArgs);

// the three kernels of an op
enum OpPath { kVector = 0, kFlat = 1, kStrided = 2 };

// the ops whose arithmetic, not their bytes, sets their time (glibc's
// sincos and atan2 with their branches and IEEE divisions, sigmoid's exp
// and division): a value a thread at every size
constexpr bool op_heavy(int op) {
  return op == kSigmoid || op == kSinCos || op == kAtan2 || op == kWrap;
}

template <int OP>
OpKernel op_kernel(int path) {
  return path == kStrided ? refmath_op_strided_kernel<OP>
         : path == kFlat  ? refmath_op_flat_kernel<OP>
                          : refmath_op_vec_kernel<OP>;
}

OpKernel op_kernel_of(int op, int path) {
  switch (op) {
    case kExp: return op_kernel<kExp>(path);
    case kLog: return op_kernel<kLog>(path);
    case kLog1p: return op_kernel<kLog1p>(path);
    case kSigmoid: return op_kernel<kSigmoid>(path);
    case kSinCos: return op_kernel<kSinCos>(path);
    case kAtan2: return op_kernel<kAtan2>(path);
    case kWrap: return op_kernel<kWrap>(path);
    case kFma: return op_kernel<kFma>(path);
    case kSqrt: return op_kernel<kSqrt>(path);
    case kFtz: return op_kernel<kFtz>(path);
    case kMul: return op_kernel<kMul>(path);
  }
  return nullptr;
}

// the multiprocessors and, per op and path, the blocks of kOpThreads one
// holds (queried once, on the first card that launches)
int g_sms = 0;
int g_blocks_per_sm[kOps][3];

int blocks_per_sm(int op, int path) {
  int& b = g_blocks_per_sm[op][path];
  if (b == 0) {
    int v = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &v, op_kernel_of(op, path), kOpThreads, 0) != cudaSuccess ||
        v < 1)
      v = 1;
    b = v;
  }
  if (g_sms == 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || v < 1)
      v = 132;
    g_sms = v;
  }
  return b;
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

// ops/posegraph.py::measured_sqrt_info, a thread an edge, as
// core/refmath.py::measured_sqrt_info: 0.5 (cov + cov^T) + 1e-9 I, its
// inverse by lu_factor and lu_apply against each column of the identity
// (jnp.linalg.inv), the product by the edge's scale, the symmetrised
// (a + a^T) / 2 and its Cholesky factor (chol3), every result flushed;
// the fallback where the factor failed or is not finite.
__global__ void refmath_sqrt_info_kernel(const float* __restrict__ cov,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ fallback,
                                         float* __restrict__ out,
                                         long long n) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x) {
    float c[9];
    for (int k = 0; k < 9; ++k) c[k] = daz(cov[9 * s + k]);
    float a[kLuMax][kLuMax];
    int piv[kLuMax];
    for (int r = 0; r < 3; ++r)
      for (int q = 0; q < 3; ++q) {
        const float half =
            daz(__fmul_rn(0.5f, daz(__fadd_rn(c[3 * r + q], c[3 * q + r]))));
        a[r][q] = daz(__fadd_rn(half, r == q ? 1e-9f : 0.0f));
      }
    lu_factor(3, a, piv);
    float info[9];
    const float sc = scale[s];
    for (int j = 0; j < 3; ++j) {
      float x[kLuMax] = {j == 0 ? 1.0f : 0.0f, j == 1 ? 1.0f : 0.0f,
                         j == 2 ? 1.0f : 0.0f};
      lu_apply(3, a, piv, x);
      for (int r = 0; r < 3; ++r) info[3 * r + j] = mul_ftz(x[r], sc);
    }
    float sym[9], lo[9];
    for (int r = 0; r < 3; ++r)
      for (int q = 0; q < 3; ++q)
        sym[3 * r + q] = daz(__fmul_rn(
            daz(__fadd_rn(info[3 * r + q], info[3 * q + r])), 0.5f));
    bool ok = chol3(sym, lo);
    for (int k = 0; k < 9; ++k) ok = ok && isfinite(lo[k]);
    for (int k = 0; k < 9; ++k) out[9 * s + k] = ok ? lo[k] : fallback[9 * s + k];
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

// Op ``op`` (enum Op) over args->n values as above; ``strided`` selects
// the path that reads the inputs through their strides.  Contiguous
// operands take the vector kernel above 4,096 values unless the op is
// heavy, else the flat one.  Blocks of 256 threads, a thread a value (flat,
// strided) or a vector of 4 (vector; two in flight where the grid is
// full), up to 4 waves of the blocks the multiprocessors hold.
extern "C" int refmath_op_launch(int op, int strided, const void* desc,
                                 void* stream) {
  const OpArgs* args = static_cast<const OpArgs*>(desc);
  const long long n = args->n;
  if (n <= 0) return 0;
  if (op < 0 || op >= kOps) return (int)cudaErrorInvalidValue;
  const int path = strided ? kStrided
                   : (n <= 4096 || op_heavy(op)) ? kFlat : kVector;
  const OpKernel kernel = op_kernel_of(op, path);
  const int threads = kOpThreads;
  const long long per_thread = path == kVector ? 4 : 1;
  long long blocks = (n + per_thread * threads - 1) / (per_thread * threads);
  if (blocks > 132) {
    const long long per_sm = blocks_per_sm(op, path);  // sets g_sms
    const long long most = 4 * per_sm * g_sms;
    if (blocks > most) blocks = most;
  }
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// The registers a thread and the blocks a multiprocessor holds of op's
// kernel on ``path`` (0 vector, 1 flat, 2 strided), for the reports.
extern "C" int refmath_op_info(int op, int path, int* regs, int* blocks) {
  if (op < 0 || op >= kOps || path < 0 || path > 2)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, op_kernel_of(op, path));
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *blocks = blocks_per_sm(op, path);
  return 0;
}

// out [n, 3, 3] = measured_sqrt_info of cov [n, 3, 3], scale [n] and the
// fallback [n, 3, 3], as above.
extern "C" int refmath_sqrt_info_launch(const void* cov, const void* scale,
                                        const void* fallback, void* out,
                                        long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 64;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  refmath_sqrt_info_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)cov, (const float*)scale, (const float*)fallback,
      (float*)out, n);
  return (int)cudaGetLastError();
}
