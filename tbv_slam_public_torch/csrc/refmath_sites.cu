// The refmath kernel's site entries: one launch computes one whole site of
// the main path (a pose composition, a relative pose, points moved by a
// pose, a scan's world-frame targets, a cloud's motion compensation, a
// two-value norm), instead of one launch for each of the site's refmath ops
// and more for the torch glue between them.
//
// Not a TPU kernel: the JAX package leaves these sites to XLA's fusions.
// Each site's plain version is the port's eager body of that site
// (core/se2.py::_compose_plain and its neighbours,
// ops/registration.py::_world_targets_plain,
// ops/radar.py::_motion_compensate_plain, core/refmath.py::norm2), whose
// refmath ops take their CPU plain versions; the kernel runs the same
// operations through refmath_sites.cuh's device functions, every rounding
// written out.
//
// One kernel a site (site_kernel<Site>, a template on the site: no
// run-time switch), one thread an element of the site's broadcast batch (a
// pose, a point, a cell).  A launch passes only the site's own operand and
// output pointers, its batch shape and each operand's strides (32-bit
// element counts: kernels/refmath.py::SITE_ARG_SIZES, 72-256 bytes against
// the single kernel's 432);
// the host merges the batch dimensions that every operand walks as one, so
// where all operands are contiguous an element's offsets are its index
// times the component size, with no division, and otherwise one 32-bit
// division a merged dimension locates it.  A broadcast operand (one pose
// for a scan's cells, one motion for a cloud) is read by index and never
// materialised.  Bound: bytes (12-40 B an element read and 8-32 B written)
// against 30-120 float operations, but the sites pass 1 to a few thousand
// elements, so a launch is latency; the design keeps the launch's host
// work and argument small and the kernel free of 64-bit index arithmetic.
//
// refmath_cumsum_launch is detect's travelled distance: inclusive prefix
// sums in the order of the reference's compiled program (XLA's
// reduce-window rewriter: rows of 16 summed in order from zero, the rows'
// totals scanned the same way, recursively, and added back).  It replaces
// no TPU kernel: the JAX package's jnp.cumsum is that XLA rewrite.  Bound:
// 4 bytes read and 4 written a value and one add, at detect's 128-4,608
// values a few kB, so a launch is latency: the chain of levels (three up
// and two down at 4,608 values), each a row of 16 dependent adds, with a
// barrier between levels.  The design (refmath_cumsum_block_kernel) keeps
// that chain short: one block, a thread a row of the first level holding
// its 16 values and their prefix sums in registers (read from and written
// to device memory once each, as float4 where aligned), the levels above
// it staged in shared memory (at most 1,104 floats), one thread a row at
// every level, the last level (at most 16 values) a lane a prefix in one
// warp, and one barrier a level.  Above 16,384 values (1,024 rows, one a
// thread of the block) refmath_cumsum_kernel keeps every level in device
// memory, one block of 512 threads, correct at any length up to 16^8.
#include "refmath_sites.cuh"

constexpr int kDims = 4;  // batch dimensions after merging

namespace {

enum Site {
  kCompose = 0, kInverse, kRelative, kApply, kRotate, kInterpolate, kRotmat,
  kNorm2, kWorldTargets, kMotionCompensate
};

// operands, outputs and float32 constants of each site
template <int S> struct SiteIO;
template <> struct SiteIO<kCompose> { enum { in = 2, out = 1, consts = 0 }; };
template <> struct SiteIO<kInverse> { enum { in = 1, out = 1, consts = 0 }; };
template <> struct SiteIO<kRelative> { enum { in = 2, out = 1, consts = 0 }; };
template <> struct SiteIO<kApply> { enum { in = 2, out = 1, consts = 0 }; };
template <> struct SiteIO<kRotate> { enum { in = 2, out = 1, consts = 0 }; };
template <> struct SiteIO<kInterpolate> {
  enum { in = 3, out = 1, consts = 0 };
};
template <> struct SiteIO<kRotmat> { enum { in = 1, out = 1, consts = 0 }; };
template <> struct SiteIO<kNorm2> { enum { in = 1, out = 1, consts = 0 }; };
// inputs: pose [3], mean [2], normal [2], cov [2, 2] (P2D, else null),
// valid, scan mask; outputs: mean, normal, cov (P2D), valid
template <> struct SiteIO<kWorldTargets> {
  enum { in = 6, out = 4, consts = 0 };
};
// inputs: points [2], motion [3]; constants 1 / (2 pi), 2 pi, 1e-5 as
// float32; flags: ccw
template <> struct SiteIO<kMotionCompensate> {
  enum { in = 2, out = 1, consts = 3 };
};

// A launch's arguments (kernels/refmath.py::site_args packs them): input
// k's element (batch index i, components j0, j1) lies at in[k] +
// sum_d coord_d(i) stride[k][d] + j0 stride[k][4] + j1 stride[k][5], the
// coordinates over shape[4 - ndim .. 3] (innermost last); outputs are
// contiguous.
template <int S>
struct SiteArgs {
  const void* in[SiteIO<S>::in];
  void* out[SiteIO<S>::out];
  int n;
  int ndim;
  int flags;
  int shape[kDims];
  int stride[SiteIO<S>::in][kDims + 2];
  float c[SiteIO<S>::consts > 0 ? SiteIO<S>::consts : 1];
};

// each input's element offset of batch index i: the merged dimensions'
// coordinates by 32-bit division, innermost first; the outermost is what
// is left (no division at all where the batch merged into one dimension)
template <int S>
__device__ __forceinline__ void offsets(const SiteArgs<S>& a, int i,
                                        int* off) {
  constexpr int ni = SiteIO<S>::in;
#pragma unroll
  for (int k = 0; k < ni; ++k) off[k] = 0;
  unsigned rest = (unsigned)i;
  const int outer = kDims - a.ndim;
  // unrolled: every index into the arguments a constant, so they are read
  // where they lie and never copied to local memory
#pragma unroll
  for (int d = kDims - 1; d >= 0; --d) {
    if (d > outer) {
      const unsigned m = (unsigned)a.shape[d];
      const int c = (int)(rest % m);
      rest /= m;
#pragma unroll
      for (int k = 0; k < ni; ++k) off[k] += c * a.stride[k][d];
    } else if (d == outer) {
#pragma unroll
      for (int k = 0; k < ni; ++k) off[k] += (int)rest * a.stride[k][d];
    }
  }
}

template <int S>
__device__ __forceinline__ float in_f(const SiteArgs<S>& a, const int* off,
                                      int k, int j0 = 0, int j1 = 0) {
  return static_cast<const float*>(a.in[k])[
      off[k] + j0 * a.stride[k][kDims] + j1 * a.stride[k][kDims + 1]];
}

template <int S>
__device__ __forceinline__ bool in_b(const SiteArgs<S>& a, const int* off,
                                     int k) {
  return static_cast<const unsigned char*>(a.in[k])[off[k]] != 0;
}

template <int S>
__device__ __forceinline__ void site_element(const SiteArgs<S>& a, int i) {
  int off[SiteIO<S>::in];
  offsets(a, i, off);
  float* o0 = static_cast<float*>(a.out[0]);
  if constexpr (S == kCompose || S == kRelative) {
    float p[3], q[3], r[3];
    for (int j = 0; j < 3; ++j) {
      p[j] = in_f(a, off, 0, j);
      q[j] = in_f(a, off, 1, j);
    }
    if constexpr (S == kRelative) {
      inverse3(p, r);
      compose3(r, q, o0 + 3 * i);
    } else {
      compose3(p, q, o0 + 3 * i);
    }
  } else if constexpr (S == kInverse) {
    float p[3];
    for (int j = 0; j < 3; ++j) p[j] = in_f(a, off, 0, j);
    inverse3(p, o0 + 3 * i);
  } else if constexpr (S == kApply || S == kRotate) {
    const float p[3] = {in_f(a, off, 0, 0), in_f(a, off, 0, 1),
                        in_f(a, off, 0, 2)};
    apply2(p, in_f(a, off, 1, 0), in_f(a, off, 1, 1), S == kApply,
           o0 + 2 * i);
  } else if constexpr (S == kInterpolate) {
    const float f = in_f(a, off, 2);
    const float a0 = in_f(a, off, 0, 0), a1 = in_f(a, off, 0, 1),
                a2 = in_f(a, off, 0, 2);
    const float dt = ref_wrap(add_ftz(in_f(a, off, 1, 2), -a2));
    o0[3 * i] = ref_fma(add_ftz(in_f(a, off, 1, 0), -a0), f, a0);
    o0[3 * i + 1] = ref_fma(add_ftz(in_f(a, off, 1, 1), -a1), f, a1);
    o0[3 * i + 2] = ref_wrap(ref_fma(dt, f, a2));
  } else if constexpr (S == kRotmat) {
    float s, c;
    ref_sincos(in_f(a, off, 0), &s, &c);
    o0[4 * i] = c;
    o0[4 * i + 1] = -s;
    o0[4 * i + 2] = s;
    o0[4 * i + 3] = c;
  } else if constexpr (S == kNorm2) {
    o0[i] = norm2f(in_f(a, off, 0, 0), in_f(a, off, 0, 1));
  } else if constexpr (S == kWorldTargets) {
    float s, c;
    ref_sincos(in_f(a, off, 0, 2), &s, &c);
    float* o1 = static_cast<float*>(a.out[1]);
    const float2 v = se2_applied(c, s, in_f(a, off, 0, 0),
                                 in_f(a, off, 0, 1), in_f(a, off, 1, 0),
                                 in_f(a, off, 1, 1));
    o0[2 * i] = v.x;
    o0[2 * i + 1] = v.y;
    rotated(c, s, in_f(a, off, 2, 0), in_f(a, off, 2, 1), o1 + 2 * i);
    if (a.in[3] != nullptr) {  // rot @ cov @ rot^T
      const float r[2][2] = {{c, -s}, {s, c}};
      float m[2][2];
      for (int p = 0; p < 2; ++p)
        for (int q = 0; q < 2; ++q)
          m[p][q] = mm2(r[p][0], in_f(a, off, 3, 0, q), r[p][1],
                        in_f(a, off, 3, 1, q));
      float* o2 = static_cast<float*>(a.out[2]) + 4 * i;
      for (int p = 0; p < 2; ++p)
        for (int q = 0; q < 2; ++q)
          o2[2 * p + q] = mm2(m[p][0], r[q][0], m[p][1], r[q][1]);
    }
    static_cast<unsigned char*>(a.out[3])[i] =
        in_b(a, off, 4) && in_b(a, off, 5);
  } else if constexpr (S == kMotionCompensate) {
    const float m[3] = {in_f(a, off, 1, 0), in_f(a, off, 1, 1),
                        in_f(a, off, 1, 2)};
    const float k[3] = {a.c[0], a.c[1], a.c[2]};
    motion2(in_f(a, off, 0, 0), in_f(a, off, 0, 1), m, k, a.flags & 1,
            o0 + 2 * i);
  }
}

template <int S>
__global__ void __launch_bounds__(128) site_kernel(const SiteArgs<S> a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x)
    site_element(a, i);
}

template <int S>
int launch_site(const void* args, void* stream) {
  const SiteArgs<S>& a = *static_cast<const SiteArgs<S>*>(args);
  if (a.n <= 0) return 0;
  if (a.ndim < 1 || a.ndim > kDims) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  int blocks = (a.n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  site_kernel<S><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

constexpr int kScanBlock = 16;   // the rewriter's row length
constexpr int kScanLevels = 8;   // rows of rows: up to 16^8 values

constexpr int kScanRowsMax = 1024;          // first-level rows: a thread each
constexpr int kScanShared = 1024 + 64 + 16;  // the levels above it, padded to 16

// in-order inclusive prefix sums of 16 values from zero
__device__ __forceinline__ void scan16(float* v) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kScanBlock; ++j) v[j] = acc = __fadd_rn(acc, v[j]);
}

__device__ __forceinline__ int round16(int k) { return (k + 15) / 16 * 16; }

// Inclusive prefix sums of x [n], n <= 16 * kScanRowsMax, into out, in the
// blocked order above; one block of at least max(32, rows) threads.
__global__ void __launch_bounds__(kScanRowsMax)
    refmath_cumsum_block_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int n) {
  __shared__ __align__(16) float up[kScanShared];
  const int tid = threadIdx.x;
  if (n <= kScanBlock) {  // lane k: the first k + 1 values in order from zero
    if (tid < n) {
      float acc = 0.0f;
      for (int j = 0; j <= tid; ++j) acc = __fadd_rn(acc, x[j]);
      out[tid] = acc;
    }
    return;
  }
  // level l's values (l >= 1: the row totals of level l - 1) at up + off[l]
  int len[5], off[5], levels = 0;
  len[0] = n;
  off[1] = 0;
  while (len[levels] > kScanBlock) {
    len[levels + 1] = (len[levels] + kScanBlock - 1) / kScanBlock;
    if (levels >= 1) off[levels + 1] = off[levels] + round16(len[levels]);
    ++levels;
  }
  // level 0: thread r's row in registers, zeros past n
  const int rows0 = len[1];
  const bool vec = ((reinterpret_cast<unsigned long long>(x) |
                     reinterpret_cast<unsigned long long>(out)) & 15) == 0;
  const int base = kScanBlock * tid;
  float v[kScanBlock];
  if (tid < rows0) {
    if (vec && base + kScanBlock <= n) {
      const float4* x4 = reinterpret_cast<const float4*>(x + base);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 q = x4[j];
        v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z, v[4 * j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kScanBlock; ++j) v[j] = base + j < n ? x[base + j] : 0.0f;
    }
    scan16(v);
    up[tid] = v[kScanBlock - 1];
  } else if (tid < round16(rows0)) {
    up[tid] = 0.0f;
  }
  __syncthreads();
  // the levels above, up to the last: thread r's row scanned in place, its
  // total (and the next level's padding) written one level up
  for (int l = 1; l < levels; ++l) {
    const int rows = len[l + 1];
    if (tid < rows) {
      float4* row = reinterpret_cast<float4*>(up + off[l] + kScanBlock * tid);
      float w[kScanBlock];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 q = row[j];
        w[4 * j] = q.x, w[4 * j + 1] = q.y, w[4 * j + 2] = q.z, w[4 * j + 3] = q.w;
      }
      scan16(w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        row[j] = make_float4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
      up[off[l + 1] + tid] = w[kScanBlock - 1];
    } else if (tid < round16(rows)) {
      up[off[l + 1] + tid] = 0.0f;
    }
    __syncthreads();
  }
  // the last level (at most 16 values): lane k the first k + 1 in order
  if (tid < 32) {
    const int m = len[levels];
    float* top = up + off[levels];
    float acc = 0.0f;
    for (int j = 0; j <= tid && j < m; ++j) acc = __fadd_rn(acc, top[j]);
    __syncwarp();
    if (tid < m) top[tid] = acc;
  }
  __syncthreads();
  // down: each value of a level plus the sum of the rows before its own
  for (int l = levels - 1; l >= 1; --l) {
    for (int k = tid; k < len[l]; k += blockDim.x) {
      const int r = k / kScanBlock;
      up[off[l] + k] = __fadd_rn(up[off[l] + k],
                                 r == 0 ? 0.0f : up[off[l + 1] + r - 1]);
    }
    __syncthreads();
  }
  if (tid < rows0) {
    const float before = tid == 0 ? 0.0f : up[tid - 1];
#pragma unroll
    for (int j = 0; j < kScanBlock; ++j) v[j] = __fadd_rn(v[j], before);
    if (vec && base + kScanBlock <= n) {
      float4* o4 = reinterpret_cast<float4*>(out + base);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o4[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < kScanBlock; ++j)
        if (base + j < n) out[base + j] = v[j];
    }
  }
}

// Inclusive prefix sums of x [n] into out, in the blocked order above; one
// block, every level in device memory (the path above 16 kScanRowsMax
// values).  scratch holds each level's row totals after the first.
__global__ void refmath_cumsum_kernel(const float* __restrict__ x,
                                      float* __restrict__ out,
                                      float* __restrict__ scratch,
                                      long long n) {
  long long len[kScanLevels + 1];
  float* buf[kScanLevels + 1];
  int levels = 0;
  len[0] = n;
  buf[0] = out;
  long long at = 0;
  while (len[levels] > kScanBlock && levels < kScanLevels) {
    const long long rows = (len[levels] + kScanBlock - 1) / kScanBlock;
    buf[levels + 1] = scratch + at;
    at += rows;
    len[++levels] = rows;
  }
  // up: each row summed in order from zero (the padding adds zeros), its
  // total the next level's value
  for (int l = 0; l < levels; ++l) {
    const float* src = l == 0 ? x : buf[l];
    const long long rows = len[l + 1];
    for (long long r = threadIdx.x; r < rows; r += blockDim.x) {
      float acc = 0.0f;
      for (int j = 0; j < kScanBlock; ++j) {
        const long long k = r * kScanBlock + j;
        acc = __fadd_rn(acc, k < len[l] ? src[k] : 0.0f);
        if (k < len[l]) buf[l][k] = acc;
      }
      buf[l + 1][r] = acc;
    }
    __syncthreads();
  }
  // the last level (at most 16 values) in order from zero
  if (threadIdx.x == 0) {
    const float* src = levels == 0 ? x : buf[levels];
    float acc = 0.0f;
    for (long long k = 0; k < len[levels]; ++k) {
      acc = __fadd_rn(acc, src[k]);
      buf[levels][k] = acc;
    }
  }
  __syncthreads();
  // down: each value plus the sum of the rows before its own
  for (int l = levels - 1; l >= 0; --l) {
    for (long long k = threadIdx.x; k < len[l]; k += blockDim.x) {
      const long long r = k / kScanBlock;
      buf[l][k] = __fadd_rn(buf[l][k], r == 0 ? 0.0f : buf[l + 1][r - 1]);
    }
    __syncthreads();
  }
}


// kernels/refmath.py::SITE_ARG_SIZES holds the same sizes
static_assert(sizeof(SiteArgs<kCompose>) == 104, "SITE_ARG_SIZES");
static_assert(sizeof(SiteArgs<kInverse>) == 72, "SITE_ARG_SIZES");
static_assert(sizeof(SiteArgs<kInterpolate>) == 136, "SITE_ARG_SIZES");
static_assert(sizeof(SiteArgs<kWorldTargets>) == 256, "SITE_ARG_SIZES");
static_assert(sizeof(SiteArgs<kMotionCompensate>) == 112, "SITE_ARG_SIZES");

}  // namespace

// One launch of site `site` (kernels/refmath.py::SITES) whose arguments
// (that site's SiteArgs) args points to.
extern "C" int refmath_site_launch(int site, const void* args, void* stream) {
  switch (site) {
    case kCompose: return launch_site<kCompose>(args, stream);
    case kInverse: return launch_site<kInverse>(args, stream);
    case kRelative: return launch_site<kRelative>(args, stream);
    case kApply: return launch_site<kApply>(args, stream);
    case kRotate: return launch_site<kRotate>(args, stream);
    case kInterpolate: return launch_site<kInterpolate>(args, stream);
    case kRotmat: return launch_site<kRotmat>(args, stream);
    case kNorm2: return launch_site<kNorm2>(args, stream);
    case kWorldTargets: return launch_site<kWorldTargets>(args, stream);
    case kMotionCompensate:
      return launch_site<kMotionCompensate>(args, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// out [n] = the blocked inclusive prefix sums of x [n]; above 16,384
// values scratch holds every level's row totals after the first (the sum
// of ceil(len / 16) over the levels), below it scratch is not read.
extern "C" int refmath_cumsum_launch(const void* x, void* out, void* scratch,
                                     long long n, void* stream) {
  if (n <= 0) return 0;
  if (n <= (long long)kScanBlock * kScanRowsMax) {
    const int rows = (int)((n + kScanBlock - 1) / kScanBlock);
    const int threads = rows <= 32 ? 32 : (rows + 31) / 32 * 32;
    refmath_cumsum_block_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, (int)n);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  long long len = n;
  for (int l = 0; len > kScanBlock; ++l) {
    if (l == kScanLevels) return (int)cudaErrorInvalidValue;
    len = (len + kScanBlock - 1) / kScanBlock;
  }
  refmath_cumsum_kernel<<<1, 512, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (float*)scratch, n);
  return (int)cudaGetLastError();
}
