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
// operations with every rounding written out: ref_fma (a fused
// multiply-add, subnormals flushed as refmath.fma flushes them) exactly
// where the plain version fuses, __fmul_rn / __fadd_rn / __fsub_rn where it rounds a
// product or a sum on its own, so nvcc's contraction changes nothing.  The
// reference's math (sincosf, atan2f, the IEEE root) is refmath.cuh's.
//
// One thread an element of the site's broadcast batch (a pose, a point, a
// cell); each operand is read through its own strides, so a broadcast
// operand (one pose for a scan's cells, one motion for a cloud) is read by
// index and never materialised.  Bound: bytes (12-40 B an element read and
// 8-32 B written) against 30-120 float operations, but the sites pass 1 to
// a few thousand elements, so a launch is latency; the design removes the
// launches, not the arithmetic.
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
#include "refmath.cuh"

constexpr int kDims = 4;     // batch dimensions an operand may have
constexpr int kInputs = 6;   // float or bool operands a site reads
constexpr int kOutputs = 4;  // outputs a site writes

// The launch's description, filled by kernels/refmath.py (its ctypes
// mirror is kernels/build.py::SiteArgs).  Input k's element (index i,
// components j0, j1) lies at in[k] + sum_d coord_d(i) stride[k][d] +
// j0 stride[k][4] + j1 stride[k][5]; outputs are contiguous.
struct SiteArgs {
  int site;
  int flags;
  long long n;
  long long shape[kDims];
  const void* in[kInputs];
  long long stride[kInputs][kDims + 2];
  void* out[kOutputs];
  float c[4];
};

namespace {

enum Site {
  kCompose = 0, kInverse, kRelative, kApply, kRotate, kInterpolate, kRotmat,
  kNorm2, kWorldTargets, kMotionCompensate
};

struct Element {
  long long off[kInputs];
};

__device__ __forceinline__ Element locate(const SiteArgs& a, long long i) {
  Element e;
  long long coord[kDims];
  for (int d = kDims - 1; d >= 0; --d) {
    coord[d] = i % a.shape[d];
    i /= a.shape[d];
  }
  for (int k = 0; k < kInputs; ++k) {
    long long o = 0;
    for (int d = 0; d < kDims; ++d) o += coord[d] * a.stride[k][d];
    e.off[k] = o;
  }
  return e;
}

__device__ __forceinline__ float in_f(const SiteArgs& a, const Element& e,
                                      int k, int j0 = 0, int j1 = 0) {
  return static_cast<const float*>(a.in[k])[
      e.off[k] + j0 * a.stride[k][kDims] + j1 * a.stride[k][kDims + 1]];
}

__device__ __forceinline__ bool in_b(const SiteArgs& a, const Element& e,
                                     int k) {
  return static_cast<const unsigned char*>(a.in[k])[e.off[k]] != 0;
}

__device__ __forceinline__ float ref_wrap(float t) {
  float s, c;
  ref_sincos(t, &s, &c);
  return ref_atan2(s, c);
}

// se2's lone products and sums flush as refmath.cuh's se2 functions do.

// a * b (core/se2.py::_compose_plain)
__device__ __forceinline__ void compose3(const float* a, const float* b,
                                         float* o) {
  float sa, ca;
  ref_sincos(a[2], &sa, &ca);
  o[0] = ref_fma(-sa, b[1], ref_fma(ca, b[0], a[0]));
  o[1] = ref_fma(ca, b[1], ref_fma(sa, b[0], a[1]));
  o[2] = ref_wrap(add_ftz(a[2], b[2]));
}

// a^-1 (_inverse_plain)
__device__ __forceinline__ void inverse3(const float* a, float* o) {
  float s, c;
  ref_sincos(a[2], &s, &c);
  o[0] = -ref_fma(c, a[0], mul_ftz(s, a[1]));
  o[1] = -ref_fma(c, a[1], -mul_ftz(s, a[0]));
  o[2] = -a[2];
}

// (c vx - s vy, s vx + c vy) (se2._rotated)
__device__ __forceinline__ void rotated(float c, float s, float vx, float vy,
                                        float* o) {
  const float2 v = se2_rotated(c, s, vx, vy);
  o[0] = v.x;
  o[1] = v.y;
}

// |(x, y)| as the reference's program: sqrt(fma(y, y, x * x)), IEEE root
// (core/refmath.py::norm2)
__device__ __forceinline__ float norm2f(float x, float y) {
  return __fsqrt_rn(daz(ref_fma(y, y, __fmul_rn(x, x))));
}

// pose a [3] applied to the point (or direction, without the
// translation) (vx, vy) (core/se2.py::_apply_elem, _rotate_elem)
__device__ __forceinline__ void apply2(const float* a, float vx, float vy,
                                       bool translate, float* o) {
  float s, c;
  ref_sincos(a[2], &s, &c);
  const float2 v = translate ? se2_applied(c, s, a[0], a[1], vx, vy)
                             : se2_rotated(c, s, vx, vy);
  o[0] = v.x;
  o[1] = v.y;
}

// the point (x, y) de-skewed by the motion m [3] (ops/radar.py::
// _motion_compensate_plain); k: 1 / (2 pi), 2 pi, 1e-5 as float32
__device__ __forceinline__ void motion2(float x, float y, const float* m,
                                        const float* k, bool ccw, float* o) {
  float ang = ref_atan2(y, x);
  ang = ang > k[2] ? ang : __fadd_rn(k[1], ang);
  float factor = ref_fma(ang, k[0], -0.5f);
  if (ccw) factor = -factor;
  float s, c;
  ref_sincos(__fmul_rn(m[2], factor), &s, &c);
  o[0] = ref_fma(m[0], factor, ref_fma(c, x, -__fmul_rn(s, y)));
  o[1] = ref_fma(m[1], factor, ref_fma(s, x, __fmul_rn(c, y)));
}

__global__ void refmath_site_kernel(const SiteArgs a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < a.n; i += (long long)gridDim.x * blockDim.x) {
    const Element e = locate(a, i);
    float* o0 = static_cast<float*>(a.out[0]);
    switch (a.site) {
      case kCompose:
      case kRelative: {
        float p[3], q[3], r[3];
        for (int j = 0; j < 3; ++j) {
          p[j] = in_f(a, e, 0, j);
          q[j] = in_f(a, e, 1, j);
        }
        if (a.site == kRelative) {
          inverse3(p, r);
          compose3(r, q, o0 + 3 * i);
        } else {
          compose3(p, q, o0 + 3 * i);
        }
        break;
      }
      case kInverse: {
        float p[3];
        for (int j = 0; j < 3; ++j) p[j] = in_f(a, e, 0, j);
        inverse3(p, o0 + 3 * i);
        break;
      }
      case kApply:
      case kRotate: {
        const float p[3] = {in_f(a, e, 0, 0), in_f(a, e, 0, 1),
                            in_f(a, e, 0, 2)};
        apply2(p, in_f(a, e, 1, 0), in_f(a, e, 1, 1), a.site == kApply,
               o0 + 2 * i);
        break;
      }
      case kInterpolate: {
        const float f = in_f(a, e, 2);
        const float a0 = in_f(a, e, 0, 0), a1 = in_f(a, e, 0, 1),
                    a2 = in_f(a, e, 0, 2);
        const float dt = ref_wrap(add_ftz(in_f(a, e, 1, 2), -a2));
        o0[3 * i] = ref_fma(add_ftz(in_f(a, e, 1, 0), -a0), f, a0);
        o0[3 * i + 1] = ref_fma(add_ftz(in_f(a, e, 1, 1), -a1), f, a1);
        o0[3 * i + 2] = ref_wrap(ref_fma(dt, f, a2));
        break;
      }
      case kRotmat: {
        float s, c;
        ref_sincos(in_f(a, e, 0), &s, &c);
        o0[4 * i] = c;
        o0[4 * i + 1] = -s;
        o0[4 * i + 2] = s;
        o0[4 * i + 3] = c;
        break;
      }
      case kNorm2:
        o0[i] = norm2f(in_f(a, e, 0, 0), in_f(a, e, 0, 1));
        break;
      case kWorldTargets: {
        // inputs: pose [3], mean [2], normal [2], cov [2, 2] (P2D), valid,
        // scan mask; outputs: mean, normal, cov (P2D), valid
        float s, c;
        ref_sincos(in_f(a, e, 0, 2), &s, &c);
        float* o1 = static_cast<float*>(a.out[1]);
        const float2 v = se2_applied(c, s, in_f(a, e, 0, 0), in_f(a, e, 0, 1),
                                     in_f(a, e, 1, 0), in_f(a, e, 1, 1));
        o0[2 * i] = v.x;
        o0[2 * i + 1] = v.y;
        rotated(c, s, in_f(a, e, 2, 0), in_f(a, e, 2, 1), o1 + 2 * i);
        if (a.in[3] != nullptr) {  // rot @ cov @ rot^T
          const float r[2][2] = {{c, -s}, {s, c}};
          float m[2][2];
          for (int p = 0; p < 2; ++p)
            for (int q = 0; q < 2; ++q)
              m[p][q] = mm2(r[p][0], in_f(a, e, 3, 0, q), r[p][1],
                            in_f(a, e, 3, 1, q));
          float* o2 = static_cast<float*>(a.out[2]) + 4 * i;
          for (int p = 0; p < 2; ++p)
            for (int q = 0; q < 2; ++q)
              o2[2 * p + q] = mm2(m[p][0], r[q][0], m[p][1], r[q][1]);
        }
        static_cast<unsigned char*>(a.out[3])[i] =
            in_b(a, e, 4) && in_b(a, e, 5);
        break;
      }
      case kMotionCompensate: {
        // inputs: points [2], motion [3]; c: 1 / (2 pi), 2 pi, 1e-5 as
        // float32; flags: ccw
        const float m[3] = {in_f(a, e, 1, 0), in_f(a, e, 1, 1),
                            in_f(a, e, 1, 2)};
        motion2(in_f(a, e, 0, 0), in_f(a, e, 0, 1), m, a.c, a.flags & 1,
                o0 + 2 * i);
        break;
      }
    }
  }
}

// ---- site chains ---------------------------------------------------------
//
// A chain runs an ordered list of sites, and the elementwise glue between
// them, in one launch: each later site reads the earlier sites' results for
// its own element from registers.  Its description (ChainDesc: the steps of
// each segment, the operands' strides, the float32 constants) is built by
// kernels/refmath.py once per chain and shape and kept in device memory; a
// launch passes only that pointer, the element count and the data pointers
// (ChainArgs, 144 bytes against a site's 432).  A chain has one or two
// segments, each its own index space (the two clouds of a frame's motion
// compensation); a thread takes an element of one segment.  Where a site
// runs over a coarser index space than a later one (a relative pose of
// [B, K] keyframes feeding the [B, K, P] points it moves), each thread
// recomputes it for its own element: the same device function on the same
// inputs, so the same bits.  The sites are the device functions above;
// the glue rounds as torch's CPU elementwise ops (one rounding an op); a
// bool is 1.0f or 0.0f in a register.  Its plain version is the chain's
// body run by kernels/refmath.py on tensors, its sites' plain versions in
// order.  Bound: a few hundred bytes and operations an element on 1 to a
// few hundred thousand elements, so a launch is latency; the design removes
// launches and host work.
}  // namespace

constexpr int kChainSegs = 2;     // index spaces of one launch
constexpr int kChainIn = 10;      // operand slots (an operand a segment)
constexpr int kChainOut = 6;      // outputs over all segments
constexpr int kChainRegs = 96;    // float registers of an element
constexpr int kChainSteps = 80;   // steps over all segments
constexpr int kChainConsts = 16;  // float32 constants

enum ChainOp {
  kLoad = 0, kLoadBool, kConst, kStore, kStoreBool, kMul, kSub, kNeg, kAbs,
  kLe, kLt, kAnd, kOr, kWhere,
  kOpCompose = 32, kOpInverse, kOpRelative, kOpApply, kOpRotmat, kOpNorm2,
  kOpMotion
};

// op; dst, a, b, c registers; k an operand slot, output or constant index;
// j a component; n an output's components an element
struct ChainStep {
  unsigned char op, dst, a, b, c, k, j, n;
};

// kernels/refmath.py::CHAIN_DESC packs it; operand slot k's element (index
// li of its segment, component j) lies at in[k] + sum_d coord_d(li)
// stride[k][d] + j stride[k][4]; output k's at out[k] + li n + j.
struct ChainDesc {
  long long start[kChainSegs + 1];         // the segments' first elements
  long long shape[kChainSegs][kDims];      // each segment's batch shape
  long long stride[kChainIn][kDims + 1];
  int first[kChainSegs + 1];               // segment s: steps first[s] ..
  int segs;
  int pad;
  float c[kChainConsts];
  ChainStep step[kChainSteps];
};
static_assert(sizeof(ChainDesc) == 1216, "kernels/refmath.py::CHAIN_DESC");

struct ChainArgs {
  const ChainDesc* desc;
  long long n;
  const void* in[kChainIn];
  void* out[kChainOut];
};
static_assert(sizeof(ChainArgs) == 144, "kernels/refmath.py::CHAIN_ARGS");

namespace {

__global__ void __launch_bounds__(128)
    refmath_chain_kernel(const ChainArgs a) {
  // the description staged in shared memory by the whole block, one
  // parallel read, so that a thread's steps read it at shared-memory
  // latency (a launch of one element reads it once)
  __shared__ __align__(16) ChainDesc sd;
  {
    const long long* src = reinterpret_cast<const long long*>(a.desc);
    long long* dst = reinterpret_cast<long long*>(&sd);
    for (int w = threadIdx.x; w < (int)(sizeof(ChainDesc) / 8);
         w += blockDim.x)
      dst[w] = src[w];
  }
  __syncthreads();
  const ChainDesc* d = &sd;
  // element counts are below 2^31 (kernels/refmath.py): 32-bit index
  // arithmetic
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < (int)a.n;
       i += gridDim.x * blockDim.x) {
    int sg = 0;
    while (sg + 1 < d->segs && i >= d->start[sg + 1]) ++sg;
    const int li = i - (int)d->start[sg];
    long long coord[kDims];
    unsigned rest = (unsigned)li;
    for (int q = kDims - 1; q >= 0; --q) {
      const unsigned m = (unsigned)d->shape[sg][q];
      coord[q] = rest % m;
      rest /= m;
    }
    float r[kChainRegs];
    for (int t = d->first[sg]; t < d->first[sg + 1]; ++t) {
      const ChainStep st = d->step[t];
      switch (st.op) {
        case kLoad:
        case kLoadBool: {
          long long o = st.j * d->stride[st.k][kDims];
          for (int q = 0; q < kDims; ++q) o += coord[q] * d->stride[st.k][q];
          r[st.dst] = st.op == kLoad
                          ? static_cast<const float*>(a.in[st.k])[o]
                          : (static_cast<const unsigned char*>(a.in[st.k])[o]
                                 ? 1.0f : 0.0f);
          break;
        }
        case kConst: r[st.dst] = d->c[st.k]; break;
        case kStore:
          static_cast<float*>(a.out[st.k])[(long long)li * st.n + st.j] =
              r[st.a];
          break;
        case kStoreBool:
          static_cast<unsigned char*>(a.out[st.k])[li] = r[st.a] != 0.0f;
          break;
        case kMul: r[st.dst] = __fmul_rn(r[st.a], r[st.b]); break;
        case kSub: r[st.dst] = __fsub_rn(r[st.a], r[st.b]); break;
        case kNeg: r[st.dst] = -r[st.a]; break;
        case kAbs: r[st.dst] = fabsf(r[st.a]); break;
        case kLe: r[st.dst] = r[st.a] <= r[st.b] ? 1.0f : 0.0f; break;
        case kLt: r[st.dst] = r[st.a] < r[st.b] ? 1.0f : 0.0f; break;
        case kAnd:
          r[st.dst] = (r[st.a] != 0.0f && r[st.b] != 0.0f) ? 1.0f : 0.0f;
          break;
        case kOr:
          r[st.dst] = (r[st.a] != 0.0f || r[st.b] != 0.0f) ? 1.0f : 0.0f;
          break;
        case kWhere: r[st.dst] = r[st.c] != 0.0f ? r[st.a] : r[st.b]; break;
        case kOpCompose: compose3(r + st.a, r + st.b, r + st.dst); break;
        case kOpInverse: inverse3(r + st.a, r + st.dst); break;
        case kOpRelative: {
          float inv[3];
          inverse3(r + st.a, inv);
          compose3(inv, r + st.b, r + st.dst);
          break;
        }
        case kOpApply:
          apply2(r + st.a, r[st.b], r[st.b + 1], true, r + st.dst);
          break;
        case kOpRotmat: {
          float sn, cs;
          ref_sincos(r[st.a], &sn, &cs);
          r[st.dst] = cs;
          r[st.dst + 1] = -sn;
          r[st.dst + 2] = sn;
          r[st.dst + 3] = cs;
          break;
        }
        case kOpNorm2: r[st.dst] = norm2f(r[st.a], r[st.a + 1]); break;
        case kOpMotion:
          motion2(r[st.a], r[st.a + 1], r + st.b, d->c + st.k, st.j != 0,
                  r + st.dst);
          break;
      }
    }
  }
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

}  // namespace

extern "C" int refmath_site_launch(const SiteArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  if (args->site < kCompose || args->site > kMotionCompensate)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  long long blocks = (args->n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  refmath_site_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// One launch of the chain that args->desc describes over args->n elements.
extern "C" int refmath_chain_launch(const ChainArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  if (args->desc == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  long long blocks = (args->n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  refmath_chain_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
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
