// The refmath site chains: one kernel a chain, straight-line code from the
// chain's body (kernels/refmath.py::register_chain), each later site
// reading the earlier ones' results from registers.
//
// MADE BY kernels/refmath.py::chain_source; do not edit.  Regenerate with
// `python3 scripts/gen_refmath_chains.py` after changing a chain's body
// (tests/test_torch_chains.py::test_chain_source_is_current holds this
// file to its bodies).
//
// Not a TPU kernel: XLA fuses these pose-algebra tails.  A chain's body
// runs twice: on tensors (kernels/refmath.py::chain_plain, its plain
// version: each site's plain version in order) and on a recorder, whose
// steps are written out below one statement each: a value is a named
// float that nvcc keeps in a register, a site a call of its device
// function (refmath_sites.cuh), the glue one __fmul_rn / __fsub_rn /
// compare / select each, in the body's order, so the kernel's bits are
// the body's by construction.  A bool is 1.0f or 0.0f.  One thread an
// element of one of the chain's (at most two) segments; a segment's
// operands are read through their 32-bit strides over its merged batch
// shape (no division where it merged into one dimension), a site over a
// coarser index space than a later one recomputed for each element (the
// same function on the same inputs, so the same bits).  A launch passes
// the pointers, the shapes and strides and the body's float32 constants
// (ChainArgs, built by kernels/refmath.py::chain, no description in device
// memory).  Bound: a few hundred bytes and operations an element on 1 to
// a few hundred thousand elements, so a launch is latency.
#include "refmath_sites.cuh"

namespace {

constexpr int kChainDims = 4;

// kernels/refmath.py::chain_struct packs it
template <int NI, int NO, int NC>
struct ChainArgs {
  const void* in[NI];
  void* out[NO];
  int n;       // elements over both segments
  int start1;  // segment 1's first element (n with one segment)
  int flags;   // bit 0: the motion compensation's ccw
  int ndim[2];
  int shape[2][kChainDims];
  int stride[NI][kChainDims + 1];  // batch, then the component
  float c[NC];
};

// the element offsets of the segment's operands first .. first + NS - 1
// at its index li: the merged dimensions' coordinates by 32-bit division,
// innermost first, the outermost what is left
template <int NS, int NI, int NO, int NC>
__device__ __forceinline__ void chain_offsets(const ChainArgs<NI, NO, NC>& a,
                                              int seg, int first, int li,
                                              int* off) {
#pragma unroll
  for (int k = 0; k < NS; ++k) off[k] = 0;
  unsigned rest = (unsigned)li;
  const int outer = kChainDims - a.ndim[seg];
  // unrolled: every index into the arguments a constant, so they are read
  // where they lie and never copied to local memory
#pragma unroll
  for (int d = kChainDims - 1; d >= 0; --d) {
    if (d > outer) {
      const unsigned m = (unsigned)a.shape[seg][d];
      const int c = (int)(rest % m);
      rest /= m;
#pragma unroll
      for (int k = 0; k < NS; ++k) off[k] += c * a.stride[first + k][d];
    } else if (d == outer) {
#pragma unroll
      for (int k = 0; k < NS; ++k) off[k] += (int)rest * a.stride[first + k][d];
    }
  }
}

__device__ __forceinline__ float ld_f(const void* p, int o) {
  return static_cast<const float*>(p)[o];
}

__device__ __forceinline__ float ld_b(const void* p, int o) {
  return static_cast<const unsigned char*>(p)[o] ? 1.0f : 0.0f;
}

// ---- alignment_apply ---------------------------------------------------------
__global__ void __launch_bounds__(128)
    chain_alignment_apply(const ChainArgs<4, 2, 1> a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    if (i < a.start1) {
      const int li = i;
      int off[2];
      chain_offsets<2>(a, 0, 0, li, off);
      const float r0 = ld_f(a.in[0], off[0]);
      const float r1 = ld_f(a.in[0], off[0] + 1 * a.stride[0][kChainDims]);
      const float r2 = ld_f(a.in[0], off[0] + 2 * a.stride[0][kChainDims]);
      const float r3 = ld_f(a.in[1], off[1]);
      const float r4 = ld_f(a.in[1], off[1] + 1 * a.stride[1][kChainDims]);
      float r5, r6;
      { float o[2]; const float x[3] = {r0, r1, r2}; apply2(x, r3, r4, true, o); r5 = o[0]; r6 = o[1]; }
      static_cast<float*>(a.out[0])[li * 2 + 0] = r5;
      static_cast<float*>(a.out[0])[li * 2 + 1] = r6;
    } else {
      const int li = i - a.start1;
      int off[2];
      chain_offsets<2>(a, 1, 2, li, off);
      const float r0 = ld_f(a.in[2], off[0]);
      const float r1 = ld_f(a.in[2], off[0] + 1 * a.stride[2][kChainDims]);
      const float r2 = ld_f(a.in[2], off[0] + 2 * a.stride[2][kChainDims]);
      const float r3 = ld_f(a.in[3], off[1]);
      const float r4 = ld_f(a.in[3], off[1] + 1 * a.stride[3][kChainDims]);
      float r5, r6;
      { float o[2]; const float x[3] = {r0, r1, r2}; apply2(x, r3, r4, true, o); r5 = o[0]; r6 = o[1]; }
      static_cast<float*>(a.out[1])[li * 2 + 0] = r5;
      static_cast<float*>(a.out[1])[li * 2 + 1] = r6;
    }
  }
}
static_assert(sizeof(ChainArgs<4, 2, 1>) == 184, "kernels/refmath.py::chain_struct");

// ---- local_map ---------------------------------------------------------------
__global__ void __launch_bounds__(128)
    chain_local_map(const ChainArgs<3, 1, 1> a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    const int li = i;
    int off[3];
    chain_offsets<3>(a, 0, 0, li, off);
    const float r0 = ld_f(a.in[0], off[0]);
    const float r1 = ld_f(a.in[0], off[0] + 1 * a.stride[0][kChainDims]);
    const float r2 = ld_f(a.in[0], off[0] + 2 * a.stride[0][kChainDims]);
    const float r3 = ld_f(a.in[1], off[1]);
    const float r4 = ld_f(a.in[1], off[1] + 1 * a.stride[1][kChainDims]);
    const float r5 = ld_f(a.in[1], off[1] + 2 * a.stride[1][kChainDims]);
    const float r6 = ld_f(a.in[2], off[2]);
    const float r7 = ld_f(a.in[2], off[2] + 1 * a.stride[2][kChainDims]);
    float r8, r9, r10;
    { float o[3]; const float x[3] = {r0, r1, r2}, y[3] = {r3, r4, r5}; float v[3]; inverse3(x, v); compose3(v, y, o); r8 = o[0]; r9 = o[1]; r10 = o[2]; }
    float r11, r12;
    { float o[2]; const float x[3] = {r8, r9, r10}; apply2(x, r6, r7, true, o); r11 = o[0]; r12 = o[1]; }
    static_cast<float*>(a.out[0])[li * 2 + 0] = r11;
    static_cast<float*>(a.out[0])[li * 2 + 1] = r12;
  }
}
static_assert(sizeof(ChainArgs<3, 1, 1>) == 152, "kernels/refmath.py::chain_struct");

// ---- loop_guess --------------------------------------------------------------
__global__ void __launch_bounds__(128)
    chain_loop_guess(const ChainArgs<2, 1, 3> a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    const int li = i;
    int off[2];
    chain_offsets<2>(a, 0, 0, li, off);
    const float r0 = ld_f(a.in[0], off[0]);
    const float r1 = ld_f(a.in[0], off[0] + 1 * a.stride[0][kChainDims]);
    const float r2 = ld_f(a.in[0], off[0] + 2 * a.stride[0][kChainDims]);
    const float r3 = ld_f(a.in[1], off[1]);
    const float r4 = a.c[0];
    const float r5 = a.c[1];
    float r6, r7, r8;
    { float o[3]; const float x[3] = {r0, r1, r2}; inverse3(x, o); r6 = o[0]; r7 = o[1]; r8 = o[2]; }
    const float r9 = a.c[2];
    const float r10 = __fmul_rn(r4, r9);
    const float r11 = __fmul_rn(r5, r9);
    const float r12 = __fmul_rn(r3, r9);
    float r13, r14, r15;
    { float o[3]; const float x[3] = {r6, r7, r8}, y[3] = {r10, r11, r12}; compose3(x, y, o); r13 = o[0]; r14 = o[1]; r15 = o[2]; }
    static_cast<float*>(a.out[0])[li * 3 + 0] = r13;
    static_cast<float*>(a.out[0])[li * 3 + 1] = r14;
    static_cast<float*>(a.out[0])[li * 3 + 2] = r15;
  }
}
static_assert(sizeof(ChainArgs<2, 1, 3>) == 128, "kernels/refmath.py::chain_struct");

// ---- motion_compensate_pair --------------------------------------------------
__global__ void __launch_bounds__(128)
    chain_motion_compensate_pair(const ChainArgs<4, 2, 6> a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    if (i < a.start1) {
      const int li = i;
      int off[2];
      chain_offsets<2>(a, 0, 0, li, off);
      const float r0 = ld_f(a.in[0], off[0]);
      const float r1 = ld_f(a.in[0], off[0] + 1 * a.stride[0][kChainDims]);
      const float r2 = ld_f(a.in[1], off[1]);
      const float r3 = ld_f(a.in[1], off[1] + 1 * a.stride[1][kChainDims]);
      const float r4 = ld_f(a.in[1], off[1] + 2 * a.stride[1][kChainDims]);
      float r5, r6;
      { float o[2]; const float m[3] = {r2, r3, r4}, k[3] = {a.c[0], a.c[1], a.c[2]}; motion2(r0, r1, m, k, (a.flags & 1) != 0, o); r5 = o[0]; r6 = o[1]; }
      static_cast<float*>(a.out[0])[li * 2 + 0] = r5;
      static_cast<float*>(a.out[0])[li * 2 + 1] = r6;
    } else {
      const int li = i - a.start1;
      int off[2];
      chain_offsets<2>(a, 1, 2, li, off);
      const float r0 = ld_f(a.in[2], off[0]);
      const float r1 = ld_f(a.in[2], off[0] + 1 * a.stride[2][kChainDims]);
      const float r2 = ld_f(a.in[3], off[1]);
      const float r3 = ld_f(a.in[3], off[1] + 1 * a.stride[3][kChainDims]);
      const float r4 = ld_f(a.in[3], off[1] + 2 * a.stride[3][kChainDims]);
      float r5, r6;
      { float o[2]; const float m[3] = {r2, r3, r4}, k[3] = {a.c[3], a.c[4], a.c[5]}; motion2(r0, r1, m, k, (a.flags & 1) != 0, o); r5 = o[0]; r6 = o[1]; }
      static_cast<float*>(a.out[1])[li * 2 + 0] = r5;
      static_cast<float*>(a.out[1])[li * 2 + 1] = r6;
    }
  }
}
static_assert(sizeof(ChainArgs<4, 2, 6>) == 208, "kernels/refmath.py::chain_struct");

// ---- odometry_pose_tail ------------------------------------------------------
__global__ void __launch_bounds__(128)
    chain_odometry_pose_tail(const ChainArgs<6, 5, 6> a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    const int li = i;
    int off[6];
    chain_offsets<6>(a, 0, 0, li, off);
    const float r0 = ld_f(a.in[0], off[0]);
    const float r1 = ld_f(a.in[0], off[0] + 1 * a.stride[0][kChainDims]);
    const float r2 = ld_f(a.in[0], off[0] + 2 * a.stride[0][kChainDims]);
    const float r3 = ld_b(a.in[1], off[1]);
    const float r4 = ld_f(a.in[2], off[2]);
    const float r5 = ld_f(a.in[2], off[2] + 1 * a.stride[2][kChainDims]);
    const float r6 = ld_f(a.in[2], off[2] + 2 * a.stride[2][kChainDims]);
    const float r7 = ld_f(a.in[3], off[3]);
    const float r8 = ld_f(a.in[3], off[3] + 1 * a.stride[3][kChainDims]);
    const float r9 = ld_f(a.in[3], off[3] + 2 * a.stride[3][kChainDims]);
    const float r10 = ld_f(a.in[4], off[4]);
    const float r11 = ld_f(a.in[4], off[4] + 1 * a.stride[4][kChainDims]);
    const float r12 = ld_f(a.in[4], off[4] + 2 * a.stride[4][kChainDims]);
    const float r13 = ld_f(a.in[5], off[5]);
    const float r14 = ld_f(a.in[5], off[5] + 1 * a.stride[5][kChainDims]);
    const float r15 = ld_f(a.in[5], off[5] + 2 * a.stride[5][kChainDims]);
    const float r16 = r3 != 0.0f ? r0 : r4;
    const float r17 = r3 != 0.0f ? r1 : r5;
    const float r18 = r3 != 0.0f ? r2 : r6;
    float r19, r20, r21;
    { float o[3]; const float x[3] = {r7, r8, r9}, y[3] = {r16, r17, r18}; float v[3]; inverse3(x, v); compose3(v, y, o); r19 = o[0]; r20 = o[1]; r21 = o[2]; }
    const float r22 = norm2f(r19, r20);
    const float r23 = a.c[0];
    const float r24 = __fmul_rn(r22, r23);
    const float r25 = __fsub_rn(r19, r10);
    const float r26 = __fsub_rn(r20, r11);
    const float r27 = norm2f(r25, r26);
    const float r28 = a.c[1];
    const float r29 = __fmul_rn(r27, r28);
    const float r30 = a.c[2];
    const float r31 = r24 <= r30 ? 1.0f : 0.0f;
    const float r32 = a.c[3];
    const float r33 = r29 <= r32 ? 1.0f : 0.0f;
    const float r34 = (r31 != 0.0f && r33 != 0.0f) ? 1.0f : 0.0f;
    const float r35 = r34 != 0.0f ? r16 : r4;
    const float r36 = r34 != 0.0f ? r17 : r5;
    const float r37 = r34 != 0.0f ? r18 : r6;
    float r38, r39, r40;
    { float o[3]; const float x[3] = {r7, r8, r9}, y[3] = {r35, r36, r37}; float v[3]; inverse3(x, v); compose3(v, y, o); r38 = o[0]; r39 = o[1]; r40 = o[2]; }
    float r41, r42, r43;
    { float o[3]; const float x[3] = {r13, r14, r15}, y[3] = {r35, r36, r37}; float v[3]; inverse3(x, v); compose3(v, y, o); r41 = o[0]; r42 = o[1]; r43 = o[2]; }
    const float r44 = norm2f(r41, r42);
    const float r45 = a.c[4];
    const float r46 = r45 < r44 ? 1.0f : 0.0f;
    const float r47 = fabsf(r43);
    const float r48 = a.c[5];
    const float r49 = r48 < r47 ? 1.0f : 0.0f;
    const float r50 = (r46 != 0.0f || r49 != 0.0f) ? 1.0f : 0.0f;
    const float r51 = (r50 != 0.0f && r3 != 0.0f) ? 1.0f : 0.0f;
    const float r52 = -r15;
    float r53, r54, r55, r56;
    { float o[4]; float sn, cs; ref_sincos(r52, &sn, &cs); o[0] = cs; o[1] = -sn; o[2] = sn; o[3] = cs; r53 = o[0]; r54 = o[1]; r55 = o[2]; r56 = o[3]; }
    static_cast<float*>(a.out[0])[li * 3 + 0] = r35;
    static_cast<float*>(a.out[0])[li * 3 + 1] = r36;
    static_cast<float*>(a.out[0])[li * 3 + 2] = r37;
    static_cast<float*>(a.out[1])[li * 3 + 0] = r38;
    static_cast<float*>(a.out[1])[li * 3 + 1] = r39;
    static_cast<float*>(a.out[1])[li * 3 + 2] = r40;
    static_cast<float*>(a.out[2])[li * 3 + 0] = r41;
    static_cast<float*>(a.out[2])[li * 3 + 1] = r42;
    static_cast<float*>(a.out[2])[li * 3 + 2] = r43;
    static_cast<unsigned char*>(a.out[3])[li] = r51 != 0.0f;
    static_cast<float*>(a.out[4])[li * 4 + 0] = r53;
    static_cast<float*>(a.out[4])[li * 4 + 1] = r54;
    static_cast<float*>(a.out[4])[li * 4 + 2] = r55;
    static_cast<float*>(a.out[4])[li * 4 + 3] = r56;
  }
}
static_assert(sizeof(ChainArgs<6, 5, 6>) == 288, "kernels/refmath.py::chain_struct");

}  // namespace

template <class Args>
int launch_chain(void (*kernel)(Args), const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.n <= 0) return 0;
  const int threads = 128;
  int blocks = (a.n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// One launch of chain `chain` (kernels/refmath.py::CHAIN_KERNELS) whose
// arguments (its ChainArgs) args points to.
extern "C" int refmath_chain_launch(int chain, const void* args, void* stream) {
  switch (chain) {
    case 0: return launch_chain(chain_alignment_apply, args, stream);
    case 1: return launch_chain(chain_local_map, args, stream);
    case 2: return launch_chain(chain_loop_guess, args, stream);
    case 3: return launch_chain(chain_motion_compensate_pair, args, stream);
    case 4: return launch_chain(chain_odometry_pose_tail, args, stream);
  }
  return (int)cudaErrorInvalidValue;
}
