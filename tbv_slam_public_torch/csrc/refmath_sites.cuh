// The refmath sites' arithmetic as device functions, shared by the site
// kernels (refmath_sites.cu) and the chain kernels (refmath_chains.cu, made
// by kernels/refmath.py::chain_source): se2's composition, inverse, point
// and direction maps, the two-value norm and the radar's de-skew, each the
// operations of its plain version (core/se2.py::_compose_plain and its
// neighbours, core/refmath.py::norm2, ops/radar.py::
// _motion_compensate_plain) with every rounding written out: ref_fma (a
// fused multiply-add, subnormals flushed as refmath.fma flushes them)
// exactly where the plain version fuses, __fmul_rn / __fadd_rn / __fsub_rn
// where it rounds a product or a sum on its own, so nvcc's contraction
// changes nothing.  The reference's math (sincosf, atan2f, the IEEE root)
// is refmath.cuh's.
#pragma once

#include "refmath.cuh"

namespace {

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

}  // namespace
