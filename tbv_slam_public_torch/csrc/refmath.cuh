// The reference's float32 math as CUDA device functions, shared by the
// refmath kernel (refmath.cu) and the registration kernel (lm_solve.cu).
//
// XLA's inline float32 exp, log and log1p, glibc 2.36's sinf / cosf /
// sincosf (FMA variant) and atan2f, the IEEE square root and the LM step
// theta - H^{-1} g in the reference's closed form.  Every multiply, add and
// fused multiply-add is an explicit __f*_rn / __d*_rn / __fma*_rn
// intrinsic, so nvcc's contraction (on by default) changes no rounding.
// The reference's threads flush subnormals (DAZ and FTZ); daz() reproduces
// that where it shows in a result.  What the reference does at each site,
// and how that was read from its compiled program, is the table in
// tbv_slam_public_torch/core/refmath.py, whose plain PyTorch versions run
// the same steps on the CPU.  Everything here is file-local to each
// translation unit that includes it (an unnamed namespace).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMinNorm = 1.17549435082228750797e-38f;  // 2^-126

__device__ __forceinline__ float daz(float x) {
  return fabsf(x) < kMinNorm ? __fmul_rn(x, 0.0f) : x;
}

// a * b, a * b + c and a + b rounded once, their subnormal operands and
// result flushed, each one instruction (.ftz).  The card flushes a result
// whose rounding with an unbounded exponent is below 2^-126, as the
// reference's x86 FTZ does (a product just below 2^-126 that rounds to it
// is kept, one on the tie 2^-126 - 2^-150 flushed: scripts/probe_ftz.py),
// so with operands that are normal or zero each equals daz() of the plain
// operation but on that tie, which daz() keeps and they flush, as the
// plain versions do (core/refmath.py::_flush: mul_ftz, sum_ftz, fma), and
// costs nothing more.  Wherever a plain version calls refmath.fma, its
// kernel calls fma_ftz (ref_fma).
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// refmath.fma: a * b + c rounded once, its subnormal operands and result
// flushed, as the reference's vfmadd on its DAZ / FTZ threads (the plain
// core/refmath.py::fma); the kernels use it wherever their plain version
// calls refmath.fma.
__device__ __forceinline__ float ref_fma(float a, float b, float c) {
  return fma_ftz(a, b, c);
}

// ---- se2 (core/se2.py's plain versions) ----------------------------------
// The lone products and sums read a subnormal sine, coordinate or angle as
// zero and flush a subnormal result (mul_ftz, add_ftz: one .ftz instruction
// each), as core/se2.py::_mul, _add and the reference's DAZ / FTZ threads;
// sinf of a subnormal angle and a negation keep it.  The site kernels
// (refmath_sites.cu) and the registration kernel's placement of its targets
// (lm_solve.cu) share these.

// (c vx - s vy, s vx + c vy) (se2._rotated)
__device__ __forceinline__ float2 se2_rotated(float c, float s, float vx,
                                              float vy) {
  return make_float2(fma_ftz(c, vx, -mul_ftz(s, vy)),
                     fma_ftz(s, vx, mul_ftz(c, vy)));
}

// (vx, vy) moved by the pose (px, py, angle) whose sine and cosine are s
// and c (se2._apply_elem)
__device__ __forceinline__ float2 se2_applied(float c, float s, float px,
                                              float py, float vx, float vy) {
  const float2 v = se2_rotated(c, s, vx, vy);
  return make_float2(add_ftz(v.x, px), add_ftz(v.y, py));
}

// (0 + a0 b0) + a1 b1: torch's CPU matrix product of 2 x 2 operands (its
// small-size loop, from zero, unfused; ops/registration.py::_mm2)
__device__ __forceinline__ float mm2(float a0, float b0, float a1, float b1) {
  return __fadd_rn(__fadd_rn(0.0f, __fmul_rn(a0, b0)), __fmul_rn(a1, b1));
}

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  x = (x >= lo || isnan(x)) ? x : lo;
  return (x <= hi || isnan(x)) ? x : hi;
}

// ---- XLA's exp (Eigen pexp) ---------------------------------------------
__device__ float ref_exp(float x) {
  const float kC1 = 0.693359375f;
  const float kC2 = __int_as_float(0xB95E8083);
  x = clamp_nan(daz(x), __int_as_float(0xC2AF999A), __int_as_float(0x42B1999A));
  float fx = floorf(__fmaf_rn(x, __int_as_float(0x3FB8AA3B), 0.5f));
  fx = clamp_nan(fx, -127.0f, 127.0f);
  float r = __fsub_rn(x, __fmul_rn(fx, kC1));
  r = __fmaf_rn(-fx, kC2, r);
  float y = __fmaf_rn(r, __int_as_float(0x39506967), __int_as_float(0x3AB743CE));
  y = __fmaf_rn(y, r, __int_as_float(0x3C088908));
  y = __fmaf_rn(y, r, __int_as_float(0x3D2AA9C1));
  y = __fmaf_rn(y, r, __int_as_float(0x3E2AAAAA));
  y = __fmaf_rn(y, r, 0.5f);
  y = __fmaf_rn(y, __fmul_rn(r, r), r);
  y = __fadd_rn(y, 1.0f);
  int n = isnan(fx) ? 0 : __float2int_rz(fx);
  return daz(__fmul_rn(y, __int_as_float((n + 127) << 23)));
}

__device__ float ref_sigmoid(float x) {
  return daz(__fdiv_rn(1.0f, __fadd_rn(ref_exp(-x), 1.0f)));
}

// ---- XLA's log (Eigen plog) ---------------------------------------------
__device__ float log_core(float x) {
  const float kC1 = 0.693359375f;
  const float kC2 = __int_as_float(0xB95E8083);
  bool invalid = !(x > 0.0f), zero = x == 0.0f, inf = x == INFINITY;
  float xc = x > kMinNorm ? x : kMinNorm;
  int bx = __float_as_int(xc);
  float e = __fadd_rn((float)(((bx >> 23) & 0x1FF) - 127), 1.0f);
  float m = __int_as_float((bx & 0x807FFFFF) | 0x3F000000);
  bool small = m < __int_as_float(0x3F3504F3);
  float tmp = small ? m : 0.0f;
  float x1 = __fsub_rn(m, 1.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  float v = __fadd_rn(x1, tmp);
  float x2 = __fmul_rn(v, v);
  float x3 = __fmul_rn(x2, v);
  float y = __fmaf_rn(v, __int_as_float(0x3D9021BB), __int_as_float(0xBDEBD1B8));
  float y1 = __fmaf_rn(v, __int_as_float(0xBDFE5D4F), __int_as_float(0x3E11E9BF));
  float y2 = __fmaf_rn(v, __int_as_float(0x3E4CCEAC), __int_as_float(0xBE7FFFFC));
  y = __fmaf_rn(y, v, __int_as_float(0x3DEF251A));
  y1 = __fmaf_rn(y1, v, __int_as_float(0xBE2AAE50));
  y2 = __fmaf_rn(y2, v, __int_as_float(0x3EAAAAAA));
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(e, kC2));
  y = __fadd_rn(__fsub_rn(v, __fmul_rn(0.5f, x2)), y);
  y = __fadd_rn(y, __fmul_rn(e, kC1));
  if (invalid) y = NAN;
  if (zero) y = -INFINITY;
  if (inf) y = INFINITY;
  return y;
}

__device__ float ref_log(float x) { return log_core(daz(x)); }

__device__ float ref_log1p(float x) {
  x = daz(x);
  if (!(fabsf(x) < __int_as_float(0x3ED413CD)))
    return log_core(__fadd_rn(x, 1.0f));
  const int kQ[6] = {0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                     0x43586D8A, 0x42707982};
  const int kP[7] = {0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                     0x4273CC76, 0x426473AD, 0x41A05101};
  float x2 = __fmul_rn(x, x);
  float z0 = __fmul_rn(x, 0.0f);
  float q = __fadd_rn(z0, 1.0f);
  for (int i = 0; i < 6; ++i) q = __fmaf_rn(q, x, __int_as_float(kQ[i]));
  float p = __fadd_rn(z0, __int_as_float(kP[0]));
  for (int i = 1; i < 7; ++i) p = __fmaf_rn(p, x, __int_as_float(kP[i]));
  float r = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q));
  return __fadd_rn(x, __fmaf_rn(x2, -0.5f, r));
}

// ---- glibc 2.36 sinf / cosf / sincosf, FMA variant ----------------------
// __sincosf_table[0]: sign[4], hpi_inv (2/pi * 2^24), hpi, then
// c0, c1, s1, c2, s2, c3, s3, c4; table[1] negates the c's.
__constant__ double kSign[4] = {1.0, -1.0, -1.0, 1.0};
__constant__ uint32_t kInvPio4[24] = {
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

__device__ __forceinline__ double hexd(unsigned long long b) {
  return __longlong_as_double((long long)b);
}

__device__ float sin_poly(double xs, double x2) {
  const double s1 = hexd(0xBFC555545995A603ull);  // -0x1.555545995a603p-3
  const double s2 = hexd(0x3F81107605230BC4ull);  // 0x1.1107605230bc4p-7
  const double s3 = hexd(0xBF2994EB3774CF24ull);  // -0x1.994eb3774cf24p-13
  double x3 = __dmul_rn(x2, xs);
  double p = __fma_rn(x2, s3, s2);
  double x7 = __dmul_rn(x2, x3);
  double s = __fma_rn(x3, s1, xs);
  return __double2float_rn(__fma_rn(p, x7, s));
}

__device__ float cos_poly(double x2, bool neg) {
  const unsigned long long s = neg ? 0x8000000000000000ull : 0ull;
  const double c0 = hexd(0x3FF0000000000000ull ^ s);
  const double c1 = hexd(0xBFDFFFFFFD0C621Cull ^ s);  // -0x1.ffffffd0c621cp-2
  const double c2 = hexd(0x3FA55553E1068F19ull ^ s);  // 0x1.55553e1068f19p-5
  const double c3 = hexd(0xBF56C087E89A359Dull ^ s);  // -0x1.6c087e89a359dp-10
  const double c4 = hexd(0x3EF99343027BF8C3ull ^ s);  // 0x1.99343027bf8c3p-16
  double x4 = __dmul_rn(x2, x2);
  double c1p = __fma_rn(x2, c1, c0);
  double c2p = __fma_rn(x2, c4, c3);
  double x6 = __dmul_rn(x2, x4);
  double c = __fma_rn(x4, c2, c1p);
  return __double2float_rn(__fma_rn(c2p, x6, c));
}

// (sin y, cos y) as __sinf_fma / __cosf_fma return them, by value (a call
// that is not inlined passes them in registers).
__device__ float2 sincos_value(float y) {
  uint32_t bits = __float_as_uint(y);
  uint32_t top = (bits >> 20) & 0x7ff;
  double x = (double)y;
  if (top < (0x3F490FDBu >> 20)) {  // |y| < pi/4
    if (top < (0x39800000u >> 20)) {  // |y| < 2^-12
      return make_float2(y, 1.0f);
    }
    double x2 = __dmul_rn(x, x);
    return make_float2(sin_poly(x, x2), cos_poly(x2, false));
  }
  if (top >= 0x7f8) {  // inf or nan
    return make_float2(NAN, NAN);
  }
  int n, q;
  double r;
  if (top < (0x42F00000u >> 20)) {  // |y| < 120
    const double hpi_inv = hexd(0x41645F306DC9C883ull);  // 0x1.45f306dc9c883p+23
    const double hpi = hexd(0x3FF921FB54442D18ull);
    n = (__double2int_rz(__dmul_rn(x, hpi_inv)) + 0x800000) >> 24;
    r = __fma_rn(-(double)n, hpi, x);
    q = n;
  } else {  // glibc's reduce_large
    const uint32_t* arr = &kInvPio4[(bits >> 26) & 15];
    int shift = (bits >> 23) & 7;
    uint32_t xi = ((bits & 0xffffff) | 0x800000) << shift;
    uint64_t res0 = xi * arr[0];
    uint64_t res1 = (uint64_t)xi * arr[4];
    uint64_t res2 = (uint64_t)xi * arr[8];
    res0 = (res2 >> 32) | (res0 << 32);
    res0 += res1;
    uint64_t nn = (res0 + (1ULL << 61)) >> 62;
    res0 -= nn << 62;
    n = (int)nn;
    r = __dmul_rn(__ll2double_rn((long long)res0),
                  hexd(0x3C1921FB54442D18ull));  // pi * 2^-63
    q = n + (int)(bits >> 31);
  }
  double x2 = __dmul_rn(r, r);
  bool neg = (q & 2) != 0;
  float s = sin_poly(__dmul_rn(r, kSign[q & 3]), x2);
  float c = cos_poly(x2, neg);
  bool odd = n & 1;
  return odd ? make_float2(c, s) : make_float2(s, c);
}

// sin and cos of y (sincos_value) into *sp and *cp.
__device__ __forceinline__ void ref_sincos(float y, float* sp, float* cp) {
  const float2 v = sincos_value(y);
  *sp = v.x;
  *cp = v.y;
}

// ---- glibc atanf / atan2f (fdlibm's float algorithm, no FMA) ------------
__device__ float ref_atanf(float x) {
  const int kHi[4] = {0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA};
  const int kLo[4] = {0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168};
  int hx = __float_as_int(x);
  int ix = hx & 0x7fffffff;
  if (ix >= 0x4c000000) {
    if (ix > 0x7f800000) return __fadd_rn(x, x);
    float big = __fadd_rn(__int_as_float(kHi[3]), __int_as_float(kLo[3]));
    return hx > 0 ? big : -big;
  }
  int id;
  if (ix < 0x3ee00000) {
    if (ix < 0x31000000) return x;
    id = -1;
  } else {
    x = fabsf(x);
    if (ix < 0x3f980000) {
      if (ix < 0x3f300000) {
        id = 0;
        x = __fdiv_rn(__fsub_rn(__fadd_rn(x, x), 1.0f), __fadd_rn(2.0f, x));
      } else {
        id = 1;
        x = __fdiv_rn(__fsub_rn(x, 1.0f), __fadd_rn(x, 1.0f));
      }
    } else if (ix < 0x401c0000) {
      id = 2;
      x = __fdiv_rn(__fsub_rn(x, 1.5f), __fadd_rn(1.0f, __fmul_rn(1.5f, x)));
    } else {
      id = 3;
      x = __fdiv_rn(-1.0f, x);
    }
  }
  float z = __fmul_rn(x, x);
  float w = __fmul_rn(z, z);
  float s1 = __int_as_float(0x3C8569D7);
  s1 = __fadd_rn(__int_as_float(0x3D4BDA59), __fmul_rn(w, s1));
  s1 = __fadd_rn(__int_as_float(0x3D886B35), __fmul_rn(w, s1));
  s1 = __fadd_rn(__int_as_float(0x3DBA2E6E), __fmul_rn(w, s1));
  s1 = __fadd_rn(__int_as_float(0x3E124925), __fmul_rn(w, s1));
  s1 = __fadd_rn(__int_as_float(0x3EAAAAAB), __fmul_rn(w, s1));
  s1 = __fmul_rn(z, s1);
  float s2 = __int_as_float(0xBD15A221);
  s2 = __fadd_rn(__int_as_float(0xBD6EF16B), __fmul_rn(w, s2));
  s2 = __fadd_rn(__int_as_float(0xBD9D8795), __fmul_rn(w, s2));
  s2 = __fadd_rn(__int_as_float(0xBDE38E38), __fmul_rn(w, s2));
  s2 = __fadd_rn(__int_as_float(0xBE4CCCCD), __fmul_rn(w, s2));
  s2 = __fmul_rn(w, s2);
  float t = __fmul_rn(x, __fadd_rn(s1, s2));
  if (id < 0) return __fsub_rn(x, t);
  z = __fsub_rn(__int_as_float(kHi[id]),
                __fsub_rn(__fsub_rn(t, __int_as_float(kLo[id])), x));
  return hx < 0 ? -z : z;
}

__device__ float ref_atan2(float y, float x) {
  const float kTiny = __int_as_float(0x0DA24260);   // 1e-30
  const float kPio4 = __int_as_float(0x3F490FDB);
  const float kPio2 = __int_as_float(0x3FC90FDB);
  const float kPi = __int_as_float(0x40490FDB);
  const float kPiLo = __int_as_float(0xB3BBBD2E);
  int hx = __float_as_int(x), hy = __float_as_int(y);
  int ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return __fadd_rn(x, y);
  if (hx == 0x3f800000) return ref_atanf(y);
  int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);
  if (iy == 0) {
    if (m < 2) return y;
    return m == 2 ? __fadd_rn(kPi, kTiny) : __fsub_rn(-kPi, kTiny);
  }
  if (ix == 0) return hy < 0 ? __fsub_rn(-kPio2, kTiny) : __fadd_rn(kPio2, kTiny);
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      switch (m) {
        case 0: return __fadd_rn(kPio4, kTiny);
        case 1: return __fsub_rn(-kPio4, kTiny);
        case 2: return __fadd_rn(__fmul_rn(3.0f, kPio4), kTiny);
        default: return __fsub_rn(__fmul_rn(-3.0f, kPio4), kTiny);
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return __fadd_rn(kPi, kTiny);
      default: return __fsub_rn(-kPi, kTiny);
    }
  }
  if (iy == 0x7f800000) return hy < 0 ? __fsub_rn(-kPio2, kTiny) : __fadd_rn(kPio2, kTiny);
  int k = (iy - ix) >> 23;
  float z;
  if (k > 60) {
    z = __fadd_rn(kPio2, __fmul_rn(0.5f, kPiLo));
  } else if (hx < 0 && k < -60) {
    z = 0.0f;
  } else {
    z = ref_atanf(daz(fabsf(__fdiv_rn(daz(y), daz(x)))));
  }
  switch (m) {
    case 0: return z;
    case 1: return __int_as_float(__float_as_int(z) ^ 0x80000000);
    case 2: return __fsub_rn(kPi, __fsub_rn(z, kPiLo));
    default: return __fsub_rn(__fsub_rn(z, kPiLo), kPi);
  }
}

// theta - a^{-1} b for one system (a row-major 3x3): the reference's
// adjugate form (_solve3x3), each p q - r t and the determinant's sums
// fused as written, theta_i - s_i * (1 / det) one fused multiply-add; of
// x1's and x2's sums the b1 product is fused for one system (the
// reference's scalar code), the b0 product for a batch.
__device__ __forceinline__ float cof(float p, float q, float r, float t) {
  return __fmaf_rn(p, q, -__fmul_rn(r, t));
}

__device__ __forceinline__ float pair(float c0, float b0, float c1, float b1,
                                      bool one_system) {
  return one_system ? __fmaf_rn(c1, b1, __fmul_rn(c0, b0))
                    : __fmaf_rn(c0, b0, __fmul_rn(c1, b1));
}

__device__ __forceinline__ void lm_update3(const float* t, const float* m,
                                           const float* v, bool one_system,
                                           float* out) {
  const float a00 = m[0], a01 = m[1], a02 = m[2], a10 = m[3], a11 = m[4],
              a12 = m[5], a20 = m[6], a21 = m[7], a22 = m[8];
  const float c00 = cof(a11, a22, a12, a21), c01 = cof(a12, a20, a10, a22),
              c02 = cof(a10, a21, a11, a20);
  const float det = __fmaf_rn(a02, c02, __fmaf_rn(a00, c00,
                                                  __fmul_rn(a01, c01)));
  const float d = fabsf(det) < 1e-30f ? (det < 0.0f ? -1e-30f : 1e-30f)
                                      : det;
  const float inv = __fdiv_rn(1.0f, d);
  const float c10 = cof(a02, a21, a01, a22), c11 = cof(a00, a22, a02, a20),
              c12 = cof(a01, a20, a00, a21);
  const float c20 = cof(a01, a12, a02, a11), c21 = cof(a02, a10, a00, a12),
              c22 = cof(a00, a11, a01, a10);
  const float b0 = v[0], b1 = v[1], b2 = v[2];
  const float s0 = __fmaf_rn(c20, b2, __fmaf_rn(c00, b0, __fmul_rn(c10, b1)));
  const float s1 = __fmaf_rn(c21, b2, pair(c01, b0, c11, b1, one_system));
  const float s2 = __fmaf_rn(c22, b2, pair(c02, b0, c12, b1, one_system));
  out[0] = __fmaf_rn(-inv, s0, t[0]);
  out[1] = __fmaf_rn(-inv, s1, t[1]);
  out[2] = __fmaf_rn(-inv, s2, t[2]);
}

// ---- the logistic solve's and the guarded inverse's LU (OpenBLAS) --------
// sgetrf (unblocked, left-looking sgetf2) and strsm on the unit lower and
// the upper factor, as core/refmath.py::lu_solve; the library runs on the
// reference's thread, which flushes subnormals (DAZ and FTZ): the operands
// are flushed as they are read, and every float result is flushed.
constexpr int kLuMax = 7;

// sdot of x (stride 1 here) and y: pairs fma(x0, y0, x1 * y1) added into a
// double from zero, an odd last product alone, rounded to float once.
__device__ float lu_strided_dot(const float* x, const float* y, int n) {
  double acc = 0.0;
  int p = 0;
  for (; p + 1 < n; p += 2)
    acc = __dadd_rn(acc, (double)fma_ftz(
                             x[p], y[p], daz(__fmul_rn(x[p + 1], y[p + 1]))));
  if (n & 1) acc = __dadd_rn(acc, (double)daz(__fmul_rn(x[n - 1], y[n - 1])));
  return daz(__double2float_rn(acc));
}

// y - sum_c a[c] x[c], the sum one fused multiply-add a term from zero.
__device__ float lu_chain(float y, const float* a, const float* x, int from,
                          int to) {
  float acc = 0.0f;
  for (int c = from; c < to; ++c) acc = fma_ftz(a[c], x[c], acc);
  return daz(__fsub_rn(y, acc));
}

// sgetrf of a [k][k] (flushed operands) in place, its pivots in piv.
__device__ void lu_factor(int k, float (*a)[kLuMax], int* piv) {
  float col[kLuMax];
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
    if (t != 0.0f && fabsf(t) >= kMinNorm) {
      for (int c = 0; c <= j; ++c) {
        const float u = a[j][c];
        a[j][c] = a[p][c];
        a[p][c] = u;
      }
      const float rcp = daz(__fdiv_rn(1.0f, t));
      for (int q = j + 1; q < k; ++q) a[q][j] = daz(__fmul_rn(a[q][j], rcp));
    }
  }
}

// x (in: the right-hand side, flushed; out: the solution) by strsm on the
// factors of lu_factor: the rows in blocks of 4, 2, 1.
__device__ void lu_apply(int k, float (*a)[kLuMax], const int* piv, float* x) {
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
    for (int r = lo[b]; r < hi[b]; ++r) x[r] = lu_chain(x[r], a[r], x, 0, lo[b]);
    for (int i = lo[b]; i < hi[b]; ++i)
      for (int q = i + 1; q < hi[b]; ++q)
        x[q] = fma_ftz(-x[i], a[q][i], x[q]);
  }
  for (int b = nb - 1; b >= 0; --b) {  // the upper factor, from the bottom
    for (int r = lo[b]; r < hi[b]; ++r) x[r] = lu_chain(x[r], a[r], x, hi[b], k);
    for (int i = hi[b] - 1; i >= lo[b]; --i) {
      x[i] = daz(__fmul_rn(x[i], daz(__fdiv_rn(1.0f, a[i][i]))));
      for (int q = lo[b]; q < i; ++q) x[q] = fma_ftz(-x[i], a[q][i], x[q]);
    }
  }
}

// jnp.linalg.cholesky's lower factor lo [3][3] (row-major, zero above the
// diagonal) of symmetric a [3][3] (flushed) as jaxlib's lapack_spotrf_ffi
// computes it (SciPy's OpenBLAS spotf2_L; core/refmath.py::chol3): column
// j's pivot a_jj - sdot of row j and its IEEE root, the entries below it
// a_ij - the sgemv chain times the float32 1 / l_jj; false where a pivot
// is not above zero (jax then fills the factor with NaN).
__device__ bool chol3(const float* a, float* lo) {
  bool ok = true;
  for (int k = 0; k < 9; ++k) lo[k] = 0.0f;
  for (int j = 0; j < 3; ++j) {
    float ajj = a[4 * j];
    if (j) ajj = daz(__fsub_rn(ajj, lu_strided_dot(lo + 3 * j, lo + 3 * j, j)));
    ok = ok && !(ajj <= 0.0f);
    const float ljj = __fsqrt_rn(ajj > 0.0f ? ajj : 1.0f);
    lo[4 * j] = ajj > 0.0f ? ljj : ajj;
    if (j < 2) {
      const float rcp = daz(__fdiv_rn(1.0f, ljj));
      for (int i = j + 1; i < 3; ++i) {
        float b = a[3 * i + j];
        if (j) b = lu_chain(b, lo + 3 * i, lo + 3 * j, 0, j);
        lo[3 * i + j] = daz(__fmul_rn(b, rcp));
      }
    }
  }
  return ok;
}

// ---- the 3 x 3 symmetric eigenvalues of jaxlib's LAPACK ------------------
// jnp.linalg.eigvalsh on the CPU: ssyevd's scaling, ssytd2's reflector
// (the SkylakeX ssymv / sdot / saxpy / ssyr2 kernels' fused multiply-adds),
// ssteqr's implicit QL / QR with slartg rotations and slaev2 on 2 x 2
// blocks, every result flushed; core/refmath.py::eigvalsh3 (whose table
// says how it was read) runs the same steps elementwise.
__device__ __forceinline__ float la_mul(float a, float b) { return daz(__fmul_rn(a, b)); }
__device__ __forceinline__ float la_div(float a, float b) { return daz(__fdiv_rn(a, b)); }
__device__ __forceinline__ float la_add(float a, float b) { return daz(__fadd_rn(a, b)); }
__device__ __forceinline__ float la_sub(float a, float b) { return daz(__fsub_rn(a, b)); }
__device__ __forceinline__ float la_sqrt(float a) { return __fsqrt_rn(daz(a)); }
// torch.maximum's NaN rule
__device__ __forceinline__ float la_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

constexpr float kLaEps = 0x1p-24f;
constexpr float kLaEps2 = 0x1p-48f;
constexpr float kLaSafmin = 0x1p-126f;
constexpr float kLaSafmax = 0x1p126f;
constexpr float kLaSsfmin = 0x1p-15f;  // sqrt(safmin) / eps^2
constexpr float kLaSsfmax = 0x1.555556p61f;  // sqrt(safmax) / 3

__device__ float la_slapy2(float x, float y) {
  if (isnan(y)) return y;
  if (isnan(x)) return x;
  const float ax = fabsf(x), ay = fabsf(y);
  const float w = fmaxf(ax, ay), z = fminf(ax, ay);
  if (z == 0.0f || w > 3.40282347e38f) return w;
  const float q = la_div(z, w);
  return la_mul(w, la_sqrt(la_add(1.0f, la_mul(q, q))));
}

__device__ void la_slae2(float a, float b, float c, float* rt1, float* rt2) {
  const float sm = la_add(a, c), adf = fabsf(la_sub(a, c));
  const float ab = fabsf(la_add(b, b));
  const bool big = fabsf(a) > fabsf(c);
  const float acmx = big ? a : c, acmn = big ? c : a;
  float rt;
  if (adf > ab) {
    const float q = la_div(ab, adf);
    rt = la_mul(adf, la_sqrt(la_add(1.0f, la_mul(q, q))));
  } else if (adf < ab) {
    const float q = la_div(adf, ab);
    rt = la_mul(ab, la_sqrt(la_add(1.0f, la_mul(q, q))));
  } else {
    rt = la_mul(ab, 0x1.6a09e6p0f);  // sqrt(2) in float32
  }
  if (sm < 0.0f || sm > 0.0f) {
    *rt1 = la_mul(0.5f, sm < 0.0f ? la_sub(sm, rt) : la_add(sm, rt));
    *rt2 = la_sub(la_mul(la_div(acmx, *rt1), acmn), la_mul(la_div(b, *rt1), b));
  } else {
    *rt1 = la_mul(0.5f, rt);
    *rt2 = la_mul(-0.5f, rt);
  }
}

__device__ void la_slartg(float f, float g, float* c, float* s, float* r) {
  const float f1 = fabsf(f), g1 = fabsf(g);
  const float rtmin = 0x1p-63f, rtmax = 0x1.6a09e6p62f;  // sqrt(safmin), sqrt(safmax / 2)
  if (g == 0.0f) {
    *c = 1.0f, *s = 0.0f, *r = f;
  } else if (f == 0.0f) {
    *c = 0.0f, *s = copysignf(1.0f, g), *r = g1;
  } else if (f1 > rtmin && f1 < rtmax && g1 > rtmin && g1 < rtmax) {
    const float d = la_sqrt(la_add(la_mul(f, f), la_mul(g, g)));
    *c = la_div(f1, d);
    *r = copysignf(d, f);
    *s = la_div(g, *r);
  } else {
    const float u = fminf(kLaSafmax, la_max(fmaxf(f1, kLaSafmin), g1));
    const float fs = la_div(f, u), gs = la_div(g, u);
    const float d = la_sqrt(la_add(la_mul(fs, fs), la_mul(gs, gs)));
    *c = la_div(fabsf(fs), d);
    const float rr = copysignf(d, f);
    *s = la_div(gs, rr);
    *r = la_mul(rr, u);
  }
}

// ssteqr's scaling of a block by its largest magnitude anorm
__device__ __forceinline__ int la_scale(float anorm, float* down, float* up) {
  const int code = anorm > kLaSsfmax ? 1 : anorm < kLaSsfmin ? 2 : 0;
  const float to = code == 1 ? kLaSsfmax : kLaSsfmin;
  *down = la_div(to, anorm);
  *up = la_div(anorm, to);
  return code;
}

__device__ __forceinline__ bool la_small(float e, float a, float b) {
  return la_mul(fabsf(e), fabsf(e)) <=
         la_add(la_mul(la_mul(kLaEps2, fabsf(a)), fabsf(b)), kLaSafmin);
}

// the eigenvalues of a 2 x 2 block [[a, b], [b, c]] split off by ssteqr
__device__ void la_block2(float a, float c, float b, float* x, float* y) {
  const float anorm = la_max(la_max(fabsf(c), fabsf(a)), fabsf(b));
  if (anorm == 0.0f) {
    *x = a, *y = c;
    return;
  }
  float down, up;
  const int code = la_scale(anorm, &down, &up);
  if (code) a = la_mul(a, down), c = la_mul(c, down), b = la_mul(b, down);
  if (fabsf(c) < fabsf(a)) {
    const float t = a;
    a = c, c = t;
  }
  if (la_small(b, a, c)) {
    *x = a, *y = c;
  } else {
    la_slae2(a, b, c, x, y);
  }
  if (code) *x = la_mul(*x, up), *y = la_mul(*y, up);
}

// the eigenvalues of the unreduced 3 x 3 block; false where 90 sweeps do
// not converge
__device__ bool la_block3(float* d, float* e) {
  const float anorm = la_max(la_max(la_max(la_max(fabsf(d[2]), fabsf(d[0])),
                                           fabsf(e[0])), fabsf(d[1])),
                             fabsf(e[1]));
  if (anorm == 0.0f) return true;
  float down, up;
  const int code = la_scale(anorm, &down, &up);
  if (code) {
    for (int i = 0; i < 3; ++i) d[i] = la_mul(d[i], down);
    for (int i = 0; i < 2; ++i) e[i] = la_mul(e[i], down);
  }
  if (fabsf(d[2]) < fabsf(d[0])) {  // QR: the block read backwards
    float t = d[0];
    d[0] = d[2], d[2] = t;
    t = e[0];
    e[0] = e[1], e[1] = t;
  }
  bool ok = true;
  for (int sweep = 0;; ++sweep) {
    const bool t0 = la_small(e[0], d[0], d[1]), t1 = la_small(e[1], d[1], d[2]);
    if (t0) {
      if (!t1) la_slae2(d[1], e[1], d[2], &d[1], &d[2]);
      break;
    }
    if (t1) {
      la_slae2(d[0], e[0], d[1], &d[0], &d[1]);
      break;
    }
    if (sweep == 90) {
      ok = false;
      break;
    }
    float p = d[0];
    float g = la_div(la_sub(d[1], p), la_mul(2.0f, e[0]));
    float r = la_slapy2(g, 1.0f);
    g = la_add(la_sub(d[2], p), la_div(e[0], la_add(g, copysignf(r, g))));
    float s = 1.0f, c = 1.0f;
    p = 0.0f;
    float f = la_mul(s, e[1]), bb = la_mul(c, e[1]);
    la_slartg(g, f, &c, &s, &r);
    g = la_sub(d[2], p);
    r = la_add(la_mul(la_sub(d[1], g), s), la_mul(la_mul(2.0f, c), bb));
    p = la_mul(s, r);
    const float n2 = la_add(g, p);
    g = la_sub(la_mul(c, r), bb);
    f = la_mul(s, e[0]), bb = la_mul(c, e[0]);
    la_slartg(g, f, &c, &s, &r);
    const float ne1 = r;
    g = la_sub(d[1], p);
    r = la_add(la_mul(la_sub(d[0], g), s), la_mul(la_mul(2.0f, c), bb));
    p = la_mul(s, r);
    const float n1 = la_add(g, p);
    g = la_sub(la_mul(c, r), bb);
    d[0] = la_sub(d[0], p), d[1] = n1, d[2] = n2;
    e[0] = g, e[1] = ne1;
  }
  if (code)
    for (int i = 0; i < 3; ++i) d[i] = la_mul(d[i], up);
  return ok;
}

// the eigenvalues w (in no order) of symmetric h (row-major 3 x 3) as
// jnp.linalg.eigvalsh; NaN where the library reports no convergence or h
// is not finite
__device__ void la_eigvalsh3(const float* hin, float* w) {
  float h[9];
  bool finite = true;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float x = la_mul(la_add(daz(hin[3 * i + j]), daz(hin[3 * j + i])), 0.5f);
      h[3 * i + j] = x;
      finite = finite && isfinite(x);
    }
  float anrm = fabsf(h[0]);
  const int low[5] = {3, 4, 6, 7, 8};
  for (int k = 0; k < 5; ++k) anrm = la_max(anrm, fabsf(h[low[k]]));
  const float rmin = 0x1.6a09e6p-52f, rmax = 0x1.6a09e6p51f;  // sqrt(smlnum), sqrt(bignum)
  const bool up = anrm > rmax;
  const bool scale = (anrm > 0.0f && anrm < rmin) || up;
  const float sigma = la_div(up ? rmax : rmin, anrm);
  if (scale)
    for (int k = 0; k < 9; ++k) h[k] = la_mul(h[k], sigma);
  const float a11 = h[0], a22 = h[4], a32 = h[7], a33 = h[8];
  float alpha = h[3], x = h[6];
  float d[3] = {a11, a22, a33}, e[2] = {alpha, a32};
  if (fabsf(x) != 0.0f) {  // ssytd2, i = 1: slarfg(2, a21, a31)
    float beta = -copysignf(la_slapy2(alpha, fabsf(x)), alpha);
    int knt = 0;
    if (fabsf(beta) < 0x1p-102f) {  // slarfg's safmin / eps
      do {
        x = la_mul(x, 0x1p102f);
        beta = la_mul(beta, 0x1p102f);
        alpha = la_mul(alpha, 0x1p102f);
        ++knt;
      } while (fabsf(beta) < 0x1p-102f && knt < 20);
      beta = -copysignf(la_slapy2(alpha, fabsf(x)), alpha);
    }
    const float tau = la_div(la_sub(beta, alpha), beta);
    const float v2 = la_mul(x, la_div(1.0f, la_sub(alpha, beta)));
    for (int k = 0; k < knt; ++k) beta = la_mul(beta, 0x1p-102f);
    float y0 = ref_fma(tau, a22, 0.0f), y1 = ref_fma(tau, a32, 0.0f);
    y0 = ref_fma(tau, ref_fma(a32, v2, 0.0f), y0);
    y1 = ref_fma(la_mul(tau, v2), a33, y1);
    const float al = la_mul(la_mul(-0.5f, tau), ref_fma(y0, 1.0f, la_mul(y1, v2)));
    const float w0 = ref_fma(al, 1.0f, y0), w1 = ref_fma(al, v2, y1);
    float b22 = ref_fma(-1.0f, w0, a22), b32 = ref_fma(-1.0f, w1, a32);
    b22 = ref_fma(-w0, 1.0f, b22);
    b32 = ref_fma(-w0, v2, b32);
    float b33 = ref_fma(-v2, w1, a33);
    b33 = ref_fma(-w1, v2, b33);
    d[1] = b22, d[2] = b33, e[0] = beta, e[1] = b32;
  }
  auto split = [&](float ek, float da, float db) {
    const float t = fabsf(ek);
    return t == 0.0f ||
           t <= la_mul(la_mul(la_sqrt(fabsf(da)), la_sqrt(fabsf(db))), kLaEps);
  };
  const bool s0 = split(e[0], d[0], d[1]), s1 = split(e[1], d[1], d[2]);
  bool ok = true;
  if (s0 && !s1) {
    la_block2(d[1], d[2], e[1], &d[1], &d[2]);
  } else if (!s0 && s1) {
    la_block2(d[0], d[1], e[0], &d[0], &d[1]);
  } else if (!s0 && !s1) {
    ok = la_block3(d, e);
  }
  const float rs = la_div(1.0f, sigma);
  for (int i = 0; i < 3; ++i) {
    w[i] = scale ? la_mul(d[i], rs) : d[i];
    if (!ok || !finite) w[i] = NAN;
  }
  if (isnan(w[0]) || isnan(w[1]) || isnan(w[2])) w[0] = w[1] = w[2] = NAN;
}

}  // namespace
