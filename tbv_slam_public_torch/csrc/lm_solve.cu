// The registration's Levenberg-Marquardt solve, one launch per solve, for
// sm_90a.
//
// Not a TPU kernel: the JAX package's _lm_solve (ops/registration.py, with
// _cost_grad_hess, _residual_terms and _rho_and_weight) is left to XLA,
// which fuses it.  The port's plain version (ops/registration.py::
// _lm_solve_reference) runs each of its operations as its own launch:
// about 21 x (a few dozen) launches a solve, each a few microseconds of
// host dispatch for a few microseconds of device work.  This kernel runs the
// whole solve (the initial cost, gradient and Hessian, then max_iter
// iterations of damping, the step, the candidate's residuals, robust loss,
// weights and sums, accept or reject) in one launch, bit-equal to the plain
// version: every operation below is the plain version's, each multiply,
// add and fused multiply-add an explicit __f*_rn / __fma*_rn intrinsic, and
// refmath.cuh supplies the reference's sincos, log1p, IEEE sqrt and LM step.
//
// Design.  One CTA (256 threads) a batch row; the row's inputs are staged
// into shared memory once with asynchronous copies (cp.async) when they fit
// (about 80 KB at T = 4, C = 512 with P2D's sqrt-information), else read
// from device memory.  The 13 sums of an evaluation (the cost and the 12
// entries of J^T [J | r]) follow the plain version's pairwise tree
// (_row_sums: leaves padded with zeros to a power of two W, each even
// element added to the odd one after it): thread t holds the aligned run of
// L = W / min(256, W) leaves from t L, reduces it in registers level by
// level, then __shfl_xor_sync levels (a + b rounds as b + a) and a tree over
// the warps' sums in shared memory finish the same tree.  Thread 0 runs the
// 3x3 step and the accept / reject and hands the candidate to the block
// through shared memory.
//
// Bound: operations by count (about 50 float32 operations a leaf an
// evaluation, 21 evaluations) and bytes by count (the row's inputs read
// once) are both well under a microsecond at the paths' shapes; the solve
// is a chain of max_iter + 1 dependent block-wide reductions and 3x3 steps,
// so its time is that chain's latency, not either bound.
#include <cuda_pipeline.h>

#include "refmath.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLogLeaves = 7;  // W <= 256 * 128 leaves a row
constexpr size_t kStageBytes = 200 * 1024;

enum Cost { kP2L = 0, kP2D = 1, kP2P = 2 };
enum Loss { kNone = 0, kHuber, kCauchy, kSoftLOne, kTukey, kCombined };

struct Params {
  const float* theta0;        // [B, 3]
  const float* src;           // [B, C, 2] source cell means
  const float* tm;            // [B, T, C, 2] target means (world)
  const float* tn;            // [B, T, C, 2] target normals (P2L), or null
  const float* weight;        // [B, T, C]
  const unsigned char* mask;  // [B, T, C]
  const float* si;            // [B, T, C, 2, 2] sqrt-information (P2D), or null
  const float* guess;         // [B, 3] prior mean, or null: no prior
  const float* sqrt_info;     // [3, 3]
  const float* pw;            // [B] prior weight
  float* out_theta;           // [B, 3]
  float* out_cost;            // [B]
  float* out_rel;             // [B]
  int T, C, R, N, nthr, cost, loss, max_iter, one_system, stage;
  float k0, k1, k2, k3;  // the loss's float32 constants (lm_solve.py)
  float init_lambda;
};

struct Row {
  const float* src;
  const float* tm;
  const float* tn;
  const float* weight;
  const unsigned char* mask;
  const float* si;
};

// torch.clamp(x, min=lo) / (x, max=hi): a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// rho(s) and the IRLS weight, as ops/registration.py::_rho_and_weight
__device__ __forceinline__ void rho_weight(float s, const Params& p,
                                           float* rho, float* w) {
  switch (p.loss) {
    case kHuber: {  // k0 = delta^2, k1 = 2 delta, k2 = -delta^2, k3 = delta
      const float sq = __fsqrt_rn(daz(clamp_min(s, (float)1e-20)));
      const bool inside = s <= p.k0;
      *rho = inside ? s : __fmaf_rn(sq, p.k1, p.k2);
      *w = inside ? 1.0f : __fdiv_rn(p.k3, sq);
      return;
    }
    case kCauchy: {  // k0 = 1 / b, k1 = b
      *rho = __fmul_rn(p.k1, ref_log1p(__fmul_rn(s, p.k0)));
      *w = __fdiv_rn(1.0f, __fmaf_rn(s, p.k0, 1.0f));
      return;
    }
    case kSoftLOne: {  // k0 = 1 / b, k1 = 2 b
      const float t = __fsqrt_rn(daz(__fmaf_rn(s, p.k0, 1.0f)));
      *rho = __fmul_rn(__fsub_rn(t, 1.0f), p.k1);
      *w = __fdiv_rn(1.0f, t);
      return;
    }
    case kTukey: {  // k0 = 1 / b, k1 = b / 3
      const float u = clamp_min(__fmaf_rn(-s, p.k0, 1.0f), 0.0f);
      const float u2 = __fmul_rn(u, u);
      *rho = __fmul_rn(__fmaf_rn(-u, u2, 1.0f), p.k1);
      *w = u2;
      return;
    }
    case kCombined: {
      const float g = ref_log1p(s);
      const float gp = __fdiv_rn(1.0f, __fadd_rn(s, 1.0f));
      const float sg = __fsqrt_rn(daz(clamp_min(g, (float)1e-20)));
      const bool in = g <= 1.0f;
      *rho = in ? g : __fsub_rn(__fmul_rn(2.0f, sg), 1.0f);
      *w = __fmul_rn(in ? 1.0f : __fdiv_rn(1.0f, sg), gp);
      return;
    }
    default:
      *rho = s;
      *w = 1.0f;
  }
}

// The 13 summands of leaf i ((t C + j) R + r): the cost (at r = 0) and
// (w J_a) [J | r]_b, as _residual_terms and _cost_grad_hess compute them;
// zeros past the row's N leaves.
__device__ __forceinline__ void leaf(const Params& p, const Row& d, int i,
                                     float th0, float th1, float s, float c,
                                     float* v) {
  if (i >= p.N) {
#pragma unroll
    for (int m = 0; m < 13; ++m) v[m] = 0.0f;
    return;
  }
  const int q = i / p.R, r = i - q * p.R, j = q % p.C;
  const float ux = d.src[2 * j], uy = d.src[2 * j + 1];
  const float dy = __fmaf_rn(c, ux, -__fmul_rn(s, uy));
  const float wx = __fadd_rn(dy, th0);
  const float wy = __fadd_rn(__fmaf_rn(s, ux, __fmul_rn(c, uy)), th1);
  const float dx = __fmaf_rn(-s, ux, -__fmul_rn(c, uy));
  const float e0 = __fsub_rn(wx, d.tm[2 * q]);
  const float e1 = __fsub_rn(wy, d.tm[2 * q + 1]);
  float J[3], res, sq;
  if (p.cost == kP2L) {
    const float n0 = d.tn[2 * q], n1 = d.tn[2 * q + 1];
    res = __fmaf_rn(n1, e1, __fmul_rn(n0, e0));
    J[0] = n0;
    J[1] = n1;
    J[2] = __fmaf_rn(n0, dx, __fmul_rn(n1, dy));
    sq = __fmul_rn(res, res);
  } else if (p.cost == kP2D) {
    const float* u = d.si + 4 * q;  // u[row * 2 + col]
    const float r0 = __fmaf_rn(u[1], e1, __fmul_rn(u[0], e0));
    const float r1 = __fmaf_rn(u[3], e1, __fmul_rn(u[2], e0));
    const float a = u[2 * r], b = u[2 * r + 1];
    // row r of u [[1, 0, dx], [0, 1, dy]]
    J[0] = __fmaf_rn(b, 0.0f, __fmul_rn(a, 1.0f));
    J[1] = __fmaf_rn(b, 1.0f, __fmul_rn(a, 0.0f));
    J[2] = __fmaf_rn(b, dy, __fmul_rn(a, dx));
    res = r == 0 ? r0 : r1;
    sq = __fmaf_rn(r1, r1, __fmul_rn(r0, r0));
  } else {  // P2P
    res = r == 0 ? e0 : e1;
    J[0] = r == 0 ? 1.0f : 0.0f;
    J[1] = r == 0 ? 0.0f : 1.0f;
    J[2] = r == 0 ? dx : dy;
    sq = __fmaf_rn(e1, e1, __fmul_rn(e0, e0));
  }
  float rho, wi;
  rho_weight(sq, p, &rho, &wi);
  const bool m = d.mask[q] != 0;
  const float wt = d.weight[q];
  const float w = m ? __fmul_rn(wt, wi) : 0.0f;
  v[0] = (m && r == 0) ? __fmul_rn(wt, rho) : 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float wa = __fmul_rn(w, J[a]);
#pragma unroll
    for (int b = 0; b < 3; ++b) v[1 + 4 * a + b] = __fmul_rn(wa, J[b]);
    v[4 + 4 * a] = __fmul_rn(wa, res);
  }
}

// The 13 sums of the row at theta (shared), in _row_sums's pairwise tree;
// valid in thread 0.
template <int LOG_L>
__device__ void evaluate(const Params& p, const Row& d, const float* theta,
                         float* red, float* out) {
  constexpr int L = 1 << LOG_L;
  const int tid = threadIdx.x;
  const float th0 = theta[0], th1 = theta[1];
  float s, c;
  ref_sincos(theta[2], &s, &c);
  float v[13];
  if (tid < p.nthr) {
    float stack[LOG_L > 0 ? LOG_L : 1][13];
    const int base = tid * L;
    for (int k = 0; k < L; ++k) {
      float x[13];
      leaf(p, d, base + k, th0, th1, s, c, x);
      bool carry = true;  // k's low set bits: subtrees that x completes
#pragma unroll
      for (int lvl = 0; lvl < LOG_L; ++lvl) {
        if (carry) {
          if ((k >> lvl) & 1) {
#pragma unroll
            for (int m = 0; m < 13; ++m) x[m] = __fadd_rn(stack[lvl][m], x[m]);
          } else {
#pragma unroll
            for (int m = 0; m < 13; ++m) stack[lvl][m] = x[m];
            carry = false;
          }
        }
      }
      if (carry) {  // k = L - 1: the run's root
#pragma unroll
        for (int m = 0; m < 13; ++m) v[m] = x[m];
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < 13; ++m) v[m] = 0.0f;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o < p.nthr) {
#pragma unroll
      for (int m = 0; m < 13; ++m)
        v[m] = __fadd_rn(v[m], __shfl_xor_sync(0xffffffffu, v[m], o));
    }
  }
  if (p.nthr > 32) {
    const int nw = p.nthr >> 5;
    if ((tid & 31) == 0 && (tid >> 5) < nw) {
#pragma unroll
      for (int m = 0; m < 13; ++m) red[(tid >> 5) * 13 + m] = v[m];
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = nw; w > 1; w >>= 1)
        for (int k = 0; k < w / 2; ++k)
#pragma unroll
          for (int m = 0; m < 13; ++m)
            red[k * 13 + m] = __fadd_rn(red[2 * k * 13 + m],
                                        red[(2 * k + 1) * 13 + m]);
#pragma unroll
      for (int m = 0; m < 13; ++m) out[m] = red[m];
    }
  } else if (tid == 0) {
#pragma unroll
    for (int m = 0; m < 13; ++m) out[m] = v[m];
  }
}

// cost, g and H from the 13 sums at th, plus the prior's terms
// (_prior_terms: each sum one fused multiply-add a term, in order from 0)
__device__ void finish(const Params& p, int b, const float* th,
                       const float* sums, float* cost, float* g, float* H) {
  *cost = __fmul_rn(0.5f, sums[0]);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) H[3 * a + k] = sums[1 + 4 * a + k];
    g[a] = sums[4 + 4 * a];
  }
  if (p.guess == nullptr) return;
  const float* S = p.sqrt_info;
  const float pw = p.pw[b];
  float d[3], pr[3], jp[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = __fsub_rn(th[k], p.guess[3 * b + k]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = __fmaf_rn(d[k], S[3 * i + k], acc);
    pr[i] = __fmul_rn(acc, pw);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) jp[k] = __fmul_rn(S[k], pw);
  float pc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) pc = __fmaf_rn(pr[k], pr[k], pc);
  *cost = __fadd_rn(*cost, __fmul_rn(0.5f, pc));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        acc = __fmaf_rn(jp[3 * k + a], jp[3 * k + e], acc);
      H[3 * a + e] = __fadd_rn(H[3 * a + e], acc);
    }
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = __fmaf_rn(jp[3 * k + a], pr[k], acc);
    g[a] = __fadd_rn(g[a], acc);
  }
}

__device__ void stage_async(float* dst, const float* src, long long n) {
  for (long long i = threadIdx.x; i < n; i += kThreads)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
}

template <int LOG_L>
__global__ void __launch_bounds__(kThreads) lm_solve_kernel(const Params p) {
  extern __shared__ float4 dyn[];
  __shared__ float sh_theta[3];
  __shared__ float red[kWarps * 13];
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long tc = (long long)p.T * p.C;
  Row d;
  d.src = p.src + (long long)b * p.C * 2;
  d.tm = p.tm + b * tc * 2;
  d.tn = p.tn ? p.tn + b * tc * 2 : nullptr;
  d.weight = p.weight + b * tc;
  d.mask = p.mask + b * tc;
  d.si = p.si ? p.si + b * tc * 4 : nullptr;
  if (p.stage) {
    float* s = reinterpret_cast<float*>(dyn);
    Row st;
    st.src = s;
    stage_async(s, d.src, 2LL * p.C);
    s += 2 * p.C;
    st.tm = s;
    stage_async(s, d.tm, 2 * tc);
    s += 2 * tc;
    st.tn = nullptr;
    if (d.tn) {
      st.tn = s;
      stage_async(s, d.tn, 2 * tc);
      s += 2 * tc;
    }
    st.si = nullptr;
    if (d.si) {
      st.si = s;
      stage_async(s, d.si, 4 * tc);
      s += 4 * tc;
    }
    st.weight = s;
    stage_async(s, d.weight, tc);
    s += tc;
    __pipeline_commit();
    unsigned char* mk = reinterpret_cast<unsigned char*>(s);
    for (long long i = tid; i < tc; i += kThreads) mk[i] = d.mask[i];
    st.mask = mk;
    __pipeline_wait_prior(0);
    d = st;
  }
  float theta[3], g[3], H[9], cur = 0.0f, lam = p.init_lambda, rel = 1.0f;
  float sums[13];
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sh_theta[k] = theta[k] = p.theta0[3 * b + k];
  }
  __syncthreads();
  evaluate<LOG_L>(p, d, sh_theta, red, sums);
  __syncthreads();
  if (tid == 0) finish(p, b, theta, sums, &cur, g, H);
  for (int it = 0; it < p.max_iter; ++it) {
    float cand[3];
    if (tid == 0) {
      // H + diag(fma(lam, diag H, 1e-12)), zeros added off the diagonal
      float A[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          A[3 * i + k] = __fadd_rn(
              H[3 * i + k],
              i == k ? __fmaf_rn(lam, H[4 * i], (float)1e-12) : 0.0f);
      lm_update3(theta, A, g, p.one_system != 0, cand);
#pragma unroll
      for (int k = 0; k < 3; ++k) sh_theta[k] = cand[k];
    }
    __syncthreads();
    evaluate<LOG_L>(p, d, sh_theta, red, sums);
    __syncthreads();
    if (tid == 0) {
      float cc, cg[3], cH[9];
      finish(p, b, cand, sums, &cc, cg, cH);
      const bool acc = cc < cur;
      if (acc) {
#pragma unroll
        for (int k = 0; k < 3; ++k) theta[k] = cand[k], g[k] = cg[k];
#pragma unroll
        for (int k = 0; k < 9; ++k) H[k] = cH[k];
        rel = __fdiv_rn(__fsub_rn(cur, cc), clamp_min(cur, (float)1e-20));
        cur = cc;
      }
      lam = acc ? clamp_min(__fmul_rn(lam, 0.5f), (float)1e-9)
                : clamp_max(__fmul_rn(lam, 4.0f), (float)1e6);
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p.out_theta[3 * b + k] = theta[k];
    p.out_cost[b] = cur;
    p.out_rel[b] = rel;
  }
}

template <int LOG_L>
int launch(const Params& p, int rows, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lm_solve_kernel<LOG_L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lm_solve_kernel<LOG_L><<<rows, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// (theta [B, 3], cost [B], rel_dec [B]) of _lm_solve for B rows of T x C
// associations; tn, si, guess (with sqrt_info, pw) may be null as the cost
// and the prior say.  k0..k3 are the loss's float32 constants.  Returns a
// CUDA error code (cudaErrorInvalidValue past 256 x 2^7 leaves a row).
extern "C" int lm_solve_launch(
    const void* theta0, const void* src, const void* tm, const void* tn,
    const void* weight, const void* mask, const void* si, const void* guess,
    const void* sqrt_info, const void* pw, void* out_theta, void* out_cost,
    void* out_rel, int rows, int T, int C, int cost, int loss, float k0,
    float k1, float k2, float k3, int max_iter, float init_lambda,
    int one_system, void* stream) {
  if (rows <= 0) return 0;
  Params p;
  p.theta0 = (const float*)theta0;
  p.src = (const float*)src;
  p.tm = (const float*)tm;
  p.tn = (const float*)tn;
  p.weight = (const float*)weight;
  p.mask = (const unsigned char*)mask;
  p.si = (const float*)si;
  p.guess = (const float*)guess;
  p.sqrt_info = (const float*)sqrt_info;
  p.pw = (const float*)pw;
  p.out_theta = (float*)out_theta;
  p.out_cost = (float*)out_cost;
  p.out_rel = (float*)out_rel;
  p.T = T;
  p.C = C;
  p.R = cost == kP2L ? 1 : 2;
  p.cost = cost;
  p.loss = loss;
  p.k0 = k0;
  p.k1 = k1;
  p.k2 = k2;
  p.k3 = k3;
  p.max_iter = max_iter;
  p.init_lambda = init_lambda;
  p.one_system = one_system;
  const long long n = (long long)T * C * p.R;
  long long w = 1;
  while (w < n) w <<= 1;
  p.N = (int)n;
  p.nthr = w < kThreads ? (int)w : kThreads;
  int log_l = 0;
  while ((1LL << log_l) * p.nthr < w) ++log_l;
  if (log_l > kMaxLogLeaves) return (int)cudaErrorInvalidValue;
  const long long tc = (long long)T * C;
  const size_t bytes = 4 * (2 * (size_t)C +
                            tc * (2 + (tn ? 2 : 0) + (si ? 4 : 0) + 1)) + tc;
  p.stage = bytes <= kStageBytes;
  const size_t smem = p.stage ? (bytes + 15) / 16 * 16 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (log_l) {
    case 0: return launch<0>(p, rows, smem, st);
    case 1: return launch<1>(p, rows, smem, st);
    case 2: return launch<2>(p, rows, smem, st);
    case 3: return launch<3>(p, rows, smem, st);
    case 4: return launch<4>(p, rows, smem, st);
    case 5: return launch<5>(p, rows, smem, st);
    case 6: return launch<6>(p, rows, smem, st);
    default: return launch<7>(p, rows, smem, st);
  }
}
