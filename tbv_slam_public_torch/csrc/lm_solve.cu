// The registration kernel, three entries over one device code for sm_90a:
// the window solve (register_window: association, LM solve and outer
// guards) as one launch a call, the LM solve alone on given associations
// (register_joint), and the cost evaluation (evaluate_cost and
// sampled_covariance: one association, then the cost at S poses over it).
//
// Not a TPU kernel: the JAX package's register_window, associate,
// _lm_solve, evaluate_cost and the vmapped sampled_covariance
// (ops/registration.py) are left to XLA, which fuses them.  The port's
// plain version (ops/registration.py::_register_window_reference, with
// _world_targets, associate and _lm_solve_reference;
// _evaluate_cost_reference and _sampled_covariance_reference) runs each of
// its operations as its own launch: about 40 launches an association and a
// few dozen an LM or cost evaluation, 8 outer iterations a window call.
// This kernel runs all of it after _world_targets in one launch, bit-equal
// to the plain version: every operation below is the plain version's, each
// multiply, add and fused multiply-add an explicit __f*_rn / __fma*_rn
// intrinsic, torch's comparison and NaN rules written out (argmin: the
// first NaN, else the first minimum), and refmath.cuh supplies the
// reference's sincos, log1p, IEEE sqrt and LM step.
//
// Bound: the work is small (at B = 1, T = 4, C = 512: a million masked
// distances an association, about 50 float32 operations a leaf an LM
// evaluation over 4,096 leaves) and the bytes smaller; a call is a chain of
// up to 8 associations and 8 x 21 dependent evaluations, each a reduction
// over the whole row followed by a 3x3 step (the evaluation entry: one
// association and S dependent cost reductions, S = 27 for the sampled
// covariance).  So its time is that chain's latency.  The design shortens
// each link and removes the launches between them:
//
// * A thread-block cluster of K CTAs (K a power of two <= 8, chosen by the
//   wrapper from B and the row's size) per batch row.  CTA k owns the
//   aligned k-th 1/K of the row's _row_sums leaves and computes, once per
//   outer iteration, the associations of those leaves into shared memory
//   (the target scan it needs staged there with cp.async; one at a time
//   when its leaves span several scans), so the evaluations read only
//   shared memory.
// * The 13 sums of an evaluation (the cost and the 12 entries of
//   J^T [J | r]) follow the plain version's pairwise tree (_row_sums: the
//   leaves padded with zeros to a power of two W, each even element added
//   to the odd one after it): each thread reduces its aligned run of leaves
//   in registers, __shfl_xor_sync levels and a tree over the warps' sums
//   (one warp, a lane a sum) finish the CTA's subtree, each CTA writes its
//   root to its shared-memory slot, one cluster.sync(), and every CTA reads
//   the K roots over distributed shared memory and adds the tree's top
//   log2 K levels itself.  So the sums do not depend on K.  The slot is
//   double-buffered on the evaluation's parity: a CTA rewrites a slot only
//   after every CTA has passed the next evaluation's barrier, so one
//   barrier an evaluation suffices.
// * Every CTA then runs the finish, the damping, the step and the
//   accept / reject itself on identical bits, so nothing is broadcast; the
//   outer guards likewise, and the cluster leaves the outer loop as soon as
//   the row is inactive (none of its outputs can change after that).
// * The evaluation entry (evaluation_kernel) associates once at the row's
//   pose, then evaluates the cost at all S poses (pose + offset_s) in one
//   pass over the records.  Its first design (the window entry's solve
//   loop reused) walked the S poses one after another: a thread wrote the
//   pose, each pass re-read every record, recomputed the sine and cosine
//   and ended at a __syncthreads and a cluster.sync, and thread 0 of CTA 0
//   folded each cost into the fit alone (0.103 ms at a 64-pair wave, most
//   of it 27 barrier-bound passes).  Now the S poses' sines and cosines are
//   computed once a launch into shared memory; a team of warps takes a
//   pose (the whole CTA at S = 1, a warp from S = 5), its lanes each an
//   aligned run of leaves, and holds kPoseGroup poses' partial sums at
//   once, so a record is read once a group.  The costs' trees are
//   _row_sums's (R = 2: each cell's term then a zero, which the first level
//   adds exactly, so _cost_only's tree over the cells), whatever K.  Besides
//   the barrier that publishes the pose table and the association's own,
//   there remain one warp-shuffle stage, one __syncthreads (the team's
//   warps' roots), one cluster.sync (the CTAs' roots) and the closing
//   cluster.sync, for all S poses together.
//   CTA 0 then adds the trees' top levels, a lane a pose; the fit's 10
//   sums take a lane each (refmath.dot's order: one flushed fused
//   multiply-add a sample, in sample order); and one thread forms the
//   sampled covariance from the fit (covariance(): the Hessian, the
//   convexity decision and the guarded inverse as jaxlib's LAPACK computes
//   them, refmath.cuh's la_eigvalsh3, lu_factor, lu_apply; the Censi
//   scaling from final_score and n_res read on the card), so a
//   sampled_covariance is this launch and the world_targets site, with no
//   library call and no host read.  Bound: one association, then the
//   latency of the passes' dependent adds; the S-fold barriers are gone.
//   The plain path's S-fold copies of the sources and associations and its
//   dense [B, T, C, Ct] differences are never made.  No TPU kernel is
//   replaced: XLA fused sampled_covariance's vmap and handed its 3 x 3
//   algebra to LAPACK on the host.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "refmath.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLogLeaves = 7;  // at most 128 leaves a thread
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr long long kSmemBytes = 200 * 1024;
constexpr int kChains = 4;        // independent argmin chains a thread
constexpr int kMaxDevices = 16;   // launch checks cached per device
constexpr int kMaxPoses = 64;     // the evaluation's S (steps^3 <= 64)
constexpr int kPoseGroup = 4;     // a team's poses in flight at once
constexpr int kMaxLogRun = 10;    // at most 1024 leaves a lane a pose

enum Cost { kP2L = 0, kP2D = 1, kP2P = 2 };
enum Loss { kNone = 0, kHuber, kCauchy, kSoftLOne, kTukey, kCombined };

struct Params {
  int window;             // 1: associate in the kernel (window, evaluation); 0: one solve on given associations
  int evaluate;           // 1: the evaluation entry (cost at S poses), no LM
  const float* theta0;    // [B, 3]
  const float* src;       // [B, C, 2] source cell means
  // solve: the associations [B, T, C, ...]
  const float* tm;            // target means (world)
  const float* tn;            // target normals (P2L), or null
  const float* weight;        // association weights
  const unsigned char* mask;  // association mask
  const float* si;            // [.., 2, 2] sqrt-information (P2D), or null
  // window: the source cells and the world-frame targets [B, T, Ct, ...]
  const float* src_normal;         // [B, C, 2]
  const float* src_ns;             // [B, C] nsamples
  const float* src_plan;           // [B, C] planarity
  const unsigned char* src_valid;  // [B, C]
  const float* tmw;                // [B, T, Ct, 2]
  const float* tnw;                // [B, T, Ct, 2]
  const float* tcw;                // [B, T, Ct, 2, 2] (P2D), or null
  const unsigned char* tvalid;     // [B, T, Ct]
  const float* t_ns;               // [B, T, Ct]
  const float* t_plan;             // [B, T, Ct]
  // the prior: guess [B, 3] (null: none), sqrt_info [3, 3], pw [B] (solve)
  const float* guess;
  const float* sqrt_info;
  const float* pw;
  // evaluation: S offsets [S, 3] (null: S = 1 at the pose itself) and the
  // fit's pseudo-inverse [10, S] (null: no fit)
  const float* offs;
  const float* pinv;
  float* out_theta;      // [B, 3]
  float* out_cost;       // [B]: the solve's cost, the window's score; [B, S] the costs
  float* out_rel;        // [B] (solve)
  float* out_q;          // [B, 10] the fit (evaluation with pinv)
  // evaluation with the covariance: final_score [B], n_res [B] in, cov
  // [B, 3, 3] and convex [B] out (null: no covariance)
  const float* final_score;
  const long long* n_res;
  float* out_cov;
  unsigned char* out_convex;
  float cov_scaler;
  float fallback[3];  // the default covariance's diagonal
  long long* out_nres;   // [B] (window, evaluation: the association count)
  long long* out_iters;  // [B] (window)
  int T, C, Ct, R, N, K, Wk, Qk, nthr, S;
  int team_warps, team_lanes;  // evaluation: warps a pose, lanes a tree
  int cost, loss, max_iter, one_system;
  float k0, k1, k2, k3;  // the loss's float32 constants (lm_solve.py)
  float init_lambda;
  int max_outer, min_outer, weight_option;
  float r2_first, r2, gate, reg, cov_scale, tol;  // float32 as torch rounds them
  // shared-memory layout: float offsets of the records' arrays and of the
  // staged target means, byte offsets of the mask and target validity
  int o_sx, o_sy, o_mx, o_my, o_w, o_nx, o_ny, o_u, o_txy;
  long long o_mask, o_tv;
};

// one CTA's associations (records) in shared memory, by local index
struct Rec {
  float *sx, *sy, *mx, *my, *w, *nx, *ny, *u;
  unsigned char* m;
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
      *w = daz(__fdiv_rn(1.0f, __fmaf_rn(s, p.k0, 1.0f)));
      return;
    }
    case kSoftLOne: {  // k0 = 1 / b, k1 = 2 b
      const float t = __fsqrt_rn(fma_ftz(s, p.k0, 1.0f));
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
      const float gp = daz(__fdiv_rn(1.0f, __fadd_rn(s, 1.0f)));
      const float sg = __fsqrt_rn(daz(clamp_min(g, (float)1e-20)));
      const bool in = g <= 1.0f;
      *rho = in ? g : __fsub_rn(__fmul_rn(2.0f, sg), 1.0f);
      *w = daz(__fmul_rn(in ? 1.0f : __fdiv_rn(1.0f, sg), gp));
      return;
    }
    default:
      *rho = s;
      *w = 1.0f;
  }
}

// The NS summands of leaf i ((t C + j) R + r) of the row, whose
// association is record i / R - q0 of this CTA: the cost (at r = 0) and,
// with NS = 13, (w J_a) [J | r]_b, as _residual_terms and _cost_grad_hess
// compute them; zeros past the row's N leaves.
template <int NS>
__device__ __forceinline__ void leaf(const Params& p, const Rec& d, int i,
                                     int q0, float th0, float th1, float s,
                                     float c, float* v) {
  if (i >= p.N) {
#pragma unroll
    for (int m = 0; m < NS; ++m) v[m] = 0.0f;
    return;
  }
  const int q = i / p.R, r = i - q * p.R, l = q - q0;
  // subnormal operands and every subnormal product and sum flushed (daz),
  // as _residual_terms flushes them; the sine of a subnormal theta (sinf
  // returns it unchanged) is an operand read as zero
  s = daz(s);
  // the first products of the fused sums flushed by their exact value
  // (mul_ftz), as the reference's FTZ threads flush a lone product
  const float ux = daz(d.sx[l]), uy = daz(d.sy[l]);
  const float dy = fma_ftz(c, ux, -mul_ftz(s, uy));
  const float wx = daz(__fadd_rn(dy, th0));
  const float wy = daz(__fadd_rn(fma_ftz(s, ux, mul_ftz(c, uy)), th1));
  const float dx = fma_ftz(-s, ux, -mul_ftz(c, uy));
  const float e0 = daz(__fsub_rn(wx, daz(d.mx[l])));
  const float e1 = daz(__fsub_rn(wy, daz(d.my[l])));
  float J[3], res, sq;
  if (p.cost == kP2L) {
    const float n0 = daz(d.nx[l]), n1 = daz(d.ny[l]);
    res = fma_ftz(n1, e1, mul_ftz(n0, e0));
    J[0] = n0;
    J[1] = n1;
    J[2] = fma_ftz(n0, dx, mul_ftz(n1, dy));
    sq = daz(__fmul_rn(res, res));
  } else if (p.cost == kP2D) {
    const float* uu = d.u + 4 * l;  // u[row * 2 + col]
    const float u[4] = {daz(uu[0]), daz(uu[1]), daz(uu[2]), daz(uu[3])};
    const float r0 = fma_ftz(u[1], e1, mul_ftz(u[0], e0));
    const float r1 = fma_ftz(u[3], e1, mul_ftz(u[2], e0));
    const float a = u[2 * r], b = u[2 * r + 1];
    // row r of u [[1, 0, dx], [0, 1, dy]]
    J[0] = fma_ftz(b, 0.0f, daz(__fmul_rn(a, 1.0f)));
    J[1] = fma_ftz(b, 1.0f, daz(__fmul_rn(a, 0.0f)));
    J[2] = fma_ftz(b, dy, mul_ftz(a, dx));
    res = r == 0 ? r0 : r1;
    sq = fma_ftz(r1, r1, daz(__fmul_rn(r0, r0)));
  } else {  // P2P
    res = r == 0 ? e0 : e1;
    J[0] = r == 0 ? 1.0f : 0.0f;
    J[1] = r == 0 ? 0.0f : 1.0f;
    J[2] = r == 0 ? dx : dy;
    sq = fma_ftz(e1, e1, daz(__fmul_rn(e0, e0)));
  }
  float rho, wi;
  rho_weight(sq, p, &rho, &wi);
  const bool m = d.m[l] != 0;
  const float wt = d.w[l];
  // the products w J [J | r] and the weights', operands and results
  // flushed where subnormal, as _cost_grad_hess flushes them
  const float w = m ? mul_ftz(wt, wi) : 0.0f;
  v[0] = (m && r == 0) ? mul_ftz(wt, rho) : 0.0f;
  if constexpr (NS > 1) {  // w, J and res are flushed: mul_ftz is daz(w J)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float wa = mul_ftz(w, J[a]);
#pragma unroll
      for (int b = 0; b < 3; ++b) v[1 + 4 * a + b] = mul_ftz(wa, J[b]);
      v[4 + 4 * a] = mul_ftz(wa, res);
    }
  }
}

// Shared state of one CTA.
struct Shared {
  float* theta;  // [3] the point of the next evaluation
  float* red;    // [kWarps * 13] the warps' sums
  float* slots;  // [2 * 16] this CTA's root: 13 sums and the count
  float* sums;   // [16] the row's 13 sums and its association count
  int* flag;
  int* count;
};

// The row's NS sums (13; 1: the cost alone) at sh.theta in _row_sums's
// pairwise tree, and the sum of the CTAs' association counts (``count``
// this CTA's), in sh.sums of warp 0 (valid in thread 0 on return).
// ``par`` flips each evaluation.
template <int LOG_L, int NS = 13>
__device__ void evaluate(const Params& p, const Rec& d, int leaf0, int q0,
                         int count, const Shared& sh, int& par,
                         cg::cluster_group& cluster) {
  constexpr int L = 1 << LOG_L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float th0 = sh.theta[0], th1 = sh.theta[1];
  float s, c;
  ref_sincos(sh.theta[2], &s, &c);
  float v[NS];
  if (tid < p.nthr) {
    float stack[LOG_L > 0 ? LOG_L : 1][NS];
    const int base = leaf0 + tid * L;
    for (int k = 0; k < L; ++k) {
      float x[NS];
      leaf<NS>(p, d, base + k, q0, th0, th1, s, c, x);
      bool carry = true;  // k's low set bits: subtrees that x completes
#pragma unroll
      for (int lvl = 0; lvl < LOG_L; ++lvl) {
        if (carry) {
          if ((k >> lvl) & 1) {
#pragma unroll
            for (int m = 0; m < NS; ++m) x[m] = __fadd_rn(stack[lvl][m], x[m]);
          } else {
#pragma unroll
            for (int m = 0; m < NS; ++m) stack[lvl][m] = x[m];
            carry = false;
          }
        }
      }
      if (carry) {  // k = L - 1: the run's root
#pragma unroll
        for (int m = 0; m < NS; ++m) v[m] = x[m];
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < NS; ++m) v[m] = 0.0f;
  }
  // levels past the CTA's subtree would add zeros (a -0.0 turned +0.0)
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o < p.nthr) {
#pragma unroll
      for (int m = 0; m < NS; ++m)
        v[m] = __fadd_rn(v[m], __shfl_xor_sync(0xffffffffu, v[m], o));
    }
  }
  const int nw = p.nthr > 32 ? p.nthr >> 5 : 1;
  if (lane == 0 && warp < nw) {
#pragma unroll
    for (int m = 0; m < NS; ++m) sh.red[warp * 13 + m] = v[m];
  }
  __syncthreads();
  float* slot = sh.slots + par * 16;
  if (warp == 0) {
    if (lane < NS) {  // a lane a sum: the tree over the warps' sums
      float x[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x[w] = w < nw ? sh.red[w * 13 + lane] : 0.0f;
#pragma unroll
      for (int n = kWarps; n > 1; n >>= 1) {
        if (n <= nw) {
#pragma unroll
          for (int k = 0; k < n / 2; ++k) x[k] = __fadd_rn(x[2 * k], x[2 * k + 1]);
        }
      }
      slot[lane] = x[0];
    } else if (lane == 13) {
      slot[13] = __int_as_float(count);
    }
  }
  cluster.sync();
  if (warp == 0) {
    if (lane < NS) {  // the tree's top log2 K levels over the CTAs' roots
      float x[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        x[r] = r < p.K ? cluster.map_shared_rank(slot, r)[lane] : 0.0f;
#pragma unroll
      for (int n = kMaxCluster; n > 1; n >>= 1) {
        if (n <= p.K) {
#pragma unroll
          for (int k = 0; k < n / 2; ++k) x[k] = __fadd_rn(x[2 * k], x[2 * k + 1]);
        }
      }
      sh.sums[lane] = x[0];
    } else if (lane == 13) {
      int total = 0;
      for (int r = 0; r < p.K; ++r)
        total += __float_as_int(cluster.map_shared_rank(slot, r)[13]);
      sh.sums[13] = __int_as_float(total);
    }
    __syncwarp();
  }
  par ^= 1;
}

// cost, g and H from the 13 sums at th, plus the prior's terms
// (_prior_terms: each sum one fused multiply-add a term, in order from 0)
__device__ void finish(const Params& p, int b, float pw, const float* th,
                       const float* sums, float* cost, float* g, float* H) {
  *cost = mul_ftz(0.5f, sums[0]);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) H[3 * a + k] = sums[1 + 4 * a + k];
    g[a] = sums[4 + 4 * a];
  }
  if (p.guess == nullptr) return;
  const float* S = p.sqrt_info;
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

// _lm_solve_reference from sh.theta on this CTA's records: in thread 0,
// theta (in: the start, out: the solution), *cost and *rel; *total is the
// row's association count (every thread).  In the window the inner
// iterations are skipped when the count is <= 1: the outer guard then
// drops the solve's result.
template <int LOG_L>
__device__ void lm_solve(const Params& p, int b, const Rec& d, int leaf0,
                         int q0, int count, float pw, const Shared& sh,
                         int& par, cg::cluster_group& cluster, float* theta,
                         float* cost, float* rel, int* total) {
  const int tid = threadIdx.x;
  float g[3], H[9], cur = 0.0f, lam = p.init_lambda, rd = 1.0f;
  evaluate<LOG_L>(p, d, leaf0, q0, count, sh, par, cluster);
  if (tid == 0) {
    finish(p, b, pw, theta, sh.sums, &cur, g, H);
    *sh.flag = !p.window || __float_as_int(sh.sums[13]) > 1;
    *sh.count = __float_as_int(sh.sums[13]);
  }
  __syncthreads();
  *total = *sh.count;
  if (*sh.flag) {
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
        for (int k = 0; k < 3; ++k) sh.theta[k] = cand[k];
      }
      __syncthreads();
      evaluate<LOG_L>(p, d, leaf0, q0, count, sh, par, cluster);
      if (tid == 0) {
        float cc, cg_[3], cH[9];
        finish(p, b, pw, cand, sh.sums, &cc, cg_, cH);
        const bool acc = cc < cur;
        if (acc) {
#pragma unroll
          for (int k = 0; k < 3; ++k) theta[k] = cand[k], g[k] = cg_[k];
#pragma unroll
          for (int k = 0; k < 9; ++k) H[k] = cH[k];
          rd = __fdiv_rn(__fsub_rn(cur, cc), clamp_min(cur, (float)1e-20));
          cur = cc;
        }
        lam = acc ? clamp_min(__fmul_rn(lam, 0.5f), (float)1e-9)
                  : clamp_max(__fmul_rn(lam, 4.0f), (float)1e6);
      }
    }
  }
  *cost = cur;
  *rel = rd;
}

// _similarity: 2 min(x, y) / clamp(x + y, min=1e-12), torch.minimum's NaN
__device__ __forceinline__ float similarity(float x, float y) {
  const float mn = (isnan(x) || isnan(y)) ? NAN : (y < x ? y : x);
  return __fdiv_rn(__fmul_rn(2.0f, mn),
                   clamp_min(__fadd_rn(x, y), (float)1e-12));
}

// torch.argmin's order: (d, i) comes before (bd, bi) if d is NaN and bd is
// not, or both are NaN and i < bi, or neither is NaN and d < bd, or d == bd
// and i < bi
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  if (isnan(d)) return !isnan(bd) || i < bi;
  if (isnan(bd)) return false;
  return d < bd || (d == bd && i < bi);
}

// |(ex, ey)|^2 as the reference's program rounds it: fma(ey, ey, ex * ex),
// the product and the sum flushed where subnormal (an offset whose square
// is below FLT_MIN adds nothing either way), so two subnormal distances tie
// at zero and the argmin keeps the first.
__device__ __forceinline__ float sqdist(float ex, float ey) {
  return fma_ftz(ey, ey, mul_ftz(ex, ex));
}

// ``associate`` of this CTA's associations q0 .. q0 + nq - 1 of row b at
// sh.theta into its records (the target scan t of association q = t C + j
// staged into txy / tv, one scan at a time), and the CTA's count in
// *sh.count.
__device__ void associate(const Params& p, int b, const Rec& d, int q0,
                          int nq, float r2, bool first, float2* txy,
                          unsigned char* tv, const Shared& sh) {
  const int tid = threadIdx.x;
  const float th0 = sh.theta[0], th1 = sh.theta[1];
  float s, c;
  ref_sincos(sh.theta[2], &s, &c);
  if (tid == 0) *sh.count = 0;
  __syncthreads();
  int mine = 0;
  if (nq > 0) {
    const int t0 = q0 / p.C, t1 = (q0 + nq - 1) / p.C;
    for (int t = t0; t <= t1; ++t) {
      const long long scan = (long long)b * p.T + t;
      if (t1 > t0 || first) {  // one scan staged for the whole call
        if (t > t0) __syncthreads();
        const float2* gxy = reinterpret_cast<const float2*>(p.tmw) + scan * p.Ct;
        const unsigned char* gv = p.tvalid + scan * p.Ct;
        for (int k = tid; k < p.Ct; k += kThreads) {
          __pipeline_memcpy_async(txy + k, gxy + k, sizeof(float2));
          tv[k] = gv[k];
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
      }
      const int lo = max(q0, t * p.C), hi = min(q0 + nq, (t + 1) * p.C);
      for (int q = lo + tid; q < hi; q += kThreads) {
        const int j = q - t * p.C;
        const long long sj = (long long)b * p.C + j;
        const float ux = p.src[2 * sj], uy = p.src[2 * sj + 1];
        const float vx = p.src_normal[2 * sj], vy = p.src_normal[2 * sj + 1];
        // se2.apply / rotate of the source cell
        const float wx = __fadd_rn(ref_fma(c, ux, -__fmul_rn(s, uy)), th0);
        const float wy = __fadd_rn(ref_fma(s, ux, __fmul_rn(c, uy)), th1);
        const float nwx = daz(ref_fma(c, vx, -__fmul_rn(s, vy)));
        const float nwy = daz(ref_fma(s, vx, __fmul_rn(c, vy)));
        // argmin of where(valid, (diff * diff).sum(-1), inf): the first NaN,
        // else the first minimum.  kChains independent chains (target k in
        // chain k % kChains) hide the loop's latency; each keeps its own
        // first NaN or first minimum, and merging them by (NaN first, then
        // the distance, then the index) gives the same winner
        float best[kChains];
        int nn_c[kChains];
#pragma unroll
        for (int u = 0; u < kChains; ++u) best[u] = INFINITY, nn_c[u] = -1;
        for (int k0 = 0; k0 < p.Ct; k0 += kChains) {
#pragma unroll
          for (int u = 0; u < kChains; ++u) {
            const int k = k0 + u;
            if (k < p.Ct) {
              const float2 tq = txy[k];
              const float ex = __fsub_rn(wx, tq.x), ey = __fsub_rn(wy, tq.y);
              const float d2 = tv[k] ? sqdist(ex, ey) : INFINITY;
              if (nn_c[u] < 0 || (!isnan(best[u]) && (isnan(d2) || d2 < best[u]))) {
                best[u] = d2;
                nn_c[u] = k;
              }
            }
          }
        }
        int nn = nn_c[0];
        float bd = best[0];
#pragma unroll
        for (int u = 1; u < kChains; ++u) {
          if (nn_c[u] >= 0 && before(best[u], nn_c[u], bd, nn)) {
            bd = best[u];
            nn = nn_c[u];
          }
        }
        const long long tk = scan * p.Ct + nn;
        // the winner's attributes as the reference's one-hot product reads
        // them: a subnormal value is zero
        const float2 mq = make_float2(daz(txy[nn].x), daz(txy[nn].y));
        const bool in_radius =
            sqdist(__fsub_rn(wx, mq.x), __fsub_rn(wy, mq.y)) < r2 && tv[nn];
        const float tnx = daz(p.tnw[2 * tk]), tny = daz(p.tnw[2 * tk + 1]);
        const float dir = clamp_min(
            daz(__fadd_rn(daz(__fmul_rn(nwx, tnx)), daz(__fmul_rn(nwy, tny)))),
            0.0f);
        const bool ok = in_radius && dir > p.gate && p.src_valid[sj];
        float w;
        switch (p.weight_option) {
          case 0: w = 1.0f; break;
          case 1: w = similarity(p.src_ns[sj], p.t_ns[tk]); break;
          case 2: w = dir; break;
          case 3: w = similarity(p.src_plan[sj], p.t_plan[tk]); break;
          default:
            w = __fadd_rn(__fadd_rn(similarity(p.src_ns[sj], p.t_ns[tk]), dir),
                          similarity(p.src_plan[sj], p.t_plan[tk]));
        }
        const int l = q - q0;
        d.sx[l] = ux;
        d.sy[l] = uy;
        d.mx[l] = mq.x;
        d.my[l] = mq.y;
        d.w[l] = ok ? w : 0.0f;
        d.m[l] = ok;
        if (p.cost == kP2L) {
          d.nx[l] = tnx;
          d.ny[l] = tny;
        } else if (p.cost == kP2D) {
          // _chol2x2_inv_sqrt((reg * eye + cov) * cov_scale)
          const float* cv = p.tcw + 4 * tk;
          const float a = __fmul_rn(__fadd_rn(__fmul_rn(p.reg, 1.0f), cv[0]), p.cov_scale);
          const float bb = __fmul_rn(__fadd_rn(__fmul_rn(p.reg, 0.0f), cv[1]), p.cov_scale);
          const float cc = __fmul_rn(__fadd_rn(__fmul_rn(p.reg, 1.0f), cv[3]), p.cov_scale);
          const float det = clamp_min(__fmaf_rn(a, cc, -__fmul_rn(bb, bb)), (float)1e-20);
          const float ia = __fdiv_rn(cc, det), ic = __fdiv_rn(a, det);
          const float u22 = __fsqrt_rn(daz(clamp_min(ic, (float)1e-20)));
          const float u12 = __fdiv_rn(-bb, __fmul_rn(det, u22));
          const float u11 = __fsqrt_rn(daz(clamp_min(__fmaf_rn(-u12, u12, ia), (float)1e-20)));
          float* u = d.u + 4 * l;
          u[0] = u11;
          u[1] = u12;
          u[2] = 0.0f;
          u[3] = u22;
        }
        mine += ok;
      }
    }
  }
  if (mine) atomicAdd(sh.count, mine);
  __syncthreads();
}

// one CTA's records in its dynamic shared memory (layout() sets the offsets)
__device__ __forceinline__ Rec records(const Params& p, float* f,
                                       unsigned char* bytes) {
  Rec d;
  d.sx = f + p.o_sx;
  d.sy = f + p.o_sy;
  d.mx = f + p.o_mx;
  d.my = f + p.o_my;
  d.w = f + p.o_w;
  d.nx = f + p.o_nx;
  d.ny = f + p.o_ny;
  d.u = f + p.o_u;
  d.m = bytes + p.o_mask;
  return d;
}

template <int LOG_L>
__global__ void __launch_bounds__(kThreads) registration_kernel(const Params p) {
  extern __shared__ float4 dyn[];
  __shared__ float s_theta[3];
  __shared__ float s_red[kWarps * 13];
  __shared__ float s_slots[2 * 16];
  __shared__ float s_sums[16];
  __shared__ int s_flag, s_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / p.K, tid = threadIdx.x;
  const Shared sh = {s_theta, s_red, s_slots, s_sums, &s_flag, &s_count};
  float* f = reinterpret_cast<float*>(dyn);
  unsigned char* bytes = reinterpret_cast<unsigned char*>(dyn);
  const Rec d = records(p, f, bytes);
  const int leaf0 = rank * p.Wk, q0 = rank * p.Qk;
  const int nq = max(0, min(p.Qk, p.T * p.C - q0));
  int par = 0;
  float theta[3], cost, rel;
  int total;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s_theta[k] = theta[k] = p.theta0[3 * b + k];
  }
  if (!p.window) {
    // the given associations of this CTA's leaves
    const long long row = (long long)b * p.T * p.C;
    for (int l = tid; l < nq; l += kThreads) {
      const long long q = row + q0 + l;
      const int j = (q0 + l) % p.C;
      d.sx[l] = p.src[2 * ((long long)b * p.C + j)];
      d.sy[l] = p.src[2 * ((long long)b * p.C + j) + 1];
      d.mx[l] = p.tm[2 * q];
      d.my[l] = p.tm[2 * q + 1];
      d.w[l] = p.weight[q];
      d.m[l] = p.mask[q];
      if (p.cost == kP2L) {
        d.nx[l] = p.tn[2 * q];
        d.ny[l] = p.tn[2 * q + 1];
      } else if (p.cost == kP2D) {
#pragma unroll
        for (int k = 0; k < 4; ++k) d.u[4 * l + k] = p.si[4 * q + k];
      }
    }
    __syncthreads();
    lm_solve<LOG_L>(p, b, d, leaf0, q0, 0, p.guess ? p.pw[b] : 0.0f, sh, par,
                    cluster, theta, &cost, &rel, &total);
    if (rank == 0 && tid == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) p.out_theta[3 * b + k] = theta[k];
      p.out_cost[b] = cost;
      p.out_rel[b] = rel;
    }
    cluster.sync();  // no CTA leaves while another may read its slots
    return;
  }
  float2* txy = reinterpret_cast<float2*>(f + p.o_txy);
  unsigned char* tv = bytes + p.o_tv;
  // the prior's weight sqrt(max(valid source cells, 1))
  if (tid == 0) s_count = 0;
  __syncthreads();
  int nv = 0;
  for (int j = tid; j < p.C; j += kThreads) nv += p.src_valid[(long long)b * p.C + j] != 0;
  if (nv) atomicAdd(&s_count, nv);
  __syncthreads();
  const float pw = __fsqrt_rn(clamp_min((float)s_count, 1.0f));
  float score = 3.40282347e38f / 4.0f;  // finfo(float32).max / 4
  long long used = 0, nres = 0;
  for (int itr = 0; itr < p.max_outer; ++itr) {
    associate(p, b, d, q0, nq, itr == 0 ? p.r2_first : p.r2, itr == 0, txy,
              tv, sh);
    const int count = s_count;
    float lm_theta[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) lm_theta[k] = theta[k];
    lm_solve<LOG_L>(p, b, d, leaf0, q0, count, pw, sh, par, cluster,
                    lm_theta, &cost, &rel, &total);
    if (tid == 0) {
      // the guards of register_window; the row is active here
      const bool run = total > 1;
      const bool past_min = itr + 1 > p.min_outer;
      const bool regressed = past_min && score < cost;
      const float rel_imp =
          __fdiv_rn(__fsub_rn(score, cost), clamp_min(score, (float)1e-20));
      const bool converged = past_min && (rel_imp < p.tol || rel < p.tol);
      if (run && !regressed) {
#pragma unroll
        for (int k = 0; k < 3; ++k) theta[k] = lm_theta[k];
        score = cost;
      }
      used = itr + 1;
      if (run) nres = total;
#pragma unroll
      for (int k = 0; k < 3; ++k) s_theta[k] = theta[k];
      s_flag = run && !regressed && !converged;
    }
    __syncthreads();
    if (!s_flag) break;  // inactive: no output changes again
  }
  if (rank == 0 && tid == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p.out_theta[3 * b + k] = theta[k];
    p.out_cost[b] = score;
    p.out_nres[b] = nres;
    p.out_iters[b] = used;
  }
  cluster.sync();  // no CTA leaves while another may read its slots
}

// The sampled covariance's 3 x 3 algebra from the fit q (flushed), in one
// thread, as ops/registration.py::_covariance_from_fit: the Hessian, its
// convexity (every eigenvalue of la_eigvalsh3 positive), the guarded
// inverse (lu_factor, then lu_apply against each column of the identity),
// 2 final_score / max(resid_dim - 3, 1) cov_scaler, or the default
// diagonal where the Hessian is not convex.
__device__ void covariance(const Params& p, int b, const float* q) {
  const float h[9] = {daz(__fmul_rn(2.0f, q[0])), q[3], q[5],
                      q[3], daz(__fmul_rn(2.0f, q[1])), q[4],
                      q[5], q[4], daz(__fmul_rn(2.0f, q[2]))};
  float w[3];
  la_eigvalsh3(h, w);
  const bool convex = w[0] > 0.0f && w[1] > 0.0f && w[2] > 0.0f;
  float a[kLuMax][kLuMax];
  int piv[kLuMax];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      a[r][c] = daz(__fadd_rn(h[3 * r + c], r == c && !convex ? 1.0f : 0.0f));
  lu_factor(3, a, piv);
  const long long rd = (p.cost == kP2L ? 1LL : 2LL) * p.n_res[b];
  const float scale =
      daz(__fdiv_rn(p.final_score[b], (float)(rd - 3 > 1 ? rd - 3 : 1)));
  float* out = p.out_cov + 9LL * b;
  for (int j = 0; j < 3; ++j) {
    float x[kLuMax] = {j == 0 ? 1.0f : 0.0f, j == 1 ? 1.0f : 0.0f,
                       j == 2 ? 1.0f : 0.0f};
    lu_apply(3, a, piv, x);
    for (int r = 0; r < 3; ++r) {
      const float c2 = daz(__fmul_rn(2.0f, x[r]));
      out[3 * r + j] = convex ? daz(__fmul_rn(daz(__fmul_rn(c2, scale)),
                                              p.cov_scaler))
                              : (r == j ? p.fallback[r] : 0.0f);
    }
  }
  p.out_convex[b] = convex;
}

// The evaluation entry: one association at the row's pose, then the cost at
// each of its S poses over it in ONE pass over the records, the S trees'
// reductions side by side, then (rank 0) the top of the trees, the fit and
// the covariance.  A team of team_warps warps a pose (8 at S = 1, 1 from
// S = 5), its team_lanes lanes each an aligned run of E = 2^LOG_E leaves,
// so each pose's sum is _row_sums's pairwise tree whatever K; kPoseGroup
// poses of a team in flight at once, so each record is read once a group.
template <int LOG_E>
__global__ void __launch_bounds__(kThreads) evaluation_kernel(const Params p) {
  extern __shared__ float4 dyn[];
  __shared__ float s_theta[3];
  __shared__ float4 s_pose[kMaxPoses];           // x, y, sin, cos
  __shared__ float s_warp[kMaxPoses * kWarps];  // the warps' roots
  __shared__ float s_root[kMaxPoses + 1];        // the CTA's roots, its count
  __shared__ float s_cost[kMaxPoses];
  __shared__ float s_q[10];
  __shared__ int s_count;
  constexpr int E = 1 << LOG_E;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / p.K, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const Shared sh = {s_theta, nullptr, nullptr, nullptr, nullptr, &s_count};
  float* f = reinterpret_cast<float*>(dyn);
  unsigned char* bytes = reinterpret_cast<unsigned char*>(dyn);
  const Rec d = records(p, f, bytes);
  float2* txy = reinterpret_cast<float2*>(f + p.o_txy);
  unsigned char* tv = bytes + p.o_tv;
  const int leaf0 = rank * p.Wk, q0 = rank * p.Qk;
  const int nq = max(0, min(p.Qk, p.T * p.C - q0));
  // the pose table, once a launch: pose + offset_s and its sine and cosine
  if (tid < 3) s_theta[tid] = p.theta0[3 * b + tid];
  if (tid < p.S) {
    float th[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      th[k] = p.offs == nullptr ? p.theta0[3 * b + k]
                                : __fadd_rn(p.theta0[3 * b + k], p.offs[3 * tid + k]);
    float sn, cs;
    ref_sincos(th[2], &sn, &cs);
    s_pose[tid] = make_float4(th[0], th[1], sn, cs);
  }
  __syncthreads();  // associate reads s_theta before its own first barrier
  associate(p, b, d, q0, nq, p.r2, true, txy, tv, sh);
  const int count = s_count;
  const int tw = p.team_warps, teams = kWarps / tw, team = warp / tw,
            wt = warp - team * tw, tl = wt * 32 + lane;
  const int span = p.team_lanes < 32 ? p.team_lanes : 32;
  const int base = leaf0 + tl * E;
  for (int g0 = team; g0 < p.S; g0 += teams * kPoseGroup) {
    int ps[kPoseGroup];
    float4 pose[kPoseGroup];
    float v[kPoseGroup];
#pragma unroll
    for (int g = 0; g < kPoseGroup; ++g) {
      ps[g] = g0 + g * teams;
      pose[g] = ps[g] < p.S ? s_pose[ps[g]] : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
      v[g] = 0.0f;
    }
    if (tl < p.team_lanes) {
      float stack[LOG_E > 0 ? LOG_E : 1][kPoseGroup];
      for (int k = 0; k < E; ++k) {
        float x[kPoseGroup];
#pragma unroll
        for (int g = 0; g < kPoseGroup; ++g)
          leaf<1>(p, d, base + k, q0, pose[g].x, pose[g].y, pose[g].z,
                  pose[g].w, &x[g]);
        bool carry = true;  // k's low set bits: subtrees that x completes
#pragma unroll
        for (int lvl = 0; lvl < LOG_E; ++lvl) {
          if (carry) {
            if ((k >> lvl) & 1) {
#pragma unroll
              for (int g = 0; g < kPoseGroup; ++g)
                x[g] = __fadd_rn(stack[lvl][g], x[g]);
            } else {
#pragma unroll
              for (int g = 0; g < kPoseGroup; ++g) stack[lvl][g] = x[g];
              carry = false;
            }
          }
        }
        if (carry) {
#pragma unroll
          for (int g = 0; g < kPoseGroup; ++g) v[g] = x[g];
        }
      }
    }
    // levels past the tree's leaves would add zeros (a -0.0 turned +0.0)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      if (o < span) {
#pragma unroll
        for (int g = 0; g < kPoseGroup; ++g)
          v[g] = __fadd_rn(v[g], __shfl_xor_sync(0xffffffffu, v[g], o));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kPoseGroup; ++g)
        if (ps[g] < p.S) s_warp[ps[g] * kWarps + wt] = v[g];
    }
  }
  if (tid == 0) s_root[p.S] = __int_as_float(count);
  __syncthreads();
  if (tid < p.S) {  // a thread a pose: the tree over its team's warps
    const int nw = p.team_lanes > 32 ? p.team_lanes >> 5 : 1;
    float x[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x[w] = w < nw ? s_warp[tid * kWarps + w] : 0.0f;
#pragma unroll
    for (int n = kWarps; n > 1; n >>= 1) {
      if (n <= nw) {
#pragma unroll
        for (int k = 0; k < n / 2; ++k) x[k] = __fadd_rn(x[2 * k], x[2 * k + 1]);
      }
    }
    s_root[tid] = x[0];
  }
  cluster.sync();
  if (rank == 0 && warp == 0) {
    for (int si = lane; si < p.S; si += 32) {  // the top log2 K levels
      float x[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        x[r] = r < p.K ? cluster.map_shared_rank(s_root, r)[si] : 0.0f;
#pragma unroll
      for (int n = kMaxCluster; n > 1; n >>= 1) {
        if (n <= p.K) {
#pragma unroll
          for (int k = 0; k < n / 2; ++k) x[k] = __fadd_rn(x[2 * k], x[2 * k + 1]);
        }
      }
      const float c = mul_ftz(0.5f, x[0]);
      p.out_cost[(long long)b * p.S + si] = c;
      s_cost[si] = c;
    }
    if (lane == 0) {
      int total = 0;
      for (int r = 0; r < p.K; ++r)
        total += __float_as_int(cluster.map_shared_rank(s_root, r)[p.S]);
      p.out_nres[b] = total;
    }
    __syncwarp();
    if (p.pinv != nullptr && lane < 10) {  // a lane a coefficient
      float qk = 0.0f;  // refmath.dot: operands and steps flushed
      for (int si = 0; si < p.S; ++si)
        qk = fma_ftz(daz(s_cost[si]), daz(p.pinv[lane * p.S + si]), qk);
      p.out_q[10 * b + lane] = qk;
      s_q[lane] = qk;
    }
    __syncwarp();
    if (p.out_cov != nullptr && lane == 0) covariance(p, b, s_q);
  }
  cluster.sync();  // no CTA leaves while rank 0 may read its roots
}

// The dynamic shared memory of one CTA's records (and, in the window, one
// staged target scan), its offsets set in p; kernels/lm_solve.py::
// shared_bytes computes the same.
long long layout(Params& p) {
  long long o = 0;
  const long long q = ((long long)p.Qk + 3) / 4 * 4;  // 16-byte aligned arrays
  auto take = [&](long long n) { const long long at = o; o += n; return (int)at; };
  p.o_sx = take(q);
  p.o_sy = take(q);
  p.o_mx = take(q);
  p.o_my = take(q);
  p.o_w = take(q);
  p.o_nx = p.o_ny = p.o_u = 0;
  if (p.cost == kP2L) {
    p.o_nx = take(q);
    p.o_ny = take(q);
  } else if (p.cost == kP2D) {
    p.o_u = take(4 * q);
  }
  p.o_txy = 0;
  if (p.window) p.o_txy = take(((long long)2 * p.Ct + 3) / 4 * 4);
  long long b = 4 * o;
  p.o_mask = b;
  b += (p.Qk + 15) / 16 * 16;
  p.o_tv = b;
  if (p.window) b += (p.Ct + 15) / 16 * 16;
  return b;
}

template <int LOG_L, bool EVAL>
int launch(const Params& p, int rows, long long smem, cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (EVAL) return evaluation_kernel<LOG_L>;
    else return registration_kernel<LOG_L>;
  }();
  // the shared-memory attribute and the cluster occupancy, checked once a
  // device for the largest size asked so far (a smaller size fits too)
  static long long attr_bytes[kMaxDevices];
  static long long fits_bytes[kMaxDevices][4];  // by log2 K
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const bool cache = dev < kMaxDevices;
  const int lk = p.K == 1 ? 0 : p.K == 2 ? 1 : p.K == 4 ? 2 : 3;
  if (!cache || smem > attr_bytes[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (cache) attr_bytes[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * p.K));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!cache || smem + 1 > fits_bytes[dev][lk]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    if (cache) fits_bytes[dev][lk] = smem + 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int run(Params& p, int rows, int cluster, cudaStream_t stream) {
  if (rows <= 0) return 0;
  p.R = p.cost == kP2L ? 1 : 2;
  const long long n = (long long)p.T * p.C * p.R;
  long long w = 1;
  while (w < n) w <<= 1;
  const int k = cluster;
  if (k < 1 || k > kMaxCluster || (k & (k - 1)) || w / k < p.R)
    return (int)cudaErrorInvalidValue;
  p.N = (int)n;
  p.K = k;
  p.Wk = (int)(w / k);
  p.Qk = p.Wk / p.R;
  p.nthr = p.Wk < kThreads ? p.Wk : kThreads;
  int log_l = 0;
  while ((1LL << log_l) * p.nthr < p.Wk) ++log_l;
  if (log_l > kMaxLogLeaves) return (int)cudaErrorInvalidValue;
  const long long smem = layout(p);
  if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
  if (p.evaluate) {
    if (p.S < 1 || p.S > kMaxPoses) return (int)cudaErrorInvalidValue;
    p.team_warps = p.S == 1 ? 8 : p.S == 2 ? 4 : p.S <= 4 ? 2 : 1;
    p.team_lanes = p.Wk < 32 * p.team_warps ? p.Wk : 32 * p.team_warps;
    int log_e = 0;
    while ((1LL << log_e) * p.team_lanes < p.Wk) ++log_e;
    if (log_e > kMaxLogRun) return (int)cudaErrorInvalidValue;
    switch (log_e) {
      case 0: return launch<0, true>(p, rows, smem, stream);
      case 1: return launch<1, true>(p, rows, smem, stream);
      case 2: return launch<2, true>(p, rows, smem, stream);
      case 3: return launch<3, true>(p, rows, smem, stream);
      case 4: return launch<4, true>(p, rows, smem, stream);
      case 5: return launch<5, true>(p, rows, smem, stream);
      case 6: return launch<6, true>(p, rows, smem, stream);
      case 7: return launch<7, true>(p, rows, smem, stream);
      case 8: return launch<8, true>(p, rows, smem, stream);
      case 9: return launch<9, true>(p, rows, smem, stream);
      default: return launch<10, true>(p, rows, smem, stream);
    }
  }
  switch (log_l) {
    case 0: return launch<0, false>(p, rows, smem, stream);
    case 1: return launch<1, false>(p, rows, smem, stream);
    case 2: return launch<2, false>(p, rows, smem, stream);
    case 3: return launch<3, false>(p, rows, smem, stream);
    case 4: return launch<4, false>(p, rows, smem, stream);
    case 5: return launch<5, false>(p, rows, smem, stream);
    case 6: return launch<6, false>(p, rows, smem, stream);
    default: return launch<7, false>(p, rows, smem, stream);
  }
}

}  // namespace

// (theta [B, 3], cost [B], rel_dec [B]) of _lm_solve for B rows of T x C
// given associations, on clusters of ``cluster`` CTAs a row; tn, si, guess
// (with sqrt_info, pw) may be null as the cost and the prior say.  k0..k3
// are the loss's float32 constants.  Returns a CUDA error code
// (cudaErrorInvalidValue for a cluster size or row the kernel does not
// take).
extern "C" int lm_solve_launch(
    const void* theta0, const void* src, const void* tm, const void* tn,
    const void* weight, const void* mask, const void* si, const void* guess,
    const void* sqrt_info, const void* pw, void* out_theta, void* out_cost,
    void* out_rel, int rows, int T, int C, int cost, int loss, float k0,
    float k1, float k2, float k3, int max_iter, float init_lambda,
    int one_system, int cluster, void* stream) {
  Params p = {};
  p.window = 0;
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
  p.Ct = C;
  p.cost = cost;
  p.loss = loss;
  p.k0 = k0;
  p.k1 = k1;
  p.k2 = k2;
  p.k3 = k3;
  p.max_iter = max_iter;
  p.init_lambda = init_lambda;
  p.one_system = one_system;
  return run(p, rows, cluster, (cudaStream_t)stream);
}

// (pose [B, 3], score [B], num_residuals [B], iterations [B]) of
// register_window for B source scans of C cells against T target scans of
// Ct cells each, given in the world frame (_world_targets); tcw and guess
// (with sqrt_info) may be null as the cost and the prior say.  The radii,
// gate, regularisation, scale and tolerance are float32 as torch rounds
// them against a float32 tensor.  Returns a CUDA error code.
extern "C" int register_window_launch(
    const void* theta0, const void* src, const void* src_normal,
    const void* src_ns, const void* src_plan, const void* src_valid,
    const void* tmw, const void* tnw, const void* tcw, const void* tvalid,
    const void* t_ns, const void* t_plan, const void* guess,
    const void* sqrt_info, void* out_theta, void* out_score, void* out_nres,
    void* out_iters, int rows, int T, int C, int Ct, int cost, int loss,
    float k0, float k1, float k2, float k3, int max_inner, float init_lambda,
    int one_system, int max_outer, int min_outer, int weight_option,
    float r2_first, float r2, float gate, float reg, float cov_scale,
    float tol, int cluster, void* stream) {
  Params p = {};
  p.window = 1;
  p.theta0 = (const float*)theta0;
  p.src = (const float*)src;
  p.src_normal = (const float*)src_normal;
  p.src_ns = (const float*)src_ns;
  p.src_plan = (const float*)src_plan;
  p.src_valid = (const unsigned char*)src_valid;
  p.tmw = (const float*)tmw;
  p.tnw = (const float*)tnw;
  p.tcw = (const float*)tcw;
  p.tvalid = (const unsigned char*)tvalid;
  p.t_ns = (const float*)t_ns;
  p.t_plan = (const float*)t_plan;
  p.guess = (const float*)guess;
  p.sqrt_info = (const float*)sqrt_info;
  p.out_theta = (float*)out_theta;
  p.out_cost = (float*)out_score;
  p.out_nres = (long long*)out_nres;
  p.out_iters = (long long*)out_iters;
  p.T = T;
  p.C = C;
  p.Ct = Ct;
  p.cost = cost;
  p.loss = loss;
  p.k0 = k0;
  p.k1 = k1;
  p.k2 = k2;
  p.k3 = k3;
  p.max_iter = max_inner;
  p.init_lambda = init_lambda;
  p.one_system = one_system;
  p.max_outer = max_outer;
  p.min_outer = min_outer;
  p.weight_option = weight_option;
  p.r2_first = r2_first;
  p.r2 = r2;
  p.gate = gate;
  p.reg = reg;
  p.cov_scale = cov_scale;
  p.tol = tol;
  if (Ct < 1) return (int)cudaErrorInvalidValue;
  return run(p, rows, cluster, (cudaStream_t)stream);
}

// (costs [B, S], association counts [B], fit q [B, 10], cov [B, 3, 3],
// convex [B]) of the cost evaluation for B source scans of C cells against
// T world-frame target scans of Ct cells each (_world_targets): one
// association at each row's pose, then the cost-only pass at pose +
// offs[s] for s < S <= 64 (offs null: S is 1 and the pose is used as it
// is); with pinv [10, S], q = the fit's sums (refmath.dot's order), else
// out_q is not written; with out_cov (and pinv, final_score [B], n_res [B]
// int64, out_convex), the sampled covariance of the fit
// (_covariance_from_fit; the default diagonal diag0..2 where not convex).
// Returns a CUDA error code.
extern "C" int evaluate_cost_launch(
    const void* pose, const void* src, const void* src_normal,
    const void* src_ns, const void* src_plan, const void* src_valid,
    const void* tmw, const void* tnw, const void* tcw, const void* tvalid,
    const void* t_ns, const void* t_plan, const void* offs, const void* pinv,
    const void* final_score, const void* n_res, void* out_costs,
    void* out_count, void* out_q, void* out_cov, void* out_convex, int rows,
    int T, int C, int Ct, int S, int cost, int loss, float k0, float k1,
    float k2, float k3, int weight_option, float r2, float gate, float reg,
    float cov_scale, float cov_scaler, float diag0, float diag1,
    float diag2, int cluster, void* stream) {
  Params p = {};
  p.window = 1;
  p.evaluate = 1;
  p.theta0 = (const float*)pose;
  p.src = (const float*)src;
  p.src_normal = (const float*)src_normal;
  p.src_ns = (const float*)src_ns;
  p.src_plan = (const float*)src_plan;
  p.src_valid = (const unsigned char*)src_valid;
  p.tmw = (const float*)tmw;
  p.tnw = (const float*)tnw;
  p.tcw = (const float*)tcw;
  p.tvalid = (const unsigned char*)tvalid;
  p.t_ns = (const float*)t_ns;
  p.t_plan = (const float*)t_plan;
  p.offs = (const float*)offs;
  p.pinv = (const float*)pinv;
  p.out_cost = (float*)out_costs;
  p.out_nres = (long long*)out_count;
  p.out_q = (float*)out_q;
  p.final_score = (const float*)final_score;
  p.n_res = (const long long*)n_res;
  p.out_cov = (float*)out_cov;
  p.out_convex = (unsigned char*)out_convex;
  p.cov_scaler = cov_scaler;
  p.fallback[0] = diag0;
  p.fallback[1] = diag1;
  p.fallback[2] = diag2;
  p.T = T;
  p.C = C;
  p.Ct = Ct;
  p.S = S;
  p.cost = cost;
  p.loss = loss;
  p.k0 = k0;
  p.k1 = k1;
  p.k2 = k2;
  p.k3 = k3;
  p.weight_option = weight_option;
  p.r2 = r2;
  p.gate = gate;
  p.reg = reg;
  p.cov_scale = cov_scale;
  if (Ct < 1 || S < 1 || S > kMaxPoses || (offs == nullptr && S != 1) ||
      (out_cov != nullptr && (pinv == nullptr || final_score == nullptr ||
                              n_res == nullptr || out_convex == nullptr)))
    return (int)cudaErrorInvalidValue;
  return run(p, rows, cluster, (cudaStream_t)stream);
}
