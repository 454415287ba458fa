// The registration kernel, three entries over one device code for sm_90a:
// the window solve (register_window: the targets' placement in the world,
// association, LM solve and outer guards) as one launch a call, the LM
// solve alone on given associations (register_joint), and the cost
// evaluation (evaluate_cost and sampled_covariance: one association, then
// the cost at S poses over it).
//
// Not a TPU kernel: the JAX package's register_window, associate,
// _lm_solve, evaluate_cost and the vmapped sampled_covariance
// (ops/registration.py) are left to XLA, which fuses them.  The port's
// plain version (ops/registration.py::_register_window_reference, with
// _world_targets, associate and _lm_solve_reference;
// _evaluate_cost_reference and _sampled_covariance_reference) runs each of
// its operations as its own launch: about 40 launches an association and a
// few dozen an LM or cost evaluation, 8 outer iterations a window call.
// This kernel runs all of it in one launch, bit-equal to the plain
// version: every operation below is the plain version's, each multiply,
// add and fused multiply-add an explicit __f*_rn / __fma*_rn intrinsic (or
// a .ftz instruction where the plain version flushes), torch's comparison
// and NaN rules written out (argmin: the first NaN, else the first
// minimum), and refmath.cuh supplies the reference's sincos, log1p, IEEE
// sqrt, LM step and se2 arithmetic.
//
// Bound: the work is small (at B = 1, T = 4, C = 512: a million masked
// distances an association, about 50 float32 operations a leaf an LM
// evaluation over 4,096 leaves) and the bytes smaller; a call is a chain of
// up to 8 associations and 8 x 21 dependent evaluations, each a reduction
// over the whole row followed by a 3x3 step (the evaluation entry: one
// association and S cost reductions).  So its time is that chain's
// latency, measured link by link with -DTBV_STAGE_CLOCKS
// (scripts/lm_stage_clocks.py).  The design shortens the chain and each
// link, and removes the launches between them:
//
// * A thread-block cluster of K CTAs (K a power of two <= 8, chosen by the
//   wrapper from B and the row's size) per batch row.  CTA k owns the
//   aligned k-th 1/K of the row's _row_sums leaves and computes, once per
//   outer iteration, the associations of those leaves into shared memory
//   (the target scan it needs placed in the world and staged there: the
//   world_targets site's arithmetic, refmath.cuh's se2_applied, on the
//   scan's cells in their own frame, its pose and the scan mask; one scan
//   at a time when its leaves span several), so the evaluations read only
//   shared memory and the call needs no other launch.
// * A run of rejections in one pass.  A rejected step changes nothing but
//   lambda, so the next candidates along the reject branch (lambda_j =
//   min(4 lambda_{j-1}, 1e6), the serial loop's floats) are known before
//   the first of them is evaluated: warp 0's lanes form up to ``batch`` of
//   them side by side (lane j the step at lambda_j and its sine and
//   cosine, once), one pass over the records sums the first one's 13 sums
//   and the others' costs, and the first accepted in order is taken with
//   the rejections before it; a later candidate's acceptance costs one
//   pass at it for its g and H.  After an accepted step the next pass
//   takes one candidate (a run of acceptances costs no more than the
//   serial loop), after a rejected one ``batch`` (default_batch).  So a
//   solve of 20 iterations takes about 1 + (accepted steps) + (rejections
//   / batch) passes instead of 21.
// * The sums of a pass follow the plain version's pairwise tree (_row_sums:
//   the leaves padded with zeros to a power of two W, each even element
//   added to the odd one after it): each thread reduces its aligned run of
//   leaves in registers, the warp's sums are scattered over its lanes as
//   they are added (a level of n sums takes n / 2 shuffles), a tree over
//   the warps' sums (one warp, a lane a sum) finishes the CTA's subtree,
//   each CTA stores its root into every CTA's shared memory (distributed
//   shared memory), one cluster barrier, and every CTA adds the tree's top
//   log2 K levels from its own copy.  So the sums do not depend on K.  The
//   roots are double-buffered on the pass's parity, so one barrier a pass
//   suffices.
// * Every CTA then runs the finish, the damping, the steps and the
//   accept / reject itself on identical bits (warp 0, the same bits in
//   each lane), so nothing is broadcast; the outer guards likewise, and
//   the cluster leaves the outer loop as soon as the row is inactive (none
//   of its outputs can change after that).
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
//   sampled_covariance is this launch alone, with no library call and no
//   host read.  Bound: one association, then the latency of the passes'
//   dependent adds; the S-fold barriers are gone.  The plain path's S-fold
//   copies of the sources and associations and its dense [B, T, C, Ct]
//   differences are never made.  No TPU kernel is replaced: XLA fused
//   sampled_covariance's vmap and handed its 3 x 3 algebra to LAPACK on
//   the host.
#include <cooperative_groups.h>

#include "refmath.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLogLeaves = 7;  // at most 128 leaves a thread
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr long long kSmemBytes = 200 * 1024;
constexpr int kChains = 4;        // independent argmin chains a thread
static_assert(kChains == 4, "associate reads 4 targets a step");
constexpr int kMaxDevices = 16;   // launch checks cached per device
constexpr int kMaxPoses = 64;     // the evaluation's S (steps^3 <= 64)
constexpr int kPoseGroup = 4;     // a team's poses in flight at once
constexpr int kMaxLogRun = 10;    // at most 1024 leaves a lane a pose

// The LM solve's run of rejections evaluated in one pass: at most
// kMaxBatch candidates a pass.  A batch pass sums the first candidate's 13
// sums and the others' costs: kBatchSums, candidate j's cost at
// cost_slot(j) (its 13 sums from 0 for j = 0).
constexpr int kMaxBatch = 4;
constexpr int kBatchSums = 12 + kMaxBatch;

__host__ __device__ constexpr int cost_slot(int j) { return j == 0 ? 0 : 12 + j; }
// a pass's sums padded to a power of two: a warp reduces them scattered
// over its lanes (scatter_level)
constexpr int kMaxPad = 16;
static_assert(kBatchSums <= kMaxPad, "a batch pass's sums must fit kMaxPad");

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
  // window: the source cells and the target scans [B, T, Ct, ...] in
  // their own frames, placed in the world inside the launch
  const float* src_normal;         // [B, C, 2]
  const float* src_ns;             // [B, C] nsamples
  const float* src_plan;           // [B, C] planarity
  const unsigned char* src_valid;  // [B, C]
  const float* tpose;              // [B, T, 3] the target scans' poses
  const float* tmean;              // [B, T, Ct, 2]
  const float* tnormal;            // [B, T, Ct, 2]
  const float* tcov;               // [B, T, Ct, 2, 2] (P2D), or null
  const unsigned char* tvalid;     // [B, T, Ct]
  const unsigned char* smask;      // [B, T] the scan mask
  const float* t_ns;               // [B, T, Ct]
  const float* t_plan;             // [B, T, Ct]
  // the batch strides (elements) of src .. t_plan, in that order; a row is
  // dense, a stride may be 0 (one row broadcast over the batch)
  long long bs[13];
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
  int* out_passes;       // [B] (window: passes over the records), or null
  int T, C, Ct, R, N, K, Wk, Qk, nthr, S;
  int team_warps, team_lanes;  // evaluation: warps a pose, lanes a tree
  int cost, loss, max_iter, one_system;
  int batch;  // candidates a pass along a run of rejections (<= kMaxBatch)
  float k0, k1, k2, k3;  // the loss's float32 constants (lm_solve.py)
  float init_lambda;
  int max_outer, min_outer, weight_option;
  float r2_first, r2, gate, reg, cov_scale, tol;  // float32 as torch rounds them
  // shared-memory layout: float offsets of the records' arrays and of the
  // staged target means, byte offsets of the mask and target validity
  int o_sx, o_sy, o_mx, o_my, o_w, o_nx, o_ny, o_u, o_txy;
  long long o_mask, o_tv;
};

// Stage clocks (a build with -DTBV_STAGE_CLOCKS, scripts/lm_stage_clocks.py;
// never the library the package loads): thread 0 of the launch's first CTA
// adds the SM cycles (clock64) since its previous stamp to the stage's
// counter in g_stage_cycles; lm_stage_clocks copies them out and clears them.
enum Stage {
  kStAssocStage = 0,  // the target scan staged (and placed), its barrier
  kStAssocSearch,     // the argmin, gates and records, the count's barrier
  kStCandidate,       // damping and step of the next candidate(s)
  kStCandidateSync,   // the barrier that publishes them
  kStSincos,          // the candidate's sine and cosine
  kStLeaves,          // the thread's leaves
  kStShuffle,         // the warp's reduction
  kStCtaTree,         // the barrier and the tree over the warps
  kStClusterSync,     // the cluster barrier
  kStTopTree,         // the top of the tree over the CTAs' roots
  kStFinish,          // finish, accept / reject
  kStGuards,          // the outer guards and their barrier
  kStages,
  kStPasses = 28,     // counters: passes over the records,
  kStCandidates,      // candidates evaluated,
  kStAssociations,    // associations,
  kStCalls            // launches
};
#ifdef TBV_STAGE_CLOCKS
// the counters accumulate in shared memory (a stamp costs a shared-memory
// add, not a device-memory round trip) and stage_flush adds them to
// g_stage_cycles at the launch's end
__device__ unsigned long long g_stage_cycles[32];
__shared__ long long s_stage_last;
__shared__ unsigned long long s_stage[32];
__device__ __forceinline__ bool stage_thread() {
  return blockIdx.x == 0 && threadIdx.x == 0;
}
__device__ __forceinline__ void stage_start() {
  if (stage_thread()) {
    for (int k = 0; k < 32; ++k) s_stage[k] = 0;
    s_stage[kStCalls] = 1;
    s_stage_last = clock64();
  }
}
__device__ __forceinline__ void stage(int k) {
  if (stage_thread()) {
    const long long t = clock64();
    s_stage[k] += (unsigned long long)(t - s_stage_last);
    s_stage_last = t;
  }
}
__device__ __forceinline__ void stage_count(int k, int n) {
  if (stage_thread()) s_stage[k] += (unsigned long long)n;
}
__device__ __forceinline__ void stage_flush() {
  if (stage_thread())
    for (int k = 0; k < 32; ++k) g_stage_cycles[k] += s_stage[k];
}
#else
__device__ __forceinline__ void stage_start() {}
__device__ __forceinline__ void stage(int) {}
__device__ __forceinline__ void stage_count(int, int) {}
__device__ __forceinline__ void stage_flush() {}
#endif

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
  float4* cand;   // [kMaxBatch] the candidates' x, y, sine and cosine
  float* ctheta;  // [3 kMaxBatch] the candidates
  float* red;     // [kWarps kMaxPad] the warps' sums
  float* roots;   // [2][kMaxCluster][kMaxPad + 1] the CTAs' roots and
                  // association counts, by the pass's parity
  float* sums;    // [kMaxPad + 1] the row's sums and association count
  int* ctl;       // [2] the next pass (kStop, kBatchPass, kRefresh), its
                  // candidates
  int* count;     // the row's association count
};

constexpr int kRootStride = kMaxPad + 1;
enum Next { kStop = 0, kBatchPass, kRefresh };

// One level of the warp's pairwise sums of v [2H] with lane ^ o, and the
// levels after it: this lane keeps half of them (the upper half where its
// bit o is set), each the sum of its value and the partner's, so a level
// of 2H sums takes H shuffles.  Lanes pair as in _row_sums's tree and an
// add is commutative, so each sum is the tree's.  A level at or past the
// CTA's leaves (o >= nthr) only passes the values on: adding its zeros
// would turn a -0.0 into +0.0.
template <int H>
__device__ __forceinline__ void scatter_level(float* v, int lane, int o,
                                              int nthr) {
  const bool up = (lane & o) != 0, add = o < nthr;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float mine = up ? v[H + i] : v[i];
    const float other =
        __shfl_xor_sync(0xffffffffu, up ? v[i] : v[H + i], o);
    v[i] = add ? __fadd_rn(mine, other) : (up ? other : mine);
  }
  if constexpr (H > 1) {
    scatter_level<H / 2>(v, lane, o << 1, nthr);
  } else {
    for (int q = o << 1; q < 32; q <<= 1) {  // one sum a lane: all add it
      const float other = __shfl_xor_sync(0xffffffffu, v[0], q);
      if (q < nthr) v[0] = __fadd_rn(v[0], other);
    }
  }
}

// which of the NP sums lane ends with (scatter_level)
template <int NP>
__device__ __forceinline__ int scatter_index(int lane) {
  int idx = 0;
#pragma unroll
  for (int h = NP / 2, o = 1; h >= 1; h >>= 1, o <<= 1)
    if (lane & o) idx += h;
  return idx;
}

// The sums of leaf i for a batch pass's candidates J, J + 1, ..: candidate
// 0's 13 sums, the others' costs (cost_slot), zeros past nb.
template <int J>
__device__ __forceinline__ void batch_leaf(const Params& p, const Rec& d,
                                           int i, int q0, const float4* cp,
                                           int nb, float* x) {
  if constexpr (J < kMaxBatch) {
    float* y = x + cost_slot(J);
    if constexpr (J == 0) {
      leaf<13>(p, d, i, q0, cp[0].x, cp[0].y, cp[0].z, cp[0].w, y);
    } else {
      if (J < nb) leaf<1>(p, d, i, q0, cp[J].x, cp[J].y, cp[J].z, cp[J].w, y);
      else y[0] = 0.0f;
    }
    batch_leaf<J + 1>(p, d, i, q0, cp, nb, x);
  }
}

// The sums of leaf i for a pass's candidates cp: BATCH false, the 13 of
// candidate 0; true, those of batch_leaf.
template <bool BATCH>
__device__ __forceinline__ void pass_leaf(const Params& p, const Rec& d,
                                          int i, int q0, const float4* cp,
                                          int nb, float* x) {
  if constexpr (!BATCH) {
    leaf<13>(p, d, i, q0, cp[0].x, cp[0].y, cp[0].z, cp[0].w, x);
  } else {
    batch_leaf<0>(p, d, i, q0, cp, nb, x);
  }
}

// One pass over this CTA's records: the row's sums for the candidates in
// sh.cand (BATCH false: candidate 0's 13 sums; true: nb of them, as
// batch_leaf) in _row_sums's pairwise tree whatever K, and the CTAs'
// association counts added, in sh.sums of warp 0 (its lanes read them after
// the pass).  Each thread reduces its aligned run of leaves in registers,
// scatter_level's shuffles and a tree over the warps' sums (a lane a sum of
// warp 0) finish the CTA's subtree; each CTA's root goes into every CTA's
// shared memory (stores over distributed shared memory, which measured
// faster than each CTA reading the K roots after the barrier), one cluster
// barrier, and each CTA adds the tree's top log2 K levels itself.  The roots are double-buffered on ``par``: a CTA
// rewrites a buffer only after every CTA has passed the next pass's
// barrier, so one barrier a pass suffices.
template <int LOG_L, bool BATCH>
__device__ void pass(const Params& p, const Rec& d, int leaf0, int q0,
                     int count, int nb, const Shared& sh, int& par, int rank,
                     cg::cluster_group& cluster) {
  constexpr int L = 1 << LOG_L;
  constexpr int NC = BATCH ? kMaxBatch : 1;
  constexpr int NSUM = BATCH ? kBatchSums : 13;
  constexpr int NP = kMaxPad;  // the sums padded: 13 or kBatchSums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4 cp[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) cp[j] = sh.cand[j];
  stage(kStSincos);
  stage_count(kStPasses, 1);
  stage_count(kStCandidates, BATCH ? nb : 1);
  float v[NP];
#pragma unroll
  for (int m = 0; m < NP; ++m) v[m] = 0.0f;
  if (tid < p.nthr) {
    float stack[LOG_L > 0 ? LOG_L : 1][NSUM];
    const int base = leaf0 + tid * L;
    for (int k = 0; k < L; ++k) {
      float x[NSUM];
      pass_leaf<BATCH>(p, d, base + k, q0, cp, nb, x);
      bool carry = true;  // k's low set bits: subtrees that x completes
#pragma unroll
      for (int lvl = 0; lvl < LOG_L; ++lvl) {
        if (carry) {
          if ((k >> lvl) & 1) {
#pragma unroll
            for (int m = 0; m < NSUM; ++m) x[m] = __fadd_rn(stack[lvl][m], x[m]);
          } else {
#pragma unroll
            for (int m = 0; m < NSUM; ++m) stack[lvl][m] = x[m];
            carry = false;
          }
        }
      }
      if (carry) {  // k = L - 1: the run's root
#pragma unroll
        for (int m = 0; m < NSUM; ++m) v[m] = x[m];
      }
    }
  }
  stage(kStLeaves);
  if constexpr (NP > 1) scatter_level<NP / 2>(v, lane, 1, p.nthr);
  stage(kStShuffle);
  const int nw = p.nthr > 32 ? p.nthr >> 5 : 1;
  if (warp < nw && lane < NP) sh.red[warp * kMaxPad + scatter_index<NP>(lane)] = v[0];
  __syncthreads();
  float* roots = sh.roots + par * (kMaxCluster * kRootStride);
  if (warp == 0) {
    float x[kWarps];  // a lane a sum: the tree over the warps' sums
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      x[w] = (w < nw && lane < NP) ? sh.red[w * kMaxPad + lane] : 0.0f;
#pragma unroll
    for (int n = kWarps; n > 1; n >>= 1) {
      if (n <= nw) {
#pragma unroll
        for (int k = 0; k < n / 2; ++k) x[k] = __fadd_rn(x[2 * k], x[2 * k + 1]);
      }
    }
    const int at = rank * kRootStride;
    for (int r = 0; r < p.K; ++r) {  // into every CTA's buffer
      float* dst = cluster.map_shared_rank(roots, r) + at;
      if (lane < NP) dst[lane] = x[0];
      if (lane == 0) dst[kMaxPad] = __int_as_float(count);
    }
  }
  stage(kStCtaTree);
  if (p.K > 1) cluster.sync();
  else __syncthreads();
  stage(kStClusterSync);
  if (warp == 0) {
    if (lane < NP) {  // the tree's top log2 K levels over the CTAs' roots
      float x[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        x[r] = r < p.K ? roots[r * kRootStride + lane] : 0.0f;
#pragma unroll
      for (int n = kMaxCluster; n > 1; n >>= 1) {
        if (n <= p.K) {
#pragma unroll
          for (int k = 0; k < n / 2; ++k) x[k] = __fadd_rn(x[2 * k], x[2 * k + 1]);
        }
      }
      sh.sums[lane] = x[0];
    }
    if (lane == 0) {
      int total = 0;
      for (int r = 0; r < p.K; ++r)
        total += __float_as_int(roots[r * kRootStride + kMaxPad]);
      sh.sums[kMaxPad] = __int_as_float(total);
    }
    __syncwarp();
  }
  stage(kStTopTree);
  par ^= 1;
}

// the prior's cost terms at th (_prior_terms: each sum one fused
// multiply-add a term, in order from 0): pr and, when wanted, jp
__device__ __forceinline__ void prior_terms(const Params& p, int b, float pw,
                                            const float* th, float* pr) {
  const float* S = p.sqrt_info;
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = __fsub_rn(th[k], p.guess[3 * b + k]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = __fmaf_rn(d[k], S[3 * i + k], acc);
    pr[i] = __fmul_rn(acc, pw);
  }
}

// the cost at th from its cost sum s0, plus the prior's
__device__ float finish_cost(const Params& p, int b, float pw,
                             const float* th, float s0) {
  float cost = mul_ftz(0.5f, s0);
  if (p.guess == nullptr) return cost;
  float pr[3];
  prior_terms(p, b, pw, th, pr);
  float pc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) pc = __fmaf_rn(pr[k], pr[k], pc);
  return __fadd_rn(cost, __fmul_rn(0.5f, pc));
}

// cost, g and H from the 13 sums at th, plus the prior's terms
__device__ void finish(const Params& p, int b, float pw, const float* th,
                       const float* sums, float* cost, float* g, float* H) {
  *cost = finish_cost(p, b, pw, th, sums[0]);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) H[3 * a + k] = sums[1 + 4 * a + k];
    g[a] = sums[4 + 4 * a];
  }
  if (p.guess == nullptr) return;
  const float* S = p.sqrt_info;
  float pr[3], jp[9];
  prior_terms(p, b, pw, th, pr);
#pragma unroll
  for (int k = 0; k < 9; ++k) jp[k] = __fmul_rn(S[k], pw);
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

// candidate j of a pass: x, y, sine and cosine (the sine and cosine once,
// by the lane that forms it), and the pose itself
__device__ __forceinline__ void publish(const Shared& sh, int j,
                                        const float* c) {
  float sn, cs;
  ref_sincos(c[2], &sn, &cs);
  sh.cand[j] = make_float4(c[0], c[1], sn, cs);
#pragma unroll
  for (int k = 0; k < 3; ++k) sh.ctheta[3 * j + k] = c[k];
}

// Warp 0: the next pass.  While iterations remain, nb = min(batch,
// max_iter - it) candidates along the reject branch, lane j the step at
// lambda_j (lambda_0 = lam, lambda_j = min(4 lambda_{j-1}, 1e6): the serial
// loop's floats), each the step of _lm_solve_reference; else stop.
__device__ void plan(const Params& p, int lane, const float* theta,
                     const float* g, const float* H, float lam, int it,
                     int batch, const Shared& sh) {
  const int left = p.max_iter - it;
  const int nb = batch < left ? batch : left;
  if (lane < nb) {
    float lj = lam;
    for (int q = 0; q < lane; ++q) lj = clamp_max(__fmul_rn(lj, 4.0f), (float)1e6);
    // H + diag(fma(lam, diag H, 1e-12)), zeros added off the diagonal
    float A[9], c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        A[3 * i + k] = __fadd_rn(
            H[3 * i + k], i == k ? __fmaf_rn(lj, H[4 * i], (float)1e-12) : 0.0f);
    lm_update3(theta, A, g, p.one_system != 0, c);
    publish(sh, lane, c);
  }
  if (lane == 0) {
    sh.ctl[0] = nb > 0 ? kBatchPass : kStop;
    sh.ctl[1] = nb;
  }
}

// _lm_solve_reference from theta on this CTA's records, warp 0 keeping the
// state (theta, cost, g, H, lambda, rel_dec: the same bits in each lane and
// each CTA).  A rejection changes nothing but lambda, so the candidates
// along a run of rejections are known before the first is evaluated: a
// pass evaluates up to ``batch`` of them, the first accepted in order is
// taken (cc < cur; a NaN cost rejects), and its iteration and the
// rejections before it are consumed, as the serial loop consumes them.
// Where a later candidate is accepted (only its cost was summed), one pass
// at it gives its g and H.  On return theta, *cost and *rel in warp 0;
// *total is the row's association count (every thread); *passes counts the
// passes over the records.  In the window the
// inner iterations are skipped when the count is <= 1: the outer guard
// then drops the solve's result.
template <int LOG_L>
__device__ void lm_solve(const Params& p, int b, const Rec& d, int leaf0,
                         int q0, int count, float pw, const Shared& sh,
                         int& par, int rank, cg::cluster_group& cluster,
                         float* theta, float* cost, float* rel, int* total,
                         int* passes) {
  const int tid = threadIdx.x, lane = tid & 31;
  const bool w0 = tid < 32;
  float g[3], H[9], cur = 0.0f, lam = p.init_lambda, rd = 1.0f;
  int it = 0;
  bool accepted = false;
  if (tid == 0) publish(sh, 0, theta);
  stage(kStCandidate);
  __syncthreads();
  stage(kStCandidateSync);
  pass<LOG_L, false>(p, d, leaf0, q0, count, 1, sh, par, rank, cluster);
  ++*passes;
  if (w0) {
    finish(p, b, pw, theta, sh.sums, &cur, g, H);
    const int n = __float_as_int(sh.sums[kMaxPad]);
    if (lane == 0) *sh.count = n;
    stage(kStFinish);
    if (!p.window || n > 1) {
      plan(p, lane, theta, g, H, lam, it, p.batch, sh);
    } else if (lane == 0) {
      sh.ctl[0] = kStop;
    }
  }
  stage(kStCandidate);
  __syncthreads();
  stage(kStCandidateSync);
  *total = *sh.count;
  for (;;) {
    const int next = sh.ctl[0], nb = sh.ctl[1];
    if (next == kStop) break;
    if (next == kBatchPass)
      pass<LOG_L, true>(p, d, leaf0, q0, count, nb, sh, par, rank, cluster);
    else
      pass<LOG_L, false>(p, d, leaf0, q0, count, 1, sh, par, rank, cluster);
    ++*passes;
    if (w0) {
      bool refresh = false;
      if (next == kRefresh) {  // g and H at the accepted candidate
        float c_;
        finish(p, b, pw, theta, sh.sums, &c_, g, H);
      } else {
        const float cc = lane < nb
            ? finish_cost(p, b, pw, sh.ctheta + 3 * lane, sh.sums[cost_slot(lane)])
            : 0.0f;
        const unsigned acc = __ballot_sync(0xffffffffu, lane < nb && cc < cur);
        accepted = acc != 0;
        if (acc) {
          const int j = __ffs(acc) - 1;
          const float cj = __shfl_sync(0xffffffffu, cc, j);
          float lj = lam;
          for (int q = 0; q < j; ++q) lj = clamp_max(__fmul_rn(lj, 4.0f), (float)1e6);
#pragma unroll
          for (int k = 0; k < 3; ++k) theta[k] = sh.ctheta[3 * j + k];
          rd = __fdiv_rn(__fsub_rn(cur, cj), clamp_min(cur, (float)1e-20));
          cur = cj;
          lam = clamp_min(__fmul_rn(lj, 0.5f), (float)1e-9);
          it += j + 1;
          if (j == 0) {
            float c_;
            finish(p, b, pw, theta, sh.sums, &c_, g, H);
          }
          refresh = j > 0;
        } else {
          it += nb;
          for (int q = 0; q < nb; ++q) lam = clamp_max(__fmul_rn(lam, 4.0f), (float)1e6);
        }
      }
      stage(kStFinish);
      if (refresh) {
        if (lane == 0) {
          publish(sh, 0, theta);
          sh.ctl[0] = kRefresh;
          sh.ctl[1] = 1;
        }
      } else {
        plan(p, lane, theta, g, H, lam, it, accepted ? 1 : p.batch, sh);
      }
    }
    stage(kStCandidate);
    __syncthreads();
    stage(kStCandidateSync);
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
// theta into its records (the target scan t of association q = t C + j
// placed in the world and staged into txy / tv, one scan at a time), and
// the CTA's count in *count.  The placement is the world_targets site's
// (ops/registration.py::_world_targets_plain), with its device functions:
// the means moved by the scan's pose (se2_applied), validity and the scan
// mask; the winner's normal rotated (se2_rotated) and, for P2D, its
// covariance rot cov rot^T in _mm2's order.
__device__ void associate(const Params& p, int b, const Rec& d, int q0,
                          int nq, float r2, bool first, float2* txy,
                          unsigned char* tv, const float* theta,
                          int* count) {
  const int tid = threadIdx.x;
  const int ct4 = (p.Ct + kChains - 1) / kChains * kChains;
  // row b of each input (its batch stride: 0 where one row is broadcast)
  const float* src = p.src + b * p.bs[0];
  const float* src_normal = p.src_normal + b * p.bs[1];
  const float* src_ns = p.src_ns + b * p.bs[2];
  const float* src_plan = p.src_plan + b * p.bs[3];
  const unsigned char* src_valid = p.src_valid + b * p.bs[4];
  const float* tpose = p.tpose + b * p.bs[5];
  const float* tmean = p.tmean + b * p.bs[6];
  const float* tnormal = p.tnormal + b * p.bs[7];
  const float* tcov = p.tcov == nullptr ? nullptr : p.tcov + b * p.bs[8];
  const unsigned char* tvalid = p.tvalid + b * p.bs[9];
  const unsigned char* smask = p.smask + b * p.bs[10];
  const float* t_ns = p.t_ns + b * p.bs[11];
  const float* t_plan = p.t_plan + b * p.bs[12];
  const float th0 = theta[0], th1 = theta[1];
  float s, c;
  ref_sincos(theta[2], &s, &c);
  if (tid == 0) *count = 0;
  __syncthreads();
  int mine = 0;
  if (nq > 0) {
    const int t0 = q0 / p.C, t1 = (q0 + nq - 1) / p.C;
    for (int t = t0; t <= t1; ++t) {
      const long long scan = (long long)t * p.Ct;  // the scan's first cell
      // the scan's pose and its rotation (rotmat: sinf / cosf as they are)
      const float px = tpose[3 * t], py = tpose[3 * t + 1];
      float ts, tc;
      ref_sincos(tpose[3 * t + 2], &ts, &tc);
      if (t1 > t0 || first) {  // one scan staged for the whole call
        if (t > t0) __syncthreads();
        const float2* gm = reinterpret_cast<const float2*>(tmean) + scan;
        const unsigned char* gv = tvalid + scan;
        const bool on = smask[t] != 0;
        for (int k = tid; k < p.Ct; k += kThreads) {
          const float2 m = gm[k];
          txy[k] = se2_applied(tc, ts, px, py, m.x, m.y);
          tv[k] = gv[k] != 0 && on;
        }
        // the scan padded to a multiple of kChains with invalid targets at
        // the origin: a padded target's distance is inf and its index
        // follows every real one, so it never wins (a real target ties it
        // at inf and comes first), and the loop below needs no bound check
        for (int k = p.Ct + tid; k < ct4; k += kThreads) {
          txy[k] = make_float2(0.0f, 0.0f);
          tv[k] = 0;
        }
        __syncthreads();
      }
      stage(kStAssocStage);
      const int lo = max(q0, t * p.C), hi = min(q0 + nq, (t + 1) * p.C);
      for (int q = lo + tid; q < hi; q += kThreads) {
        const int j = q - t * p.C;
        const float ux = src[2 * j], uy = src[2 * j + 1];
        const float vx = src_normal[2 * j], vy = src_normal[2 * j + 1];
        // se2.apply / rotate of the source cell
        const float2 w2 = se2_applied(c, s, th0, th1, ux, uy);
        const float2 nw2 = se2_rotated(c, s, vx, vy);
        const float wx = w2.x, wy = w2.y, nwx = nw2.x, nwy = nw2.y;
        // argmin of where(valid, (diff * diff).sum(-1), inf): the first NaN,
        // else the first minimum.  kChains independent chains (target k in
        // chain k % kChains) hide the loop's latency; each keeps its own
        // first NaN or first minimum, and merging them by (NaN first, then
        // the distance, then the index) gives the same winner.  A step
        // reads its kChains targets with two 16-byte loads and their
        // validity with one 4-byte load, all issued before any distance
        // (every distance is computed, then masked: no load waits on
        // another), and has no branch.
        float best[kChains];
        int nn_c[kChains];
#pragma unroll
        for (int u = 0; u < kChains; ++u) best[u] = INFINITY, nn_c[u] = -1;
        const float4* t4 = reinterpret_cast<const float4*>(txy);
        const unsigned* v4 = reinterpret_cast<const unsigned*>(tv);
        for (int k0 = 0; k0 < ct4; k0 += kChains) {
          const float4 a = t4[k0 / 2], e = t4[k0 / 2 + 1];
          const unsigned valid = v4[k0 / 4];
          const float tx[kChains] = {a.x, a.z, e.x, e.z};
          const float ty[kChains] = {a.y, a.w, e.y, e.w};
#pragma unroll
          for (int u = 0; u < kChains; ++u) {
            const float ex = __fsub_rn(wx, tx[u]), ey = __fsub_rn(wy, ty[u]);
            const float d2 = (valid >> (8 * u)) & 0xffu ? sqdist(ex, ey)
                                                         : INFINITY;
            if (nn_c[u] < 0 || (!isnan(best[u]) && (isnan(d2) || d2 < best[u]))) {
              best[u] = d2;
              nn_c[u] = k0 + u;
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
        const long long tk = scan + nn;
        // the winner's attributes as the reference's one-hot product reads
        // them: a subnormal value is zero
        const float2 mq = make_float2(daz(txy[nn].x), daz(txy[nn].y));
        const bool in_radius =
            sqdist(__fsub_rn(wx, mq.x), __fsub_rn(wy, mq.y)) < r2 && tv[nn];
        const float2 tn = se2_rotated(tc, ts, tnormal[2 * tk],
                                      tnormal[2 * tk + 1]);
        const float tnx = daz(tn.x), tny = daz(tn.y);
        const float dir = clamp_min(
            daz(__fadd_rn(daz(__fmul_rn(nwx, tnx)), daz(__fmul_rn(nwy, tny)))),
            0.0f);
        const bool ok = in_radius && dir > p.gate && src_valid[j];
        float w;
        switch (p.weight_option) {
          case 0: w = 1.0f; break;
          case 1: w = similarity(src_ns[j], t_ns[tk]); break;
          case 2: w = dir; break;
          case 3: w = similarity(src_plan[j], t_plan[tk]); break;
          default:
            w = __fadd_rn(__fadd_rn(similarity(src_ns[j], t_ns[tk]), dir),
                          similarity(src_plan[j], t_plan[tk]));
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
          // the winner's covariance in the world, rot cov rot^T (entries
          // 00, 01, 11), then _chol2x2_inv_sqrt((reg * eye + cov) *
          // cov_scale)
          const float* cv = tcov + 4 * tk;
          const float r[2][2] = {{tc, -ts}, {ts, tc}};
          float m[2][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int k = 0; k < 2; ++k)
              m[i][k] = mm2(r[i][0], cv[k], r[i][1], cv[2 + k]);
          const float w00 = mm2(m[0][0], r[0][0], m[0][1], r[0][1]);
          const float w01 = mm2(m[0][0], r[1][0], m[0][1], r[1][1]);
          const float w11 = mm2(m[1][0], r[1][0], m[1][1], r[1][1]);
          const float a = __fmul_rn(__fadd_rn(__fmul_rn(p.reg, 1.0f), w00), p.cov_scale);
          const float bb = __fmul_rn(__fadd_rn(__fmul_rn(p.reg, 0.0f), w01), p.cov_scale);
          const float cc = __fmul_rn(__fadd_rn(__fmul_rn(p.reg, 1.0f), w11), p.cov_scale);
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
  if (mine) atomicAdd(count, mine);
  __syncthreads();
  stage(kStAssocSearch);
  stage_count(kStAssociations, 1);
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
  __shared__ float4 s_cand[kMaxBatch];
  __shared__ float s_ctheta[3 * kMaxBatch];
  __shared__ float s_theta[3];
  __shared__ float s_red[kWarps * kMaxPad];
  __shared__ float s_roots[2 * kMaxCluster * kRootStride];
  __shared__ float s_sums[kRootStride];
  __shared__ int s_ctl[2], s_flag, s_count, s_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / p.K, tid = threadIdx.x;
  const Shared sh = {s_cand, s_ctheta, s_red, s_roots, s_sums, s_ctl,
                     &s_total};
  float* f = reinterpret_cast<float*>(dyn);
  unsigned char* bytes = reinterpret_cast<unsigned char*>(dyn);
  const Rec d = records(p, f, bytes);
  const int leaf0 = rank * p.Wk, q0 = rank * p.Qk;
  const int nq = max(0, min(p.Qk, p.T * p.C - q0));
  int par = 0;
  float theta[3], cost, rel;
  int total;
#pragma unroll
  for (int k = 0; k < 3; ++k) theta[k] = p.theta0[3 * b + k];
  if (tid < 3) s_theta[tid] = theta[tid];
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
    int passes = 0;
    lm_solve<LOG_L>(p, b, d, leaf0, q0, 0, p.guess ? p.pw[b] : 0.0f, sh, par,
                    rank, cluster, theta, &cost, &rel, &total, &passes);
    if (rank == 0 && tid == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) p.out_theta[3 * b + k] = theta[k];
      p.out_cost[b] = cost;
      p.out_rel[b] = rel;
    }
    cluster.sync();  // no CTA leaves while another may read its roots
    return;
  }
  float2* txy = reinterpret_cast<float2*>(f + p.o_txy);
  unsigned char* tv = bytes + p.o_tv;
  // the prior's weight sqrt(max(valid source cells, 1))
  if (tid == 0) s_count = 0;
  __syncthreads();
  int nv = 0;
  for (int j = tid; j < p.C; j += kThreads) nv += p.src_valid[b * p.bs[4] + j] != 0;
  if (nv) atomicAdd(&s_count, nv);
  __syncthreads();
  const float pw = __fsqrt_rn(clamp_min((float)s_count, 1.0f));
  float score = 3.40282347e38f / 4.0f;  // finfo(float32).max / 4
  long long used = 0, nres = 0;
  int passes = 0;
  stage_start();
  for (int itr = 0; itr < p.max_outer; ++itr) {
    associate(p, b, d, q0, nq, itr == 0 ? p.r2_first : p.r2, itr == 0, txy,
              tv, s_theta, &s_count);
    const int count = s_count;
    float lm_theta[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) lm_theta[k] = theta[k];
    lm_solve<LOG_L>(p, b, d, leaf0, q0, count, pw, sh, par, rank, cluster,
                    lm_theta, &cost, &rel, &total, &passes);
    if (tid < 32) {
      // the guards of register_window, in warp 0 (which holds the solve's
      // result); the row is active here
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
      if (tid < 3) s_theta[tid] = theta[tid];
      if (tid == 0) s_flag = run && !regressed && !converged;
    }
    __syncthreads();
    stage(kStGuards);
    if (!s_flag) break;  // inactive: no output changes again
  }
  if (rank == 0 && tid == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p.out_theta[3 * b + k] = theta[k];
    p.out_cost[b] = score;
    p.out_nres[b] = nres;
    p.out_iters[b] = used;
    if (p.out_passes != nullptr) p.out_passes[b] = passes;
  }
  stage_flush();
  cluster.sync();  // no CTA leaves while another may read its roots
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
  associate(p, b, d, q0, nq, p.r2, true, txy, tv, s_theta, &s_count);
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
  // the staged scan, padded to a multiple of kChains targets
  if (p.window) p.o_txy = take(2LL * ((p.Ct + kChains - 1) / kChains * kChains));
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

// the candidates a pass along a run of rejections: 4 for the odometry
// windows' 20 inner iterations, 2 for the loop waves' 10, as measured
// (scripts/time_cells.py --sets window: 2, 4 and 8 in turns, 4 the fastest
// at B = 1 and 4, 2 at a 64-pair wave)
int default_batch(int max_iter) { return max_iter >= 16 ? 4 : 2; }

int run(Params& p, int rows, int cluster, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (p.batch < 1) p.batch = default_batch(p.max_iter);
  if (p.batch > kMaxBatch) return (int)cudaErrorInvalidValue;
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

#ifdef TBV_STAGE_CLOCKS
// The stage counters (32 of them, Stage's order) into out, then cleared.
extern "C" int lm_stage_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stage_cycles,
                                         sizeof(g_stage_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[32] = {};
  return (int)cudaMemcpyToSymbol(g_stage_cycles, zero, sizeof(zero));
}
#endif

// (theta [B, 3], cost [B], rel_dec [B]) of _lm_solve for B rows of T x C
// given associations, on clusters of ``cluster`` CTAs a row; tn, si, guess
// (with sqrt_info, pw) may be null as the cost and the prior say.  k0..k3
// are the loss's float32 constants; batch is the candidates a pass along a
// run of rejections (0: default_batch).  Returns a CUDA error code
// (cudaErrorInvalidValue for a cluster size or row the kernel does not
// take).
extern "C" int lm_solve_launch(
    const void* theta0, const void* src, const void* tm, const void* tn,
    const void* weight, const void* mask, const void* si, const void* guess,
    const void* sqrt_info, const void* pw, void* out_theta, void* out_cost,
    void* out_rel, int rows, int T, int C, int cost, int loss, float k0,
    float k1, float k2, float k3, int max_iter, float init_lambda,
    int one_system, int batch, int cluster, void* stream) {
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
  p.batch = batch;
  return run(p, rows, cluster, (cudaStream_t)stream);
}

// A window or evaluation launch's arguments, packed by
// kernels/lm_solve.py::ENTRY_ARGS: 24 pointers, 16 ints, 16 floats, 16
// batch strides.
// Pointers 0-13 (both entries): pose [B, 3], the source cells' mean,
// normal [B, C, 2], nsamples, planarity [B, C], valid [B, C] (bool), the
// target scans' poses [B, T, 3], mean, normal [B, T, Ct, 2], covariance
// [B, T, Ct, 2, 2] (P2D, else null), valid [B, T, Ct] (bool), the scan
// mask [B, T] (bool), nsamples and planarity [B, T, Ct].  Ints 0-5: rows B,
// T, C, Ct, cost, loss; 11: the CTAs a row.  Floats 0-3: the loss's
// constants; 6-9: r^2, the angle gate's cosine, the regularisation, the
// covariance scale.  bs: the batch strides (elements) of pointers 1-13,
// whose rows are dense (0: one row broadcast over the batch).
struct EntryArgs {
  const void* ptr[24];
  int i[16];
  float f[16];
  long long bs[16];  // the batch strides of pointers 1-13 (Params::bs)
};
static_assert(sizeof(EntryArgs) == 448, "kernels/lm_solve.py::ENTRY_ARGS");

namespace {

void common(const EntryArgs* a, Params& p) {
  p.theta0 = (const float*)a->ptr[0];
  p.src = (const float*)a->ptr[1];
  p.src_normal = (const float*)a->ptr[2];
  p.src_ns = (const float*)a->ptr[3];
  p.src_plan = (const float*)a->ptr[4];
  p.src_valid = (const unsigned char*)a->ptr[5];
  p.tpose = (const float*)a->ptr[6];
  p.tmean = (const float*)a->ptr[7];
  p.tnormal = (const float*)a->ptr[8];
  p.tcov = (const float*)a->ptr[9];
  p.tvalid = (const unsigned char*)a->ptr[10];
  p.smask = (const unsigned char*)a->ptr[11];
  p.t_ns = (const float*)a->ptr[12];
  p.t_plan = (const float*)a->ptr[13];
  for (int k = 0; k < 13; ++k) p.bs[k] = a->bs[k];
  p.T = a->i[1];
  p.C = a->i[2];
  p.Ct = a->i[3];
  p.cost = a->i[4];
  p.loss = a->i[5];
  p.k0 = a->f[0];
  p.k1 = a->f[1];
  p.k2 = a->f[2];
  p.k3 = a->f[3];
  p.r2 = a->f[6];
  p.gate = a->f[7];
  p.reg = a->f[8];
  p.cov_scale = a->f[9];
}

}  // namespace

// (pose [B, 3], score [B], num_residuals [B], iterations [B]) of
// register_window for B source scans of C cells against T target scans of
// Ct cells each, given in their own frames with their poses and the scan
// mask (placed in the world inside the launch); the arguments above, and:
// pointers 14 guess [B, 3] and 15 sqrt_info [3, 3] (null: no prior), 16-19
// the outputs, 20 passes [B] int32 (each row's passes over its records,
// or null); ints 6 max_inner, 7 one_system, 8 max_outer, 9 min_outer,
// 10 the weight option, 12 the candidates a pass (0: default_batch);
// floats 4 init_lambda, 5 the first outer iteration's r^2, 10 the score
// tolerance.  The radii, gate, regularisation, scale and tolerance are
// float32 as torch rounds them against a float32 tensor.  Returns a CUDA
// error code.
extern "C" int register_window_launch(const EntryArgs* a, void* stream) {
  Params p = {};
  p.window = 1;
  common(a, p);
  p.guess = (const float*)a->ptr[14];
  p.sqrt_info = (const float*)a->ptr[15];
  p.out_theta = (float*)a->ptr[16];
  p.out_cost = (float*)a->ptr[17];
  p.out_nres = (long long*)a->ptr[18];
  p.out_iters = (long long*)a->ptr[19];
  p.out_passes = (int*)a->ptr[20];
  p.max_iter = a->i[6];
  p.one_system = a->i[7];
  p.max_outer = a->i[8];
  p.min_outer = a->i[9];
  p.weight_option = a->i[10];
  p.batch = a->i[12];
  p.init_lambda = a->f[4];
  p.r2_first = a->f[5];
  p.tol = a->f[10];
  if (p.Ct < 1) return (int)cudaErrorInvalidValue;
  return run(p, a->i[0], a->i[11], (cudaStream_t)stream);
}

// (costs [B, S], association counts [B], fit q [B, 10], cov [B, 3, 3],
// convex [B]) of the cost evaluation for B source scans of C cells against
// T target scans of Ct cells each (placed in the world inside the launch,
// as the window's): one association at each row's pose, then the cost-only
// pass at pose + offs[s] for s < S <= 64 (offs null: S is 1 and the pose
// is used as it is); with pinv [10, S], q = the fit's sums (refmath.dot's
// order), else out_q is not written; with out_cov (and pinv, final_score
// [B], n_res [B] int64, out_convex), the sampled covariance of the fit
// (_covariance_from_fit; the default diagonal where not convex).  The
// arguments above, and: pointers 14 offs, 15 pinv, 16 final_score, 17
// n_res, 18-22 the outputs; ints 6 S, 7 the weight option; floats 12
// cov_scaler, 13-15 the default diagonal.  Returns a CUDA error code.
extern "C" int evaluate_cost_launch(const EntryArgs* a, void* stream) {
  Params p = {};
  p.window = 1;
  p.evaluate = 1;
  common(a, p);
  p.offs = (const float*)a->ptr[14];
  p.pinv = (const float*)a->ptr[15];
  p.final_score = (const float*)a->ptr[16];
  p.n_res = (const long long*)a->ptr[17];
  p.out_cost = (float*)a->ptr[18];
  p.out_nres = (long long*)a->ptr[19];
  p.out_q = (float*)a->ptr[20];
  p.out_cov = (float*)a->ptr[21];
  p.out_convex = (unsigned char*)a->ptr[22];
  p.S = a->i[6];
  p.weight_option = a->i[7];
  p.cov_scaler = a->f[12];
  p.fallback[0] = a->f[13];
  p.fallback[1] = a->f[14];
  p.fallback[2] = a->f[15];
  if (p.Ct < 1 || p.S < 1 || p.S > kMaxPoses ||
      (p.offs == nullptr && p.S != 1) ||
      (p.out_cov != nullptr &&
       (p.pinv == nullptr || p.final_score == nullptr ||
        p.n_res == nullptr || p.out_convex == nullptr)))
    return (int)cudaErrorInvalidValue;
  return run(p, a->i[0], a->i[11], (cudaStream_t)stream);
}
