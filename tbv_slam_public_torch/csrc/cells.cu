// The CFEAR cells' statistics in one launch, for sm_90a.
//
// Not a TPU kernel: the JAX package leaves compute_cells to XLA's fusions
// (tbv_slam_public_tpu/ops/features.py:97-122 and the eigen gates after).
// This kernel computes what ops/features.py::compute_cells computes after
// the top-C voxel selection, bit for bit as its plain version
// ops/features.py::_cell_stats_reference rounds it: for each cell, the
// radius gate (|c|^2 + |p|^2 - 2 c.p, each two-term sum a fused
// multiply-add), the neighbour count, the intensity weights and their sum
// in the reference's tree order (windows of 32 points summed in order from
// zero, the windows' sums the same way), the normalised weights (a true
// division), the six moments added one neighbour at a time in point order
// (one fused multiply-add a term from zero, w q rounded first), the
// symmetrised covariance, the eigen gates on the covariance whose diagonal
// is fma(-mu, mu, qq) (torch's square root, the IEEE one on the card),
// the condition number, determinant, planarity log1p(cond / 2)
// (refmath.cuh's XLA log1p), the normal turned toward the origin, the
// validity and the zeroing of invalid cells.  Every multiply, add and fused multiply-add is an explicit
// __f*_rn intrinsic, so nvcc's contraction changes nothing.
//
// Design (clouds of up to kStageMax points, every preset's): a block of
// CELLS_WARPS warps takes kStagedCells = 4 cells, so C = 512 cells are 128
// blocks, one an SM.  The block first stages the cloud's positions and
// mask in shared memory (cp.async for the positions, 9 bytes a point: 43
// KB at phase 4's 4,800 points, 144 KB at the presets' 16,000), then
// gates it once: each warp
// takes windows of 32 points (the weight sum's windows, lo0 points of
// padding in front), computes a point's |p|^2 once, tests it against each
// of the block's cells and keeps each cell's ballot as a word of that
// cell's bitmap in shared memory, in point order.  Then a warp a cell
// walks its bitmap's nonzero words in order twice: the weight sum's
// windows into the tree (folded in registers as its windows close, an
// open window a level), then the six moments' chains, one neighbour at a
// time in point order, each lane holding its point's weight and offset
// and every lane running the chains on the values shuffled from their
// lanes; lane 0 finishes the cell.  Above kStageMax points the first
// design runs (cells_kernel: a warp a cell, 4 cells a block, the gate run
// twice over the cloud in global memory, 8 windows' loads a batch), so a
// cloud of any size runs in one launch.  Bound: operations, about 6 a
// (cell, live point) pair of the gate and 12 a neighbour; the staging's
// load, the gate's pass over the cloud (P / (32 x CELLS_WARPS) windows a
// warp) and the chains of dependent adds (about 20 neighbours x 6 chains a
// cell) set the time, not the bound.
#include <stdint.h>

#include "refmath.cuh"

namespace {

// the staged design's warps a block and the global-memory design's windows
// whose loads a warp issues together (defines, so scripts/time_cells.py can
// build variants)
#ifndef CELLS_WARPS
#define CELLS_WARPS 8
#endif
#ifndef CELLS_BATCH
#define CELLS_BATCH 8
#endif
constexpr int kWarps = 4;  // the global-memory design: cells (warps) a block
constexpr int kBatch = CELLS_BATCH;
constexpr int kStagedWarps = CELLS_WARPS;  // the staged design's warps
constexpr int kStagedCells = 4;  // and cells a block
constexpr int kStageMax = 24000;  // the largest cloud staged in shared memory
constexpr int kWindow = 32;  // the reference's tree-reduction window
constexpr int kLevels = 5;   // the tree's levels: clouds of up to 32^5 points

__device__ __forceinline__ float nan_max(float a, float b) {  // torch.maximum
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ float clamp_min(float x, float lo) {  // torch.clamp
  return x < lo ? lo : x;
}

// The weight sum in the reference's tree order (core/refmath.py::tree_sum):
// level 0 is the points, level k + 1 the sums of level k's windows of 32
// (e_{k+1} = ceil(e_k / 32) elements, the first window starting lo_k =
// (32 e_{k+1} - e_k) / 2 padding zeros early), up to the level `top` of at
// most 32 elements, which are summed in order from zero.  Every window is
// summed in order from zero; its zeros are exact and are skipped.
struct Tree {
  float acc[kLevels];  // the open window's sum at each level
  int win[kLevels];    // its index (-1: none open)
  int lo[kLevels];
  int top;
  float total;
};

__device__ __forceinline__ Tree tree_of(int P) {
  Tree t;
  int e = P;
  t.top = kLevels;
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    t.acc[k] = 0.0f;
    t.win[k] = -1;
    t.lo[k] = 0;
    if (t.top == kLevels) {
      if (k >= 1 && e <= kWindow) {
        t.top = k;
      } else {
        const int n = (e + kWindow - 1) / kWindow;
        t.lo[k] = (kWindow * n - e) / 2;
        e = n;
      }
    }
  }
  t.total = 0.0f;
  return t;
}

// element idx of level k0 (>= 1), of value v, in order
__device__ __forceinline__ void tree_add(Tree& t, int k0, int idx, float v) {
#pragma unroll
  for (int k = 1; k < kLevels; ++k) {
    if (k < k0) continue;
    if (k >= t.top) break;
    const int w = (idx + t.lo[k]) / kWindow;
    if (w == t.win[k]) {
      t.acc[k] = __fadd_rn(t.acc[k], v);
      return;
    }
    const int done = t.win[k];  // a new window: the closed one moves up
    const float sum = t.acc[k];
    t.win[k] = w;
    t.acc[k] = __fadd_rn(0.0f, v);
    if (done < 0) return;
    idx = done;
    v = sum;
  }
  t.total = __fadd_rn(t.total, v);
}

__device__ __forceinline__ float tree_sum(Tree& t) {
#pragma unroll
  for (int k = 1; k < kLevels; ++k) {
    if (k < t.top && t.win[k] >= 0) {
      const int idx = t.win[k];
      t.win[k] = -1;
      tree_add(t, k + 1, idx, t.acc[k]);
    }
  }
  return t.total;
}

struct Cloud {
  const float2* xy;
  const float* intensity;
  const unsigned char* mask;
  int p;
};

// Is point p a neighbour of the cell (c0, c1, cc = |c|^2)?  Its position
// goes to *q.
__device__ __forceinline__ bool gate(const Cloud& cl, int p, float c0,
                                     float c1, float cc, float r2, float2* q) {
  const bool in = p >= 0 && p < cl.p;
  const unsigned char m = in ? __ldg(cl.mask + p) : 0;
  *q = in ? __ldg(cl.xy + p) : make_float2(0.0f, 0.0f);
  const float pp = ref_fma(q->y, q->y, __fmul_rn(q->x, q->x));
  const float dot = ref_fma(c1, q->y, __fmul_rn(c0, q->x));
  const float d2 = __fsub_rn(__fadd_rn(cc, pp), __fmul_rn(2.0f, dot));
  return m && d2 <= r2;
}

// the point's intensity weight: max(I - floor, 0), or 1
__device__ __forceinline__ float weight(const Cloud& cl, int p,
                                        int weight_intensity, float floor_w) {
  return weight_intensity
             ? clamp_min(__fsub_rn(__ldg(cl.intensity + p), floor_w), 0.0f)
             : 1.0f;
}

// A cell's outputs and gates, and the parameters the epilogue reads.
struct CellOut {
  float* mean;
  float* cov;
  float* normal;
  float* nsamples;
  float* planarity;
  float* avg;
  unsigned char* valid;
  int min_neighbors;
  float max_cond, min_det, ox, oy;
};

// Cell c's fields from its neighbour count, weight sum and moments (the
// plain version's steps after its in-order sums).
__device__ void finish_cell(const CellOut& o, int c, bool occ, int count,
                            float wsum, float c0, float c1, float mu0,
                            float mu1, float q00, float q01, float q10,
                            float q11) {
  // covariance qq - mu mu^T, symmetrised; the mean; from here on every
  // subnormal result is flushed (daz), as the plain version flushes it,
  // the lone products mu_i mu_j by their exact value (mul_ftz; the squares
  // never reach the flush tie)
  const float k00 = daz(__fsub_rn(q00, daz(__fmul_rn(mu0, mu0))));
  const float k01 = daz(__fsub_rn(q01, mul_ftz(mu0, mu1)));
  const float k10 = daz(__fsub_rn(q10, mul_ftz(mu1, mu0)));
  const float k11 = daz(__fsub_rn(q11, daz(__fmul_rn(mu1, mu1))));
  const float s00 = daz(__fmul_rn(0.5f, daz(__fadd_rn(k00, k00))));
  const float s01 = daz(__fmul_rn(0.5f, daz(__fadd_rn(k01, k10))));
  const float s10 = daz(__fmul_rn(0.5f, daz(__fadd_rn(k10, k01))));
  const float s11 = daz(__fmul_rn(0.5f, daz(__fadd_rn(k11, k11))));
  const float mx = daz(__fadd_rn(c0, mu0)), my = daz(__fadd_rn(c1, mu1));

  // the eigen gates (ops/features.py::eigh2x2) on the covariance with
  // the diagonal fma(-mu, mu, qq)
  const float ea = fma_ftz(-mu0, mu0, q00), eb = s01,
              ec = fma_ftz(-mu1, mu1, q11);
  const float half_tr = daz(__fmul_rn(0.5f, daz(__fadd_rn(ea, ec))));
  const float d = daz(__fsub_rn(ea, ec));
  const float disc = __fsqrt_rn(clamp_min(
      fma_ftz(daz(__fmul_rn(d, d)), 0.25f, daz(__fmul_rn(eb, eb))),
      0.0f));
  const float lmin = daz(__fsub_rn(half_tr, disc));
  const float lmax = daz(__fadd_rn(half_tr, disc));
  const float v1y = daz(__fsub_rn(lmin, ea)), v2x = daz(__fsub_rn(lmin, ec));
  const float n1 = fma_ftz(v1y, v1y, daz(__fmul_rn(eb, eb)));
  const float n2 = fma_ftz(eb, eb, daz(__fmul_rn(v2x, v2x)));
  float vx = n1 > n2 ? eb : v2x, vy = n1 > n2 ? v1y : eb;
  const float norm = __fsqrt_rn(nan_max(n1, n2));
  if (norm > 1e-20f) {
    vx = daz(__fdiv_rn(vx, norm));
    vy = daz(__fdiv_rn(vy, norm));
  } else {
    vx = ea <= ec ? 1.0f : 0.0f;
    vy = ea <= ec ? 0.0f : 1.0f;
  }
  const float cond =
      daz(fabsf(__fdiv_rn(lmax, fabsf(lmin) > 1e-20f ? lmin : 1e-20f)));
  const float det = mul_ftz(lmax, lmin);
  const bool cov_ok =
      cond <= o.max_cond && det > o.min_det && lmin > 0.0f && lmax > 0.0f;
  const float planarity = ref_log1p(daz(__fdiv_rn(cond, 2.0f)));
  if (fma_ftz(vy, daz(__fsub_rn(o.oy, my)),
              mul_ftz(vx, daz(__fsub_rn(o.ox, mx)))) < 0.0f) {
    vx = -vx;
    vy = -vy;
  }
  const bool valid = occ && count >= o.min_neighbors && cov_ok &&
                     wsum > 1e-9f;
  const float avg = daz(__fdiv_rn(wsum, (float)(count > 1 ? count : 1)));

  const float z = 0.0f;
  o.mean[2 * c] = valid ? mx : z;
  o.mean[2 * c + 1] = valid ? my : z;
  o.cov[4 * c] = valid ? s00 : z;
  o.cov[4 * c + 1] = valid ? s01 : z;
  o.cov[4 * c + 2] = valid ? s10 : z;
  o.cov[4 * c + 3] = valid ? s11 : z;
  o.normal[2 * c] = valid ? vx : z;
  o.normal[2 * c + 1] = valid ? vy : z;
  o.nsamples[c] = valid ? (float)count : z;
  o.planarity[c] = valid ? planarity : z;
  o.avg[c] = valid ? avg : z;
  o.valid[c] = valid;
}

__global__ void __launch_bounds__(kWarps * 32)
    cells_kernel(const float2* __restrict__ xy,
                 const float* __restrict__ intensity,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ centroid,
                 const unsigned char* __restrict__ occupied,
                 float* __restrict__ mean_out, float* __restrict__ cov_out,
                 float* __restrict__ normal_out,
                 float* __restrict__ nsamples_out,
                 float* __restrict__ planarity_out,
                 float* __restrict__ avg_out,
                 unsigned char* __restrict__ valid_out, int P, int C,
                 float r2, int weight_intensity, float floor_w,
                 int min_neighbors, float max_cond, float min_det, float ox,
                 float oy) {
  const Cloud cl{xy, intensity, mask, P};
  const CellOut o{mean_out, cov_out, normal_out, nsamples_out, planarity_out,
                  avg_out, valid_out, min_neighbors, max_cond, min_det, ox,
                  oy};
  const Tree shape = tree_of(P);
  const int windows = (P + kWindow - 1) / kWindow, lo0 = shape.lo[0];
  const int lane = threadIdx.x & 31;
  const unsigned all = 0xffffffffu;

  for (int c = blockIdx.x * kWarps + (threadIdx.x >> 5); c < C;
       c += gridDim.x * kWarps) {
    const float c0 = centroid[2 * c], c1 = centroid[2 * c + 1];
    const bool occ = occupied[c] != 0;  // the same for the whole warp
    const float cc = ref_fma(c1, c1, __fmul_rn(c0, c0));

    // pass 1: the count, and the weight sum's windows of 32 points (lo0
    // points of padding in front), each window's neighbours added in order
    Tree tree = shape;
    int count = 0;
    for (int j0 = 0; occ && j0 < windows; j0 += kBatch) {
      bool nb[kBatch];
      float2 q[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        nb[u] = gate(cl, (j0 + u) * kWindow - lo0 + lane, c0, c1, cc, r2,
                     &q[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        unsigned bits = __ballot_sync(all, nb[u]);
        if (!bits) continue;
        const int p = (j0 + u) * kWindow - lo0 + lane;
        const float w = nb[u] ? weight(cl, p, weight_intensity, floor_w)
                              : 0.0f;
        count += __popc(bits);
        float s = 0.0f;
        while (bits) {
          const int src = __ffs(bits) - 1;
          bits &= bits - 1;
          s = __fadd_rn(s, __shfl_sync(all, w, src));
        }
        tree_add(tree, 1, j0 + u, s);
      }
    }
    const float wsum = tree_sum(tree);

    // pass 2: the six moments over the neighbours in point order
    const float wden = clamp_min(wsum, 1e-12f);
    float mu0 = 0.0f, mu1 = 0.0f, q00 = 0.0f, q01 = 0.0f, q10 = 0.0f,
          q11 = 0.0f;
    for (int b0 = 0; count > 0 && b0 < P; b0 += kBatch * 32) {
      bool nb[kBatch];
      float2 q[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        nb[u] = gate(cl, b0 + u * 32 + lane, c0, c1, cc, r2, &q[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        unsigned bits = __ballot_sync(all, nb[u]);
        if (!bits) continue;
        float wk = 0.0f, qx = 0.0f, qy = 0.0f;
        if (nb[u]) {
          wk = __fdiv_rn(weight(cl, b0 + u * 32 + lane, weight_intensity,
                                floor_w),
                         wden);
          qx = __fsub_rn(q[u].x, c0);
          qy = __fsub_rn(q[u].y, c1);
        }
        while (bits) {
          const int from = __ffs(bits) - 1;
          bits &= bits - 1;
          const float w = __shfl_sync(all, wk, from);
          const float a = __shfl_sync(all, qx, from);
          const float b = __shfl_sync(all, qy, from);
          const float wq0 = __fmul_rn(w, a), wq1 = __fmul_rn(w, b);
          mu0 = ref_fma(w, a, mu0);  // refmath.fma: subnormals flushed
          mu1 = ref_fma(w, b, mu1);
          q00 = ref_fma(wq0, a, q00);
          q01 = ref_fma(wq0, b, q01);
          q10 = ref_fma(wq1, a, q10);
          q11 = ref_fma(wq1, b, q11);
        }
      }
    }
    if (lane != 0) continue;
    finish_cell(o, c, occ, count, wsum, c0, c1, mu0, mu1, q00, q01, q10,
                q11);
  }
}


// The gate of a point q (pp = |q|^2, m its mask) against the cell (c0, c1,
// cc = |c|^2): gate()'s arithmetic with |q|^2 computed once for all cells.
__device__ __forceinline__ bool gate_at(float2 q, float pp, bool m, float c0,
                                        float c1, float cc, float r2) {
  const float dot = ref_fma(c1, q.y, __fmul_rn(c0, q.x));
  const float d2 = __fsub_rn(__fadd_rn(cc, pp), __fmul_rn(2.0f, dot));
  return m && d2 <= r2;
}

// the staged design's dynamic shared memory: the positions, the mask,
// then a bitmap a cell (a word a window)
__host__ __device__ constexpr size_t staged_xy_bytes(int P) {
  return ((size_t)P * 8 + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t staged_mask_bytes(int P) {
  return ((size_t)P + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t staged_bytes(int P) {
  return staged_xy_bytes(P) + staged_mask_bytes(P) +
         (size_t)kStagedCells * ((P + kWindow - 1) / kWindow) * 4;
}

// the largest staged cloud's dynamic shared memory and the kernel's static
// s_cell and s_occ fit the 227 KB a block may hold
static_assert(staged_bytes(kStageMax) + kStagedCells * (3 * 4 + 1) <=
                  227 * 1024,
              "the staged design's shared memory exceeds 227 KB at kStageMax");

__global__ void __launch_bounds__(kStagedWarps * 32)
    cells_staged_kernel(const float2* __restrict__ xy,
                        const float* __restrict__ intensity,
                        const unsigned char* __restrict__ mask,
                        const float* __restrict__ centroid,
                        const unsigned char* __restrict__ occupied,
                        CellOut o, int P, int C, float r2,
                        int weight_intensity, float floor_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_cell[kStagedCells][3];
  __shared__ unsigned char s_occ[kStagedCells];
  float2* sxy = reinterpret_cast<float2*>(smem);
  unsigned char* smask = smem + staged_xy_bytes(P);
  unsigned* bitmap = reinterpret_cast<unsigned*>(
      smask + staged_mask_bytes(P));
  const Cloud cl{xy, intensity, mask, P};
  const int windows = (P + kWindow - 1) / kWindow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = blockIdx.x * kStagedCells;
  const unsigned all = 0xffffffffu;

  // stage the positions (cp.async, 8 bytes a point) and the mask (plain
  // loads, in flight together), meanwhile the cells
  const unsigned base = (unsigned)__cvta_generic_to_shared(sxy);
  for (int i = tid; i < P; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     base + 8u * (unsigned)i),
                 "l"(xy + i));
  asm volatile("cp.async.commit_group;\n" ::);
  int from = 0;  // the mask 16 bytes a load where it is aligned so
  if (((uintptr_t)mask & 15) == 0) {
    const uint4* m4 = reinterpret_cast<const uint4*>(mask);
    uint4* s4 = reinterpret_cast<uint4*>(smask);
    for (int i = tid; i < P / 16; i += blockDim.x) s4[i] = __ldg(m4 + i);
    from = P / 16 * 16;
  }
  for (int i = from + tid; i < P; i += blockDim.x) smask[i] = __ldg(mask + i);
  if (tid < kStagedCells) {
    const int c = first + tid;
    const float c0 = c < C ? centroid[2 * c] : 0.0f;
    const float c1 = c < C ? centroid[2 * c + 1] : 0.0f;
    s_cell[tid][0] = c0;
    s_cell[tid][1] = c1;
    s_cell[tid][2] = ref_fma(c1, c1, __fmul_rn(c0, c0));
    s_occ[tid] = c < C && occupied[c] != 0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // the gate, once: warp w takes windows w, w + kStagedWarps, ...; each
  // cell's ballot is its bitmap's word of that window
  const Tree shape = tree_of(P);
  const int lo0 = shape.lo[0];
  float g0[kStagedCells], g1[kStagedCells], gc[kStagedCells];
  bool gocc[kStagedCells];
#pragma unroll
  for (int g = 0; g < kStagedCells; ++g) {
    g0[g] = s_cell[g][0];
    g1[g] = s_cell[g][1];
    gc[g] = s_cell[g][2];
    gocc[g] = s_occ[g] != 0;
  }
  for (int j = warp; j < windows; j += kStagedWarps) {
    const int p = j * kWindow - lo0 + lane;
    const bool in = p >= 0 && p < P;
    const float2 q = in ? sxy[p] : make_float2(0.0f, 0.0f);
    const bool m = in && smask[p] != 0;
    const float pp = ref_fma(q.y, q.y, __fmul_rn(q.x, q.x));
#pragma unroll
    for (int g = 0; g < kStagedCells; ++g) {
      const unsigned b = __ballot_sync(
          all, gocc[g] && gate_at(q, pp, m, g0[g], g1[g], gc[g], r2));
      if (lane == 0) bitmap[g * windows + j] = b;
    }
  }
  __syncthreads();
  if (warp >= kStagedCells || first + warp >= C) return;

  // a warp a cell: its bitmap's nonzero words in order
  const int c = first + warp;
  const float c0 = g0[warp], c1 = g1[warp];
  const unsigned* words = bitmap + warp * windows;
  // pass 1: the count and the weight sum's windows, in order, into the tree
  Tree tree = shape;
  int count = 0;
  for (int j0 = 0; j0 < windows; j0 += 32) {
    const unsigned word = j0 + lane < windows ? words[j0 + lane] : 0u;
    unsigned live = __ballot_sync(all, word != 0u);
    while (live) {
      const int at = __ffs(live) - 1;
      live &= live - 1;
      unsigned bits = __shfl_sync(all, word, at);
      const int j = j0 + at;
      const bool nb = (bits >> lane) & 1u;
      const float w = nb ? weight(cl, j * kWindow - lo0 + lane,
                                  weight_intensity, floor_w)
                         : 0.0f;
      count += __popc(bits);
      float s = 0.0f;
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        s = __fadd_rn(s, __shfl_sync(all, w, src));
      }
      tree_add(tree, 1, j, s);
    }
  }
  const float wsum = tree_sum(tree);

  // pass 2: the six moments, one neighbour at a time in point order
  const float wden = clamp_min(wsum, 1e-12f);
  float mu0 = 0.0f, mu1 = 0.0f, q00 = 0.0f, q01 = 0.0f, q10 = 0.0f,
        q11 = 0.0f;
  for (int j0 = 0; count > 0 && j0 < windows; j0 += 32) {
    const unsigned word = j0 + lane < windows ? words[j0 + lane] : 0u;
    unsigned live = __ballot_sync(all, word != 0u);
    while (live) {
      const int at = __ffs(live) - 1;
      live &= live - 1;
      unsigned bits = __shfl_sync(all, word, at);
      const int p = (j0 + at) * kWindow - lo0 + lane;
      float wk = 0.0f, qx = 0.0f, qy = 0.0f;
      if ((bits >> lane) & 1u) {
        wk = __fdiv_rn(weight(cl, p, weight_intensity, floor_w), wden);
        qx = __fsub_rn(sxy[p].x, c0);
        qy = __fsub_rn(sxy[p].y, c1);
      }
      while (bits) {
        const int from = __ffs(bits) - 1;
        bits &= bits - 1;
        const float w = __shfl_sync(all, wk, from);
        const float a = __shfl_sync(all, qx, from);
        const float b = __shfl_sync(all, qy, from);
        const float wq0 = __fmul_rn(w, a), wq1 = __fmul_rn(w, b);
        mu0 = ref_fma(w, a, mu0);  // refmath.fma: subnormals flushed
        mu1 = ref_fma(w, b, mu1);
        q00 = ref_fma(wq0, a, q00);
        q01 = ref_fma(wq0, b, q01);
        q10 = ref_fma(wq1, a, q10);
        q11 = ref_fma(wq1, b, q11);
      }
    }
  }
  if (lane == 0)
    finish_cell(o, c, s_occ[warp] != 0, count, wsum, c0, c1, mu0, mu1, q00,
                q01, q10, q11);
}
}  // namespace

// The cells' fields of C selected voxels over a cloud of P points (see
// above): the staged design up to kStageMax points, the global-memory one
// above; xy must be 8-byte aligned (kernels/cells.py).
extern "C" int cells_launch(const void* xy, const void* intensity,
                            const void* mask, const void* centroid,
                            const void* occupied, void* mean, void* cov,
                            void* normal, void* nsamples, void* planarity,
                            void* avg, void* valid, int P, int C, float r2,
                            int weight_intensity, float floor_w,
                            int min_neighbors, float max_cond, float min_det,
                            float ox, float oy, void* stream) {
  if (C <= 0) return 0;
  if (P < 0 || ((uintptr_t)xy & 7)) return (int)cudaErrorInvalidValue;
  if (P <= kStageMax) {
    // the largest staged cloud's shared memory, once a device
    static unsigned long long sized = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !((sized >> dev) & 1ull)) {
      e = cudaFuncSetAttribute(cells_staged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)staged_bytes(kStageMax));
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) sized |= 1ull << dev;
    }
    const CellOut o{(float*)mean, (float*)cov, (float*)normal,
                    (float*)nsamples, (float*)planarity, (float*)avg,
                    (unsigned char*)valid, min_neighbors, max_cond, min_det,
                    ox, oy};
    const int blocks = (C + kStagedCells - 1) / kStagedCells;
    cells_staged_kernel<<<blocks, kStagedWarps * 32, staged_bytes(P),
                          (cudaStream_t)stream>>>(
        (const float2*)xy, (const float*)intensity,
        (const unsigned char*)mask, (const float*)centroid,
        (const unsigned char*)occupied, o, P, C, r2, weight_intensity,
        floor_w);
    return (int)cudaGetLastError();
  }
  const int blocks = (C + kWarps - 1) / kWarps;
  cells_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float2*)xy, (const float*)intensity, (const unsigned char*)mask,
      (const float*)centroid, (const unsigned char*)occupied, (float*)mean,
      (float*)cov, (float*)normal, (float*)nsamples, (float*)planarity,
      (float*)avg, (unsigned char*)valid, P, C, r2, weight_intensity, floor_w,
      min_neighbors, max_cond, min_det, ox, oy);
  return (int)cudaGetLastError();
}
