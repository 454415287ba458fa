// CorAl radius-neighbour moments for a batch of cloud pairs, for sm_90a.
//
// Replaces tbv_slam_public_tpu/pallas/coral_moments.py::_moments_kernel.
// For every masked query q of batch row m it sums, over the masked points p
// of the same row with |p - q|^2 <= r^2: the count, sum(p - q) and the three
// distinct entries of sum (p - q)(p - q)^T, in query-centred float32.
//
// Bound: float32 operations.  A verification wave is 4 x 64 pairs x 4096 x
// 4096 (query, point) interactions against a few MB of point lists, and the
// radius gate of one interaction is 2 sub, 1 mul, 1 fma and a compare.  An
// SM quarter starts one warp instruction per cycle, so the design spends
// those slots on live interactions only and keeps every SM quarter supplied
// with warps:
//
// 1. Live points and live queries only, decided on the card.  A first small
//    kernel compacts every cloud row once: warp ballots and a running count
//    place each live point at its rank, in its original order, beside its
//    slot number, and zero the outputs of the dead slots.  The moments kernel
//    reads the compacted lists: its inner loop loads no mask and tests none,
//    a block of dead queries returns at once, every tile it stages is full,
//    and a query's sums run in ascending point index however the cloud is
//    padded.
// 2. Register tiling.  A thread carries kR queries (6 running moments each)
//    and reads two points per 128-bit shared load (x0, y0, x1, y1), a
//    broadcast: one load per 2 * kR interactions.  A warp whose lanes hold
//    fewer than kR queries runs the loop written for that count.
// 3. Branch on the gate.  The 2 * kR squared distances of a step are reduced
//    with fminf and compared once; a warp vote sends the whole warp into the
//    accumulating path, which forms the distances again and gates each.  The
//    vote on a step is taken under the next step's arithmetic and the shared
//    load runs one step ahead, so neither chain stalls the warp.  The steady
//    state is 2 sub, 2 mul, 1 add and 1 min per interaction.
// 4. Rounding.  d2 rounds as the reference's compiled program rounds its
//    two-term sum of squares: fma(dy, dy, dx*dx), written with __fmul_rn /
//    __fmaf_rn so nvcc cannot choose another contraction.  The vote and the
//    gate use the same distance, so the counts are the reference's and the
//    plain PyTorch version's bit for bit.
//    The |q|^2 + |p|^2 - 2 q.p form would lose the gate to cancellation, so
//    the tensor cores (wgmma) have no use here; nor has TMA, with megabytes
//    of input against billions of operations.
// 5. Filling the card.  Warps stay on the SM quarter they start on, so the
//    unit of work has to be small against a quarter's share.  A block is 128
//    live queries of one row held by all of its kWarps warps; each warp takes
//    an equal range of the row's live points, stages its own tiles (no block
//    barrier in the loop), and warp 0 adds the warps' moments in warp order,
//    through shared memory.  The split of the point axis thus stays inside
//    the block: an online launch of 12 rows is 384 blocks of 8 warps on 132
//    SMs, and no partial sums cross blocks.  No float atomics anywhere: two
//    runs give the same bits.
// 6. One launch per pair wave.  gridDim.z carries up to four
//    (query cloud, point cloud) combinations, so coral_pair_moments_launch
//    computes src->src, src->ref, ref->ref and ref->src in one grid.
//
// Pair rows are addressed through a row stride, so a cloud broadcast over the
// batch (stride 0) is read in place.
//
// coral_tail (ops/coral.py::coral_tail) is a second kernel in this file:
// CorAl's per-point terms and the pairs' sums after the moments, described
// above coral_tail_kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "refmath.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;            // warps per block of the moments kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;        // per SM: caps registers at 80
constexpr int kR = 4;                // queries per thread
constexpr int kQueries = 32 * kR;    // live queries per block
constexpr int kTile = 256;           // live points a warp stages at once
constexpr int kStepPoints = 2;       // points per step: one float4
constexpr int kCombos = 4;
constexpr int kCompactThreads = 256;
constexpr int kCompactRounds = 16;   // slots per thread and pass
constexpr unsigned kFull = 0xffffffffu;

// One cloud of the launch: M rows of N (point, mask byte) slots.  The
// compacting kernel writes, per row, the live points in their original order
// (``live``), their slots (``slot``) and their number (``n_live``), and zeroes
// the outputs of the dead slots in the ``groups`` output groups the cloud's
// queries own.
struct Cloud {
  const float2* xy;     // [M, N], row stride xy_row points
  const uint8_t* mask;  // [M, N], row stride mask_row bytes
  long long xy_row, mask_row;
  float2* live;         // [M, stride]
  int* slot;            // [M, stride]
  int* n_live;          // [M]
  int N, stride;        // stride: N rounded up to even
  int groups, column;   // output groups 0..groups-1, first output column
};

// One (query cloud, point cloud) combination and its output group.
struct Combo {
  int q, p, group;
};

struct Params {
  Cloud clouds[2];
  Combo combos[kCombos];
  // outputs [groups, M, width] each: group stride = M * width slots
  float* count;
  float2* sum_rel;
  float4* sum_sq;       // (xx, xy, yx, yy)
  long long width;
  float r2;
};

__device__ __forceinline__ void store(const Params& prm, long long o,
                                      const float (&a)[6]) {
  prm.count[o] = a[0];
  prm.sum_rel[o] = make_float2(a[1], a[2]);
  prm.sum_sq[o] = make_float4(a[3], a[4], a[4], a[5]);
}

__device__ __forceinline__ float distance2(float dx, float dy) {
  return __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
}

// The reference's threads flush subnormals (DAZ and FTZ): a subnormal
// offset counts as zero and a subnormal sum is zero (refmath.cuh's .ftz
// forms).  Only the sums need it: the gate's own flushes change no
// decision at a normal radius.
__device__ __forceinline__ void accumulate(float (&a)[6], float dx, float dy,
                                           float r2) {
  if (distance2(dx, dy) <= r2) {  // the .ftz forms flush dx, dy too
    a[0] += 1.f;
    a[1] = add_ftz(a[1], dx);
    a[2] = add_ftz(a[2], dy);
    a[3] = fma_ftz(dx, dx, a[3]);
    a[4] = fma_ftz(dx, dy, a[4]);
    a[5] = fma_ftz(dy, dy, a[5]);
  }
}

// Smallest squared distance between the first R queries of a thread and the
// two points of one step.
template <int R>
__device__ __forceinline__ float nearest(float4 pp, const float (&qx)[kR],
                                         const float (&qy)[kR]) {
  float d[2 * R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    d[2 * j] = distance2(pp.x - qx[j], pp.y - qy[j]);
    d[2 * j + 1] = distance2(pp.z - qx[j], pp.w - qy[j]);
  }
#pragma unroll
  for (int w = 1; w < 2 * R; w *= 2) {  // a tree, not a chain
#pragma unroll
    for (int i = 0; i + w < 2 * R; i += 2 * w) d[i] = fminf(d[i], d[i + w]);
  }
  return d[0];
}

// The accumulating path of one step: the same distances again, each gated.
template <int R>
__device__ __forceinline__ void gather(float4 pp, const float (&qx)[kR],
                                       const float (&qy)[kR], float r2,
                                       float (&acc)[kR][6]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    accumulate(acc[j], pp.x - qx[j], pp.y - qy[j], r2);
    accumulate(acc[j], pp.z - qx[j], pp.w - qy[j], r2);
  }
}

// The first R queries of a thread against a staged tile of 2 * steps points.
// Every lane of the warp runs the same R.  The tile is readable two steps
// past its end.
template <int R>
__device__ __forceinline__ void scan_tile(const float4* tile, int steps,
                                          const float (&qx)[kR],
                                          const float (&qy)[kR], float r2,
                                          float (&acc)[kR][6]) {
  if (steps == 0) return;
  float4 prev = tile[0], next = tile[1];
  float near_prev = nearest<R>(prev, qx, qy);
#pragma unroll 2
  for (int i = 1; i <= steps; ++i) {
    const bool hit = __any_sync(kFull, near_prev <= r2);
    const float4 cur = next;
    next = tile[i + 1];
    const float near_cur = nearest<R>(cur, qx, qy);  // unused when i == steps
    if (hit) gather<R>(prev, qx, qy, r2, acc);
    prev = cur;
    near_prev = near_cur;
  }
}

template <int R>
__device__ __forceinline__ void scan_slots(int slots, const float4* tile,
                                           int steps, const float (&qx)[kR],
                                           const float (&qy)[kR], float r2,
                                           float (&acc)[kR][6]) {
  if (slots == R) {
    scan_tile<R>(tile, steps, qx, qy, r2, acc);
  } else if constexpr (R > 1) {
    scan_slots<R - 1>(slots, tile, steps, qx, qy, r2, acc);
  }
}

// Compacts one row of one cloud: blockIdx = (row, cloud).  A pass takes
// kCompactThreads * kCompactRounds slots, round r of thread t being slot
// r * kCompactThreads + t: all loads of a pass are in flight together, warp
// ballots count the live slots of every (round, warp), and a running sum
// over those counts in slot order gives every live point its rank.
__global__ void __launch_bounds__(kCompactThreads)
coral_compact_kernel(const __grid_constant__ Params prm) {
  constexpr int kW = kCompactThreads / 32;
  __shared__ int counts[kCompactRounds][kW];
  const Cloud& cl = prm.clouds[blockIdx.y];
  const long long m = blockIdx.x, M = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint8_t* mask = cl.mask + m * cl.mask_row;
  const float2* xy = cl.xy + m * cl.xy_row;
  float2* live = cl.live + m * cl.stride;
  int* slot = cl.slot + m * cl.stride;
  const float zero[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int done = 0;  // live points of the passes before this one
  for (int first = 0; first < cl.N;
       first += kCompactThreads * kCompactRounds) {
    unsigned votes[kCompactRounds];
    float2 p[kCompactRounds];
#pragma unroll
    for (int r = 0; r < kCompactRounds; ++r) {
      const int s = first + r * kCompactThreads + tid;
      bool on = false;
      p[r] = make_float2(0.f, 0.f);
      if (s < cl.N) {
        on = mask[s] != 0;
        p[r] = xy[s];
      }
      votes[r] = __ballot_sync(kFull, on);
    }
    __syncthreads();  // the previous pass has read its counts
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kCompactRounds; ++r)
        counts[r][warp] = __popc(votes[r]);
    }
    __syncthreads();
    int at = done;
#pragma unroll
    for (int r = 0; r < kCompactRounds; ++r) {
      int mine = 0;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        if (w == warp) mine = at;
        at += counts[r][w];
      }
      const int s = first + r * kCompactThreads + tid;
      if ((votes[r] >> lane) & 1u) {
        const int rank = mine + __popc(votes[r] & ((1u << lane) - 1u));
        live[rank] = p[r];
        slot[rank] = s;
      } else if (s < cl.N) {
        for (int g = 0; g < cl.groups; ++g)
          store(prm, (g * M + m) * prm.width + cl.column + s, zero);
      }
    }
    done = at;
  }
  if (tid == 0) cl.n_live[m] = done;
}

// blockIdx = (query block, row, combination).  The block takes the live
// queries [blockIdx.x * kQueries, +kQueries) of its row; its warps hold the
// same queries and share the row's live points equally.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
coral_moments_kernel(const __grid_constant__ Params prm) {
  // a warp's tile, readable two steps past its end; later the warps' moments
  constexpr int kTileFloats = 2 * (kTile + 2 * kStepPoints);
  constexpr int kPassFloats = (kWarps - 1) * kR * 6 * 32;
  __shared__ __align__(16) float
      shared[kWarps * kTileFloats > kPassFloats ? kWarps * kTileFloats
                                                : kPassFloats];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long m = blockIdx.y, M = gridDim.y;
  const Combo& co = prm.combos[blockIdx.z];
  const Cloud& qc = prm.clouds[co.q];
  const Cloud& pc = prm.clouds[co.p];
  const int first = blockIdx.x * kQueries;
  if (first >= qc.N) return;
  const int nq = min(kQueries, qc.n_live[m] - first);
  if (nq <= 0) return;  // the whole block: no live query is left for it

  // every warp holds the same queries: lane l has l, l + 32, ...
  const float2* qlive = qc.live + m * qc.stride + first;
  const int* qslot = qc.slot + m * qc.stride + first;
  float qx[kR], qy[kR], acc[kR][6];
  int slot[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    slot[j] = -1;
    qx[j] = INFINITY;  // an empty lane gates nothing
    qy[j] = 0.f;
    if (j * 32 + lane < nq) {
      slot[j] = qslot[j * 32 + lane];
      const float2 q = qlive[j * 32 + lane];
      qx[j] = q.x;
      qy[j] = q.y;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[j][k] = 0.f;
  }
  const int slots = (nq + 31) / 32;  // queries per lane that any lane holds

  // this warp's range of the live points, a whole number of steps, staged
  // by the warp itself in tiles
  const int np = pc.n_live[m];
  const int share = ((np + kWarps - 1) / kWarps + kStepPoints - 1) /
                    kStepPoints * kStepPoints;
  const int lo = min(np, warp * share);
  const int hi = min(np, lo + share);
  const float2* plive = pc.live + m * pc.stride;
  float2* tile = reinterpret_cast<float2*>(shared + warp * kTileFloats);
  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    const int padded = (n + kStepPoints - 1) / kStepPoints * kStepPoints;
    __syncwarp();  // the previous tile is consumed
    // the last step is filled up with a point that no query reaches
    for (int i = lane; i < padded; i += 32)
      tile[i] = i < n ? plive[base + i] : make_float2(INFINITY, 0.f);
    __syncwarp();
    scan_slots<kR>(slots, reinterpret_cast<const float4*>(tile),
                   padded / kStepPoints, qx, qy, prm.r2, acc);
  }

  // warp 0 adds the other warps' moments to its own, in warp order
  __syncthreads();
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < kR; ++j) {
#pragma unroll
      for (int k = 0; k < 6; ++k)
        shared[(((warp - 1) * kR + j) * 6 + k) * 32 + lane] = acc[j][k];
    }
  }
  __syncthreads();
  if (warp > 0) return;
  for (int w = 0; w < kWarps - 1; ++w) {
#pragma unroll
    for (int j = 0; j < kR; ++j) {
#pragma unroll
      for (int k = 0; k < 6; ++k)
        acc[j][k] = add_ftz(acc[j][k],
                            shared[((w * kR + j) * 6 + k) * 32 + lane]);
    }
  }

#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (slot[j] >= 0)
      store(prm, (co.group * M + m) * prm.width + qc.column + slot[j], acc[j]);
  }
}

inline long long round_up(long long x, long long to) {
  return (x + to - 1) / to * to;
}

// Fills the launch parameters, carves ``scratch`` and launches the kernels.
// ``out`` holds n = groups * M * width output slots as sum_sq [n] float4,
// then sum_rel [n] float2, then count [n] float, so every vector store is
// aligned whatever n is.  ``scratch`` (4-byte words): n_live [2, M] rounded
// up to 4 words; per cloud slot [M, stride]; per cloud live [M, stride]
// float2.  Returns -1 if ``scratch_words`` is short.
int launch(Params& prm, int combos, int groups, int M, float r2,
           float* out, float* scratch, long long scratch_words,
           cudaStream_t stream) {
  const long long n = (long long)groups * M * prm.width;
  prm.sum_sq = reinterpret_cast<float4*>(out);
  prm.sum_rel = reinterpret_cast<float2*>(out + 4 * n);
  prm.count = out + 6 * n;
  prm.r2 = r2;
  float* at = scratch + round_up(2 * M, 4);
  for (Cloud& cl : prm.clouds) {
    cl.stride = (int)round_up(cl.N, 2);
    cl.n_live = reinterpret_cast<int*>(scratch) + (&cl - prm.clouds) * M;
    cl.slot = reinterpret_cast<int*>(at);
    at += (long long)M * cl.stride;
  }
  at = scratch + round_up(at - scratch, 4);
  for (Cloud& cl : prm.clouds) {
    cl.live = reinterpret_cast<float2*>(at);
    at += 2LL * M * cl.stride;
  }
  int max_q = 0;
  for (int c = 0; c < combos; ++c) {
    const int q = prm.clouds[prm.combos[c].q].N;
    max_q = q > max_q ? q : max_q;
  }
  if (at - scratch > scratch_words) return -1;
  if (M > 0 && max_q > 0) {
    coral_compact_kernel<<<dim3(M, 2), kCompactThreads, 0, stream>>>(prm);
    dim3 grid((max_q + kQueries - 1) / kQueries, M, combos);
    coral_moments_kernel<<<grid, kThreads, 0, stream>>>(prm);
  }
  return (int)cudaGetLastError();
}

void set_cloud(Cloud& cl, const void* xy, const void* mask, long long xy_row,
               long long mask_row, int N, int groups, int column) {
  cl.xy = (const float2*)xy;
  cl.mask = (const uint8_t*)mask;
  cl.xy_row = xy_row;
  cl.mask_row = mask_row;
  cl.N = N;
  cl.groups = groups;
  cl.column = column;
}

// ---- coral_tail: CorAl's per-point terms and the pairs' sums ------------
//
// ops/coral.py::coral_tail_reference after pair_moments, for M pairs in one
// launch: each live query's joint moments, gates, mean and covariance
// (s2 - n m m^T fused), determinant, entropy 0.5 log(2 pi e det + eps) of
// its own and its joint neighbourhood (or, in KL mode, the KL divergence of
// its own neighbourhood against its joint one; a src point's against its
// own), the finiteness gates; then, over a pair's Q = S + R query slots,
// the count of valid queries, the two masked sums in the reference's order
// (core/refmath.py::tree_sum: windows of 32 slots, half the padding in
// front, each summed in order from zero, then windows of those sums), the
// means, the overlap and valid = overlap >= 0.1.  Every operation is the
// plain version's, each rounding written out (__f*_rn, ref_fma, refmath.cuh's
// ref_log), subnormals flushed (daz), so the outputs are the plain
// version's bit for bit given the same moments.
//
// Not a TPU kernel: the JAX package's _coral_impl leaves this tail to XLA,
// which fuses it around the Pallas call.  The port's plain version runs it
// as about 70 launches a call.  Bound: bytes, 56 a live query (its 14
// moment floats), about 9 us for a 64-pair wave of 8,192 live slots each.
// Design: a thread-block cluster of G CTAs a pair (G <= 8, chosen by the
// host from M and the pair's windows so that M x G fills the SMs), each CTA
// a contiguous run of the level-1 windows (32 slots of the padded slot
// space, half the padding in front), a warp a window (two windows at a
// time, their loads in flight together): its lanes read the window's 32
// mask bytes (one coalesced 32-byte load) and vote; a window
// with no live slot adds to +0.0 with a count of 0 and reads no moment;
// else a lane computes its slot's terms, the lanes store them in the
// warp's shared-memory row, and lanes 0 and 1 add the 32 sep and the 32
// joint values in order from zero (8 float4 loads each; no block barrier
// between slots and windows).  Lanes 0 and 1 write the window's two sums,
// its valid count and its live count into the cluster leader's shared
// memory (distributed shared memory); after one cluster.sync the leader
// adds the levels of 32 (a warp a window, a chain of shuffles) and the
// counts, and writes joint, sep, overlap and valid.  Adding +0.0 to a sum that starts at +0.0
// changes no bit, so padding is a matter of which slots share a window.
// (A block of 1,024 threads a pair, a thread a slot, with a barrier after
// each pass of 4,096 slots and between levels, fills only 12-13 of the
// 132 SMs at the online shapes.)
constexpr int kTailWarps = 32;
constexpr int kTailThreads = 32 * kTailWarps;
constexpr int kTreeWindow = 32;
constexpr int kTailMaxCluster = 8;  // the portable cluster size

// (kernels/coral_moments.py::TAIL_PARAMS packs it: 112 bytes)
struct TailParams {
  const float* count;     // [2, M, Q]
  const float2* sum_rel;  // [2, M, Q]
  const float4* sum_sq;   // [2, M, Q]: (xx, xy, yx, yy)
  const uint8_t* smask;   // [M, S], row stride smask_row
  const uint8_t* rmask;   // [M, R], row stride rmask_row
  long long smask_row, rmask_row;
  int M, S, R, kl;
  float eps, two_pi_e;
  float* joint;
  float* sep;
  float* overlap;
  uint8_t* valid;
};

// _mean_cov_from_moments: the mean and the covariance [c00, c01, c10, c11]
__device__ __forceinline__ void tail_mean_cov(float n, float2 s1, float4 s2,
                                              float* mean, float* cov) {
  const float nc = n < 1.0f ? 1.0f : n;
  mean[0] = daz(__fdiv_rn(s1.x, nc));
  mean[1] = daz(__fdiv_rn(s1.y, nc));
  const float nm[2] = {__fmul_rn(n, mean[0]), __fmul_rn(n, mean[1])};
  const float sq[4] = {s2.x, s2.y, s2.z, s2.w};
  float nd = __fsub_rn(n, 1.0f);
  nd = nd < 1.0f ? 1.0f : nd;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      cov[2 * i + j] = daz(__fdiv_rn(ref_fma(-nm[i], mean[j], daz(sq[2 * i + j])), nd));
}

__device__ __forceinline__ float tail_det(const float* c) {
  return daz(ref_fma(c[0], c[3], -mul_ftz(c[1], c[2])));
}

// _entropy_from_moments
__device__ __forceinline__ float tail_entropy(const TailParams& p, float n,
                                              float2 s1, float4 s2) {
  float mean[2], cov[4];
  tail_mean_cov(n, s1, s2, mean, cov);
  return __fmul_rn(0.5f, ref_log(ref_fma(p.two_pi_e, tail_det(cov), p.eps)));
}

// _kl_divergence_2d(u0, s0, u1, s1); *finite its flag
__device__ float tail_kl(const float* u0, const float* s0, const float* u1,
                         const float* s1, bool* finite) {
  const float det0 = tail_det(s0), det1 = tail_det(s1);
  const float inv = daz(__fdiv_rn(1.0f, det1 == 0.0f ? 1.0f : det1));
  // every lone product flushed by its exact value (mul_ftz), as the
  // reference's FTZ threads and the plain version flush it
  const float s1i[4] = {mul_ftz(s1[3], inv), mul_ftz(-s1[1], inv),
                        mul_ftz(-s1[2], inv), mul_ftz(s1[0], inv)};
  // tr(S1^-1 S0): the four products in order, each rounded
  float trace = mul_ftz(s1i[0], s0[0]);
  trace = daz(__fadd_rn(trace, mul_ftz(s1i[1], s0[2])));
  trace = daz(__fadd_rn(trace, mul_ftz(s1i[2], s0[1])));
  trace = daz(__fadd_rn(trace, mul_ftz(s1i[3], s0[3])));
  const float d0 = daz(__fsub_rn(u1[0], u0[0])), d1 = daz(__fsub_rn(u1[1], u0[1]));
  const float t0 = ref_fma(d1, s1i[2], mul_ftz(d0, s1i[0]));
  const float t1 = ref_fma(d1, s1i[3], mul_ftz(d0, s1i[1]));
  const float mahal = ref_fma(d1, t1, mul_ftz(d0, t0));
  const float score = daz(__fmul_rn(
      0.5f, daz(__fadd_rn(daz(__fsub_rn(daz(__fadd_rn(trace, mahal)), 3.0f)),
                          ref_log(daz(__fdiv_rn(det1, det0)))))));
  *finite = isfinite(score) && det1 != 0.0f;
  return *finite ? score : 0.0f;
}

// a query's moments over its own cloud and over the other
struct TailMoments {
  float n_own, n_oth;
  float2 r_own, r_oth;
  float4 q_own, q_oth;
};

// query q of pair m's moments: six loads, issued together
__device__ __forceinline__ TailMoments tail_load(const TailParams& p, int m,
                                                 int q) {
  const int Q = p.S + p.R;
  const long long own = (long long)m * Q + q, oth = own + (long long)p.M * Q;
  return {__ldg(p.count + own), __ldg(p.count + oth),
          __ldg(p.sum_rel + own), __ldg(p.sum_rel + oth),
          __ldg(p.sum_sq + own), __ldg(p.sum_sq + oth)};
}

// live query q's (sep, joint) terms and validity from its moments
__device__ void tail_terms(const TailParams& p, int q, const TailMoments& t,
                           float* vs, float* vj, int* ok) {
  const bool is_ref = q >= p.S;
  *vs = 0.0f, *vj = 0.0f, *ok = 0;
  const float n_own = t.n_own, n_oth = t.n_oth;
  const float2 r_own = t.r_own, r_oth = t.r_oth;
  const float4 q_own = t.q_own, q_oth = t.q_oth;
  const float n_joint = __fadd_rn(n_own, n_oth);
  if (!(n_oth >= 1.0f && n_own > 2.0f && n_joint > 2.0f)) return;
  const float2 r_joint = make_float2(daz(__fadd_rn(r_own.x, r_oth.x)),
                                     daz(__fadd_rn(r_own.y, r_oth.y)));
  const float4 q_joint = make_float4(
      daz(__fadd_rn(q_own.x, q_oth.x)), daz(__fadd_rn(q_own.y, q_oth.y)),
      daz(__fadd_rn(q_own.z, q_oth.z)), daz(__fadd_rn(q_own.w, q_oth.w)));
  if (p.kl) {
    float u0[2], s0[4], u1[2], s1[4];
    tail_mean_cov(n_own, r_own, q_own, u0, s0);
    if (is_ref) {
      tail_mean_cov(n_joint, r_joint, q_joint, u1, s1);
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) u1[k] = u0[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) s1[k] = s0[k];
    }
    bool finite;
    const float score = tail_kl(u0, s0, u1, s1, &finite);
    if (finite) *vj = score, *ok = 1;
    return;
  }
  const float sep = tail_entropy(p, n_own, r_own, q_own);
  const float joint = tail_entropy(p, n_joint, r_joint, q_joint);
  if (isfinite(sep) && isfinite(joint)) *vs = sep, *vj = joint, *ok = 1;
}

// the in-order sum from zero of the 32 lanes' v (lane 0's first), in
// every lane
__device__ __forceinline__ float lanes_in_order(float v) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kTreeWindow; ++k)
    acc = __fadd_rn(acc, __shfl_sync(kFull, v, k));
  return acc;
}

// The in-order sums from zero of the 32 lanes' a (in lane 0) and b (in
// lane 1), through the warp's 64 floats of shared memory: two stores a
// lane, then 8 float4 loads and 32 adds in the two lanes.
__device__ __forceinline__ float window_sums(float a, float b, float* row) {
  const int lane = threadIdx.x & 31;
  row[lane] = a;
  row[kTreeWindow + lane] = b;
  __syncwarp();
  float acc = 0.0f;
  if (lane < 2) {
    const float4* v = reinterpret_cast<const float4*>(row + lane * kTreeWindow);
#pragma unroll
    for (int k = 0; k < kTreeWindow / 4; ++k) {
      const float4 x = v[k];
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, x.x), x.y), x.z),
                      x.w);
    }
  }
  __syncwarp();
  return acc;
}

// the sum of the 32 lanes' v (integers: any order)
__device__ __forceinline__ int lanes_total(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The leader's level-1 arrays: the windows' sep and joint sums, valid and
// live counts ([n1] each, in dynamic shared memory).
struct TailLevels {
  float* sep;
  float* joint;
  int* valid;
  int* live;
};

__device__ __forceinline__ TailLevels tail_levels(float* base, int n1) {
  return {base, base + n1, reinterpret_cast<int*>(base + 2 * n1),
          reinterpret_cast<int*>(base + 3 * n1)};
}

__global__ void __launch_bounds__(kTailThreads)
    coral_tail_kernel(const TailParams p) {
  extern __shared__ float tail_smem[];
  // a warp's window values (sep, joint) for window_sums
  __shared__ __align__(16) float rows[kTailWarps][2 * kTreeWindow];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int m = blockIdx.x / G, Q = p.S + p.R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n1 = (Q + kTreeWindow - 1) / kTreeWindow;
  // Q <= 32: one window of the Q slots (the whole sum); else windows of 32
  // in the padded slot space, half the padding in front
  const int front = Q <= kTreeWindow ? 0 : (n1 * kTreeWindow - Q) / 2;
  const TailLevels leader = tail_levels(
      cluster.map_shared_rank(tail_smem, 0), n1);
  // level 1: this CTA's run of windows, a warp a window, two windows of a
  // warp at a time (their mask and moment loads in flight together)
  const int per = (n1 + G - 1) / G;
  const int w_end = min(n1, (rank + 1) * per);
  for (int w0 = rank * per + warp; w0 < w_end; w0 += 2 * kTailWarps) {
    int q[2];
    bool live[2];
    unsigned lives[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int w = w0 + k * kTailWarps;
      q[k] = w * kTreeWindow + lane - front;
      live[k] = w < w_end && q[k] >= 0 && q[k] < Q &&
                (q[k] < p.S ? p.smask[m * p.smask_row + q[k]]
                            : p.rmask[m * p.rmask_row + (q[k] - p.S)]) != 0;
      lives[k] = __ballot_sync(kFull, live[k]);
    }
    TailMoments mo[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (live[k]) mo[k] = tail_load(p, m, q[k]);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int w = w0 + k * kTailWarps;
      float sum = 0.0f;  // lane 0: the window's sep sum, lane 1: joint
      int valid = 0;
      if (lives[k]) {  // uniform in the warp
        float vs = 0.0f, vj = 0.0f;
        int ok = 0;
        if (live[k]) tail_terms(p, q[k], mo[k], &vs, &vj, &ok);
        sum = window_sums(vs, vj, rows[warp]);
        valid = __popc(__ballot_sync(kFull, ok != 0));
      }
      if (w < w_end) {
        if (lane == 0) {
          leader.sep[w] = sum;
          leader.valid[w] = valid;
          leader.live[w] = __popc(lives[k]);
        } else if (lane == 1) {
          leader.joint[w] = sum;
        }
      }
    }
  }
  cluster.sync();  // every window's sums are in the leader
  if (rank != 0) return;
  // the windows' sums, windows of 32 again (half the padding in front)
  // until at most 32 are left, a warp a window; then the counts
  float* buf[2] = {leader.sep, tail_smem + 4 * n1};
  float* bufj[2] = {leader.joint, tail_smem + 4 * n1 + (n1 + 31) / 32};
  int len = n1, cur = 0;
  while (len > kTreeWindow) {
    const int n2 = (len + kTreeWindow - 1) / kTreeWindow;
    const int f2 = (n2 * kTreeWindow - len) / 2;
    for (int w = warp; w < n2; w += kTailWarps) {
      const int i = w * kTreeWindow + lane - f2;
      const bool in = i >= 0 && i < len;
      const float as = lanes_in_order(in ? buf[cur][i] : 0.0f);
      const float aj = lanes_in_order(in ? bufj[cur][i] : 0.0f);
      if (lane == 0) buf[cur ^ 1][w] = as, bufj[cur ^ 1][w] = aj;
    }
    cur ^= 1;
    len = n2;
    __syncthreads();
  }
  if (warp == 0) {  // the last level (at most 32 sums) in order from zero
    const float as = lanes_in_order(lane < len ? buf[cur][lane] : 0.0f);
    const float aj = lanes_in_order(lane < len ? bufj[cur][lane] : 0.0f);
    int count = 0, lives = 0;
    for (int w = lane; w < n1; w += 32)
      count += leader.valid[w], lives += leader.live[w];
    count = lanes_total(count);
    lives = lanes_total(lives);
    if (lane == 0) {
      const float denom = count < 1 ? 1.0f : (float)count;
      p.sep[m] = __fdiv_rn(as, denom);
      p.joint[m] = __fdiv_rn(aj, denom);
      const float ov = __fdiv_rn((float)count, (float)(lives < 1 ? 1 : lives));
      p.overlap[m] = ov;
      p.valid[m] = ov >= 0.1f;
    }
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  Both launch on ``stream`` and
// return cudaGetLastError() so a refused launch surfaces in the wrapper.
// Row strides count elements (float2 points, mask bytes).

// One (query cloud, point cloud) combination over M pair rows; outputs
// [M, Q].
extern "C" int coral_moments_launch(const void* queries, const void* qmask,
                                    const void* points, const void* pmask,
                                    long long q_row, long long qm_row,
                                    long long p_row, long long pm_row,
                                    int M, int Q, int P, float r2,
                                    void* out, void* scratch,
                                    long long scratch_words, void* stream) {
  Params prm = {};
  set_cloud(prm.clouds[0], queries, qmask, q_row, qm_row, Q, 1, 0);
  set_cloud(prm.clouds[1], points, pmask, p_row, pm_row, P, 0, 0);
  prm.combos[0] = {0, 1, 0};
  prm.width = Q;
  return launch(prm, 1, 1, M, r2, (float*)out, (float*)scratch,
                scratch_words, (cudaStream_t)stream);
}

// The four combinations of M (src [S], ref [R]) cloud pairs in one grid.
// Outputs are [2, M, S + R]: group 0 holds each query's moments over its own
// cloud, group 1 over the other cloud; columns [0, S) are the src queries,
// [S, S + R) the ref queries.
extern "C" int coral_pair_moments_launch(const void* src, const void* smask,
                                         const void* ref, const void* rmask,
                                         long long s_row, long long sm_row,
                                         long long r_row, long long rm_row,
                                         int M, int S, int R, float r2,
                                         void* out, void* scratch,
                                         long long scratch_words,
                                         void* stream) {
  Params prm = {};
  set_cloud(prm.clouds[0], src, smask, s_row, sm_row, S, 2, 0);
  set_cloud(prm.clouds[1], ref, rmask, r_row, rm_row, R, 2, S);
  prm.combos[0] = {0, 0, 0};  // src -> src
  prm.combos[1] = {0, 1, 1};  // src -> ref
  prm.combos[2] = {1, 1, 0};  // ref -> ref
  prm.combos[3] = {1, 0, 1};  // ref -> src
  prm.width = (long long)S + R;
  return launch(prm, kCombos, 2, M, r2, (float*)out, (float*)scratch,
                scratch_words, (cudaStream_t)stream);
}

// CorAl's quality of M pairs from their moments (count [2, M, Q], sum_rel
// [2, M, Q, 2], sum_sq [2, M, Q, 2, 2], contiguous, Q = S + R) and masks
// (src [M, S], ref [M, R] bytes, row strides in bytes): joint, sep, overlap
// [M] float32 and valid [M] bytes, entropy mode or (kl != 0) KL mode; eps
// and 2 pi e as float32.  ``params`` is the TailParams the wrapper packs
// (kernels/coral_moments.py::TAIL_PARAMS); cluster: the CTAs a pair (0:
// chosen from M and the windows), the size used written to *cluster_out.
// Returns a CUDA error code.
extern "C" int coral_tail_launch(const void* params, int cluster,
                                 int* cluster_out, void* stream) {
  TailParams p;
  memcpy(&p, params, sizeof(TailParams));
  const int M = p.M, S = p.S, R = p.R;
  if (M <= 0) return 0;
  if (S < 0 || R < 0 || M > 2147483647 / 2) return (int)cudaErrorInvalidValue;
  const long long n1 = ((long long)S + R + kTreeWindow - 1) / kTreeWindow;
  if (n1 == 0) return (int)cudaErrorInvalidValue;
  // cluster size G: M x G CTAs fill the 132 SMs where the windows allow
  int G = cluster;
  if (G <= 0) {
    G = 132 / M;
    G = G < 1 ? 1 : G > kTailMaxCluster ? kTailMaxCluster : G;
    if (G > n1) G = (int)n1;
  }
  if (G < 1 || G > kTailMaxCluster) return (int)cudaErrorInvalidValue;
  // the level-1 arrays (4 x n1) and the second level's two (n1 / 32 each),
  // in every CTA (only the leader's are used)
  const long long smem = (4 * n1 + 2 * ((n1 + 31) / 32)) * 4;
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        coral_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)M * (unsigned)G);
  cfg.blockDim = dim3(kTailThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster_out) *cluster_out = G;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, coral_tail_kernel, p);
  static_assert(sizeof(TailParams) == 112, "TAIL_PARAMS");
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
