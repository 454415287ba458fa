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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ void accumulate(float (&a)[6], float dx, float dy,
                                           float r2) {
  if (distance2(dx, dy) <= r2) {
    a[0] += 1.f;
    a[1] += dx;
    a[2] += dy;
    a[3] += dx * dx;
    a[4] += dx * dy;
    a[5] += dy * dy;
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
        acc[j][k] += shared[((w * kR + j) * 6 + k) * 32 + lane];
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
