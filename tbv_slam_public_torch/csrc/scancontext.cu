// ScanContext's keys, its ring-key distance and its pairwise distance, as
// the reference's compiled CPU program rounds them
// (core/refmath.py::sc_key, sc_ring_distance, sc_distance, their plain
// versions; the table above them says how each order was read).
//
// Not a TPU kernel: the JAX package leaves these to XLA's fusions and the
// runtime's matrix product.  Every sum over a descriptor axis is XLA's CPU
// tree reduction (windows of 32, half the padding in front, each window
// summed in order from zero, then the windows' sums), every product, sum
// and division rounded once and its subnormal operands and result flushed
// (.ftz instructions, daz), as the reference's DAZ / FTZ threads do.
//
// sc_key_kernel: a lane a window of an output key (a ring's mean over its
// sectors or a sector's over its rings).  sc_ring_distance_kernel: a
// thread a (query, database key) pair.  Both read a few kB and are launch
// latency at the paths' shapes.
//
// sc_distance_kernel: a block a (query, candidate) pair of retrieve's
// [B, A, K] pairs.  The two descriptors are staged in shared memory (2 x
// 40 x 120 floats), then: the column sums and norms (a thread a column),
// the sector keys' squared differences at every shift (a thread a shift,
// its 120 terms in the tree's order), the first least of them (one warp),
// the Gram entries only at the 2 r + 1 shifts the search reaches (a
// thread an entry: one fused multiply-add a ring from zero, the order of
// the reference's matrix product), their similarities and sums (a thread
// a shift) and the first least distance.  The reference computes the
// whole 120 x 120 Gram matrix and masks all but those shifts with +inf;
// the masked entries never win, so they are not computed.  Bound:
// operations (about 2 R S (2 r + 1) for the Gram entries and 3 S^2 for the
// alignment a pair) against 38 kB read a pair.
#include "refmath.cuh"

namespace {

constexpr int kWindow = 32;   // XLA's tree-reduction window
constexpr int kLead = 4;      // leading (batch) dimensions of an operand

// The tree sum of the n <= 32 * 32 values f(0) .. f(n - 1), each flushed:
// windows of 32 over the values padded to a multiple of 32 (half the
// padding, rounded down, in front), each summed in order from zero, then
// the windows' sums in order from zero.  The padding adds zeros, which
// leave a sum that starts at +0 unchanged, so it is skipped.
template <class F>
__device__ __forceinline__ float tree_sum(int n, F f) {
  if (n <= kWindow) {
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc = add_ftz(acc, f(k));
    return acc;
  }
  const int m = (n + kWindow - 1) / kWindow;
  const int front = (m * kWindow - n) / 2;
  float top = 0.0f;
  for (int w = 0; w < m; ++w) {
    const int lo = max(w * kWindow - front, 0);
    const int hi = min((w + 1) * kWindow - front, n);
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) acc = add_ftz(acc, f(k));
    top = add_ftz(top, acc);
  }
  return top;
}

// the element offsets of flat index i over a leading shape (innermost
// last) for two operands' strides
__device__ __forceinline__ void lead_offsets(int i, const int* shape,
                                             const int* s0, const int* s1,
                                             int* o0, int* o1) {
  int a = 0, b = 0;
  for (int d = kLead - 1; d >= 0; --d) {
    const unsigned m = (unsigned)shape[d];
    const int c = (int)((unsigned)i % m);
    i = (int)((unsigned)i / m);
    a += c * s0[d];
    b += c * s1[d];
  }
  *o0 = a;
  *o1 = b;
}

// the first least of v[0..n) (a NaN below every number, as torch.argmin
// and jnp.argmin take it), over one warp; lane 0 gets it
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

__device__ __forceinline__ void warp_argmin(float* v, int* iv) {
  for (int o = 16; o > 0; o /= 2) {
    const float w = __shfl_down_sync(0xffffffffu, *v, o);
    const int iw = __shfl_down_sync(0xffffffffu, *iv, o);
    if (before(w, iw, *v, *iv)) {
      *v = w;
      *iv = iw;
    }
  }
}

// out [rows, R] (ring) or [rows, S] (sector): the mean of each ring over
// its sectors, or of each sector over its rings, of contiguous descriptors
// desc [rows, R, S]: the tree sum times rcp (the float32 1 / count).  A
// key's windows are summed side by side, a lane a window (g lanes a key,
// g the windows rounded up to a power of two), and the group's first lane
// adds the window sums in order from zero: the tree's order, with a
// window's 32 dependent adds in series instead of the key's 120.
__global__ void sc_key_kernel(const float* __restrict__ desc,
                              float* __restrict__ out, int rows, int nr,
                              int ns, int ring, float rcp) {
  const int per = ring ? nr : ns;       // keys a descriptor
  const int n = ring ? ns : nr;         // values a key sums
  const int step = ring ? 1 : ns;       // their stride
  const int m = n <= kWindow ? 1 : (n + kWindow - 1) / kWindow;
  const int front = (m * kWindow - n) / 2;
  int g = 1;
  while (g < m) g *= 2;
  const int total = rows * per;
  const int lane = threadIdx.x & 31, sub = lane & (g - 1);
  const int keys_warp = 32 / g;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  // a loop whose trip count is the warp's, so that every lane shuffles
  for (int k0 = warp * keys_warp; k0 < total; k0 += warps * keys_warp) {
    const int key = k0 + lane / g;
    float part = 0.0f;
    if (key < total && sub < m) {
      const float* d = desc + (key / per) * nr * ns +
                       (ring ? (key % per) * ns : key % per);
      const int lo = m == 1 ? 0 : max(sub * kWindow - front, 0);
      const int hi = m == 1 ? n : min((sub + 1) * kWindow - front, n);
      for (int j = lo; j < hi; ++j) part = add_ftz(part, daz(d[j * step]));
    }
    float sum = part;
    if (m > 1) {
      sum = 0.0f;
      for (int w = 0; w < m; ++w)
        sum = add_ftz(sum, __shfl_sync(0xffffffffu, part,
                                       (lane & ~(g - 1)) + w));
    }
    if (key < total && sub == 0) out[key] = mul_ftz(sum, rcp);
  }
}

// retrieve's squared ring-key distances, out [rows, N]: query keys q
// [rows, R] and the mask and odometry similarity [rows, N] read through
// their leading strides (kLead dimensions, innermost last), the database
// keys db [N, R] contiguous; sum_r (db - q)^2 by the tree, plus
// fma(10 sim, 10 sim, sum) where odom is given, +inf where not masked.
struct RingArgs {
  const float* q;
  const float* db;
  const unsigned char* mask;
  const float* odom;
  float* out;
  int rows, n, nr, pad;
  int shape[kLead];
  int q_stride[kLead];
  int m_stride[kLead];
  int o_stride[kLead];
  int m_last, o_last;
};

__global__ void sc_ring_distance_kernel(const RingArgs a) {
  const int total = a.rows * a.n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int row = i / a.n, j = i % a.n;
    int qo, mo, oo, unused;
    lead_offsets(row, a.shape, a.q_stride, a.m_stride, &qo, &mo);
    lead_offsets(row, a.shape, a.o_stride, a.o_stride, &oo, &unused);
    const float* q = a.q + qo;
    const float* db = a.db + j * a.nr;
    float s = tree_sum(a.nr, [&](int r) {
      const float d = add_ftz(db[r], -q[r]);
      return mul_ftz(d, d);
    });
    if (a.odom != nullptr) {
      const float m = mul_ftz(a.odom[oo + j * a.o_last], 10.0f);
      s = fma_ftz(m, m, s);
    }
    a.out[i] = a.mask[mo + j * a.m_last] ? s : __int_as_float(0x7f800000);
  }
}

// sc_distance of pairs: query and candidate [lead..., R, S] read through
// their strides (kLead leading dimensions, innermost last, then the ring's
// and the sector's), dist [pairs] and shift [pairs] (int64) out.
struct PairArgs {
  const float* q;
  const float* c;
  float* dist;
  long long* shift;
  int pairs, nr, ns, radius;
  int shape[kLead];
  int q_stride[kLead];
  int c_stride[kLead];
  int q_ring, q_sector, c_ring, c_sector;
  float rcp_r, pad;
};

constexpr int kPairThreads = 128;

__global__ void __launch_bounds__(kPairThreads)
    sc_distance_kernel(const PairArgs a) {
  extern __shared__ float sm[];
  const int nr = a.nr, ns = a.ns, cells = nr * ns;
  const int width = 2 * a.radius + 1 >= ns ? ns : 2 * a.radius + 1;
  float* qs = sm;                 // [R, S]
  float* cs = qs + cells;         // [R, S]
  float* vq = cs + cells;         // the query's column sums [S]
  float* vc = vq + ns;            // the candidate's sector keys [S]
  float* qn = vc + ns;            // the columns' norms [S]
  float* cn = qn + ns;
  float* diff = cn + ns;          // the alignment sums [S], then distances
  float* sim = diff + ns;         // [width, S]
  __shared__ int center;
  const int tid = threadIdx.x;
  for (int p = blockIdx.x; p < a.pairs; p += gridDim.x) {
    int qo, co;
    lead_offsets(p, a.shape, a.q_stride, a.c_stride, &qo, &co);
    for (int k = tid; k < cells; k += blockDim.x) {
      const int r = k / ns, s = k % ns;
      qs[k] = daz(a.q[qo + r * a.q_ring + s * a.q_sector]);
      cs[k] = daz(a.c[co + r * a.c_ring + s * a.c_sector]);
    }
    __syncthreads();
    for (int s = tid; s < ns; s += blockDim.x) {
      vq[s] = tree_sum(nr, [&](int r) { return qs[r * ns + s]; });
      vc[s] = mul_ftz(tree_sum(nr, [&](int r) { return cs[r * ns + s]; }),
                      a.rcp_r);
      qn[s] = __fsqrt_rn(tree_sum(nr, [&](int r) {
        return mul_ftz(qs[r * ns + s], qs[r * ns + s]);
      }));
      cn[s] = __fsqrt_rn(tree_sum(nr, [&](int r) {
        return mul_ftz(cs[r * ns + s], cs[r * ns + s]);
      }));
    }
    __syncthreads();
    // the sector keys' alignment: sum_col (vq/R - vc[col - shift])^2
    for (int sh = tid; sh < ns; sh += blockDim.x) {
      diff[sh] = tree_sum(ns, [&](int col) {
        int src = col - sh;
        src += src < 0 ? ns : 0;
        const float d = fma_ftz(vq[col], a.rcp_r, -vc[src]);
        return mul_ftz(d, d);
      });
    }
    __syncthreads();
    if (tid < 32) {
      float v = __int_as_float(0x7fc00000);
      int iv = 1 << 30;
      bool any = false;
      for (int sh = tid; sh < ns; sh += 32) {
        if (!any || before(diff[sh], sh, v, iv)) {
          v = diff[sh];
          iv = sh;
          any = true;
        }
      }
      if (!any) v = __int_as_float(0x7f800000);  // loses to every value
      warp_argmin(&v, &iv);
      if (tid == 0) center = iv;
    }
    __syncthreads();
    // the similarities at the shifts within the radius of the centre
    for (int k = tid; k < width * ns; k += blockDim.x) {
      const int w = k / ns, col = k % ns;
      int sh = width == ns ? w : center + w - a.radius;
      sh += sh < 0 ? ns : 0;
      sh -= sh >= ns ? ns : 0;
      int src = col - sh;
      src += src < 0 ? ns : 0;
      float dot = 0.0f;
      for (int r = 0; r < nr; ++r)
        dot = fma_ftz(qs[r * ns + col], cs[r * ns + src], dot);
      const float prod = mul_ftz(qn[col], cn[src]);
      const float den = prod < 1e-20f ? 1e-20f : prod;
      sim[k] = qn[col] > 0.0f && cn[src] > 0.0f
                   ? daz(__fdiv_rn(dot, den)) : 0.0f;
    }
    __syncthreads();
    for (int w = tid; w < width; w += blockDim.x) {
      int sh = width == ns ? w : center + w - a.radius;
      sh += sh < 0 ? ns : 0;
      sh -= sh >= ns ? ns : 0;
      int count = 0;
      for (int col = 0; col < ns; ++col) {
        int src = col - sh;
        src += src < 0 ? ns : 0;
        count += qn[col] > 0.0f && cn[src] > 0.0f;
      }
      const float sum = tree_sum(ns, [&](int col) { return sim[w * ns + col]; });
      diff[w] = daz(__fsub_rn(
          1.0f, daz(__fdiv_rn(sum, (float)(count > 1 ? count : 1)))));
    }
    __syncthreads();
    if (tid < 32) {
      // the first least over the shifts in shift order (+inf elsewhere)
      float v = __int_as_float(0x7f800000);
      int iv = 0;
      for (int w = tid; w < width; w += 32) {
        int sh = width == ns ? w : center + w - a.radius;
        sh += sh < 0 ? ns : 0;
        sh -= sh >= ns ? ns : 0;
        if (before(diff[w], sh, v, iv)) {
          v = diff[w];
          iv = sh;
        }
      }
      warp_argmin(&v, &iv);
      if (tid == 0) {
        // all +inf: the masked row's first +inf, shift 0
        const bool inf = v == __int_as_float(0x7f800000);
        a.dist[p] = v;
        a.shift[p] = inf ? 0 : iv;
      }
    }
    __syncthreads();
  }
}

int grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

// out = sc_key of contiguous desc [rows, R, S] (ring: [rows, R], else
// [rows, S]); rcp the float32 1 / count.
extern "C" int sc_key_launch(const void* desc, void* out, int rows, int nr,
                             int ns, int ring, float rcp, void* stream) {
  const long long total = (long long)rows * (ring ? nr : ns);
  if (total <= 0) return 0;
  if (nr > kWindow * kWindow || ns > kWindow * kWindow)
    return (int)cudaErrorInvalidValue;
  const int n = ring ? ns : nr;
  int lanes = 1;  // a key's lanes: its windows, rounded up to a power of 2
  while (lanes * kWindow < n) lanes *= 2;
  sc_key_kernel<<<grid_for(total * lanes, 128), 128, 0,
                  (cudaStream_t)stream>>>((const float*)desc, (float*)out,
                                          rows, nr, ns, ring, rcp);
  return (int)cudaGetLastError();
}

// retrieve's ring-key distances; args: kernels/refmath.py::SC_RING_ARGS.
extern "C" int sc_ring_distance_launch(const void* argp, void* stream) {
  const RingArgs* args = static_cast<const RingArgs*>(argp);
  const long long total = (long long)args->rows * args->n;
  if (total <= 0) return 0;
  if (args->nr > kWindow * kWindow) return (int)cudaErrorInvalidValue;
  sc_ring_distance_kernel<<<grid_for(total, 128), 128, 0,
                            (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// sc_distance of args->pairs pairs; args: kernels/refmath.py::SC_PAIR_ARGS.
extern "C" int sc_distance_launch(const void* argp, void* stream) {
  const PairArgs* args = static_cast<const PairArgs*>(argp);
  if (args->pairs <= 0) return 0;
  const int nr = args->nr, ns = args->ns;
  if (nr > kWindow * kWindow || ns > kWindow * kWindow || nr < 1 || ns < 1)
    return (int)cudaErrorInvalidValue;
  const int width = 2 * args->radius + 1 >= ns ? ns : 2 * args->radius + 1;
  const size_t smem = sizeof(float) * ((size_t)2 * nr * ns + 5 * (size_t)ns +
                                       (size_t)width * ns);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sc_distance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = args->pairs < 132 * 32 ? args->pairs : 132 * 32;
  sc_distance_kernel<<<blocks, kPairThreads, smem, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
