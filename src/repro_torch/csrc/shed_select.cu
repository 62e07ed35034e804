// The load shedder's two kernels (paper Algorithm 2, histogram-threshold
// plan): the pSPICE utility lookup and the utility histogram.  Both work
// on stores of a few hundred to a few thousand slots, where the bytes
// they must move take nanoseconds and a launch takes a microsecond: what
// a call costs beyond an empty kernel is the chain of dependent steps
// each thread walks, so both are laid out to keep that chain short
// (tests/_shed_variants.py times the alternatives on the card).
//
// utility_lookup replaces src/repro/kernels/shed_select.py::_lookup_kernel
// (one Pallas launch per pattern, the table read through one-hot MXU
// matmuls).  Here one launch covers the whole (rows, N) store, rows = P
// patterns or the L·P pattern rows of a trim laid end to end, each row
// with its own (B, M) table and bin size; the table entries are plain
// gathers, which are exact.
//   pos  = clip(r_w / bs - 1, 0, B - 1);  j0 = floor(pos);
//   j1   = min(j0 + 1, B - 1);            frac = pos - j0;
//   u    = u0 * (1 - frac) + u1 * frac    (inactive slots: 3.4e38)
// Rounding is pinned op by op with the _rn intrinsics (and the build
// passes -fmad=false): the interpolation is ONE fused multiply-add,
// fma(u0, 1 - frac, u1 * frac), because that is how the reference
// kernel's interpolation rounds (repro::utility_at, shared with the block
// kernel).  Bound: bytes — per PM 4 B state + 4 B r_w + 1 B active in,
// 4 B out.  One thread a PM, 256 a CTA, grid (ceil(N / 256), rows), so a
// thread's row is its blockIdx.y and needs no division; every input load
// is issued at once, inactive slots included (no early return): the
// row's bin size, the flag, the state and the window in one round trip,
// then the two table gathers, skipped for inactive slots.  Four PMs a
// thread over the flattened store (int4 loads) and tables staged in
// shared memory with cp.async were measured and were slower or no
// faster on the H100: a thread's four interpolations run in series, and
// a staged table costs a barrier for a gather that hits L1/L2 anyway.
//
// utility_histogram replaces src/repro/kernels/shed_select.py::_hist_kernel
// (per-tile comparison counts accumulated across a sequential TPU grid).
// Bucket b owns [edges[b], edges[b+1]); the edges come from
// core.shedder.bucket_edges (monotone, top edge +inf) and are never
// recomputed here.  Membership is decided by the two edge comparisons,
// so it is the reference's bit for bit, and NaN, which fails every
// comparison, is never counted.  Bound: bytes — 4 B per utility in,
// nbins·4 B out.
//   * One CTA a lane (one utility a thread up to 1 024 threads, then
//     rounds of kBatch a thread), or for lanes past the wrapper's
//     HIST_ONE_CTA a thread-block cluster of 8 CTAs (grid x = the
//     cluster, grid y = the lane; the kernel's kCluster instances): each
//     CTA counts its share into its own shared memory, and after
//     cluster.sync() each CTA sums one slice of the bins over the
//     cluster through distributed shared memory and stores it.  Every
//     count is written once with plain stores: no memset and no global
//     atomics, so a call is one device operation.
//   * A thread's utilities (its one, or a round of kBatch) are in flight
//     before it copies its edges into shared memory, and one barrier
//     covers both.  On a kernel this short every instruction counts: a
//     thread with one utility runs an instance with no loop and no spare
//     slots, and indices are 32-bit within a lane (each measurably
//     shortened a call on the H100).
//   * The bucket search guesses from the first bucket's width and walks
//     (bucket_near): two or three dependent shared reads where a
//     bisection takes log2(nbins).
//   * Increments are plain shared atomics.  Warp-aggregated increments
//     (__match_any_sync) and per-warp sub-histograms were measured on
//     the H100 and were slower, on a refinement level's hot buckets too.
//
// utility_histogram_lanes is the lane instance of _hist_kernel (the
// reference vmaps it over tenant lanes in the ladder's PM trim,
// src/repro/runtime/guard.py:116): each lane its own (n,) utilities,
// (nbins+1,) edges and (nbins,) counts.  The one-lane launch is its
// L = 1 case.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;            // a lookup CTA
constexpr int kMaxThreads = 1024;        // a histogram CTA, at most
constexpr float kInactive = 3.4e38f;
constexpr int kBatch = 4;      // utilities a thread loads at once, past 1 024
constexpr int kWalk = 2;       // walk steps before the bucket search bisects
constexpr int kMaxCluster = 8;           // the portable cluster size

__global__ void utility_lookup_kernel(
    const int32_t* __restrict__ state, const int32_t* __restrict__ r_w,
    const uint8_t* __restrict__ active, const float* __restrict__ tables,
    const int32_t* __restrict__ bins, int n, int num_bins, int m,
    float* __restrict__ out) {
  const int p = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool in = j < n;
  const int f = p * n + j;
  const int32_t bs = __ldg(bins + p);
  const int32_t s = in ? state[f] : -1;
  const int32_t r = in ? r_w[f] : 0;
  const bool act = in && active[f];
  const float v = repro::utility_at(tables, p, num_bins, m, act ? s : -1, r,
                                    bs);
  if (in) out[f] = act ? v : kInactive;
}

// The bucket b with e[b] <= v < e[b + 1], or -1: repro::bucket_of's
// answer, found from a guess.  The edges are uniform up to rounding, so
// b = (v - e[0]) · (1 / (e[1] - e[0])), clamped to [0, nbins - 1], is the
// bucket or a neighbour; a walk of kWalk steps settles it, and where it
// does not (collapsed edges, runs of equal edges a few ulps apart) a
// bisection of what is left finishes as bucket_of does.  Either way the
// result is the largest b with e[b] <= v, confirmed by the two edge
// comparisons; NaN and values below e[0] fail the first test, +inf
// lands on b = nbins and fails the confirmation.
__device__ __forceinline__ int bucket_near(float v, const float* e,
                                           float e0, float inv, int nbins) {
  if (!(v >= e0)) return -1;
  float g = __fmul_rn(__fsub_rn(v, e0), inv);
  g = fminf(fmaxf(g, 0.0f), __int2float_rn(nbins - 1));  // NaN -> 0
  const int b = __float2int_rz(g);
  int lo, hi;                    // the answer lies in [lo, hi]
  if (e[b] <= v) {
    lo = b;
    hi = nbins;
#pragma unroll
    for (int k = 0; k < kWalk; ++k) {
      if (lo < hi) {
        if (e[lo + 1] <= v) ++lo; else hi = lo;
      }
    }
  } else {                       // e[0] <= v < e[b], so b > 0
    lo = 0;
    hi = b - 1;
#pragma unroll
    for (int k = 0; k < kWalk; ++k) {
      if (lo < hi) {
        if (e[hi] > v) --hi; else lo = hi;
      }
    }
  }
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (e[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return (lo < nbins && v >= e[lo] && v < e[lo + 1]) ? lo : -1;
}

// K: utilities a thread loads at once (1: its CTA covers its share in one
// round, with no loop; 4: in rounds of 4 a thread).  kCluster: the lane's
// gridDim.x CTAs are one thread-block cluster, each counting a share of
// the lane; otherwise one CTA counts the whole lane.
template <int K, bool kCluster>
__global__ void utility_histogram_kernel(const float* __restrict__ u, int n,
                                         const float* __restrict__ edges,
                                         int nbins, int32_t* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const float kNone = __int_as_float(0x7fc00000);   // NaN: counts nowhere
  const int threads = blockDim.x;
  const int64_t lane = blockIdx.y;
  float* e = reinterpret_cast<float*>(smem);
  int32_t* counts = reinterpret_cast<int32_t*>(e + nbins + 1);
  int v0 = 0, v1 = n;                  // this CTA counts [v0, v1)
  if (kCluster) {
    const int per = (n + gridDim.x - 1) / gridDim.x;
    v0 = min(n, static_cast<int>(blockIdx.x) * per);
    v1 = min(n, v0 + per);
  }
  const float* mine = u + lane * n + v0;
  const int m = v1 - v0;
  // 1. This thread's first K utilities in flight, then the edges.
  float x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * threads + threadIdx.x;
    x[k] = i < m ? __ldg(mine + i) : kNone;
  }
  edges += lane * (nbins + 1);
  for (int b = threadIdx.x; b <= nbins; b += threads) e[b] = edges[b];
  for (int b = threadIdx.x; b < nbins; b += threads) counts[b] = 0;
  __syncthreads();
  // 2. Count on chip, K utilities a thread at a time.
  const float e0 = e[0];
  const float inv = __frcp_rn(__fsub_rn(e[1], e0));
  for (int base = 0;;) {
    int bucket[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bucket[k] = bucket_near(x[k], e, e0, inv, nbins);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (bucket[k] >= 0) atomicAdd(&counts[bucket[k]], 1);
    }
    if (K == 1) break;               // the launch gives one thread each
    base += K * threads;
    if (base >= m) break;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = base + k * threads + threadIdx.x;
      x[k] = i < m ? __ldg(mine + i) : kNone;
    }
  }
  // 3. Each count written once.
  out += lane * nbins;
  if (!kCluster) {
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += threads) out[b] = counts[b];
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ctas = gridDim.x;
  for (int b = blockIdx.x * threads + threadIdx.x; b < nbins;
       b += ctas * threads) {
    int32_t sum = 0;
    for (int q = 0; q < ctas; ++q) {
      sum += cluster.map_shared_rank(counts, q)[b];
    }
    out[b] = sum;
  }
  cluster.sync();        // no CTA leaves while another reads its counts
}

}  // namespace

// p <= 65 535 rows (the grid's y) and p·n < 2**31 (the wrapper checks
// both).
extern "C" int utility_lookup_launch(const void* state, const void* r_w,
                                     const void* active, const void* tables,
                                     const void* bins, int p, int n,
                                     int num_bins, int m, void* out,
                                     void* stream) {
  if (p > 0 && n > 0) {
    const dim3 grid((n + kThreads - 1) / kThreads, p);
    utility_lookup_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(state), static_cast<const int32_t*>(r_w),
        static_cast<const uint8_t*>(active),
        static_cast<const float*>(tables), static_cast<const int32_t*>(bins),
        n, num_bins, m, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// `ctas` CTAs a lane (1 .. 8; the wrapper picks them from n), each of as
// many threads as its share has utilities, in warps, at most 1 024: one
// CTA is a plain launch, more a cluster launch of that size.  n <= 2**30,
// so a lane's 32-bit indices never overflow.
extern "C" int utility_histogram_lanes_launch(const void* u, int lanes,
                                              long long n, const void* edges,
                                              int nbins, int ctas, void* out,
                                              void* stream) {
  if (lanes <= 0) return static_cast<int>(cudaGetLastError());
  if (ctas < 1 || ctas > kMaxCluster || n < 0 || n > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long share = (n + ctas - 1) / ctas;
  const bool one = share <= kMaxThreads;       // a utility a thread
  const int threads =
      one ? static_cast<int>(share < 32 ? 32 : (share + 31) / 32 * 32)
          : kMaxThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, lanes, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes =
      sizeof(float) * (nbins + 1) + sizeof(int32_t) * nbins;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  const auto* uu = static_cast<const float*>(u);
  const auto* ee = static_cast<const float*>(edges);
  auto* oo = static_cast<int32_t*>(out);
  const int nn = static_cast<int>(n);
  void (*kernel)(const float*, int, const float*, int, int32_t*) =
      ctas > 1 ? (one ? utility_histogram_kernel<1, true>
                      : utility_histogram_kernel<kBatch, true>)
               : (one ? utility_histogram_kernel<1, false>
                      : utility_histogram_kernel<kBatch, false>);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, uu, nn, ee, nbins,
                                             oo);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int utility_histogram_launch(const void* u, long long n,
                                        const void* edges, int nbins,
                                        int ctas, void* out, void* stream) {
  return utility_histogram_lanes_launch(u, 1, n, edges, nbins, ctas, out,
                                        stream);
}
