// The load shedder's two kernels (paper Algorithm 2, histogram-threshold
// plan): the pSPICE utility lookup and the utility histogram.
//
// utility_lookup replaces src/repro/kernels/shed_select.py::_lookup_kernel
// (one Pallas launch per pattern, the table read through one-hot MXU
// matmuls).  Here one launch covers the whole (P, N) store: grid
// (ceil(N / 256), P), each pattern with its own (B, M) table and bin size,
// and the table entries are plain gathers, which are exact.
//   pos  = clip(r_w / bs - 1, 0, B - 1);  j0 = floor(pos);
//   j1   = min(j0 + 1, B - 1);            frac = pos - j0;
//   u    = u0 * (1 - frac) + u1 * frac    (inactive slots: 3.4e38)
// Rounding is pinned op by op with the _rn intrinsics (and the build
// passes -fmad=false): the interpolation is ONE fused multiply-add,
// fma(u0, 1 - frac, u1 * frac), because that is how the reference
// kernel's interpolation rounds.
// Bound: bytes — per PM 4 B state + 4 B r_w + 1 B active in, 4 B out;
// the tables (P·B·M·4 B, ~5 KB on the stock path) stay in L1/L2.
//
// utility_histogram replaces src/repro/kernels/shed_select.py::_hist_kernel
// (per-tile comparison counts accumulated across a sequential TPU grid).
// Blocks run in parallel here, so each block counts into shared memory
// and adds its counts to the global (nbins,) output with integer atomics,
// which are order-free.  Bucket b owns [edges[b], edges[b+1]); the edges
// come from core.shedder.bucket_edges (monotone, top edge +inf) and are
// never recomputed here.  A binary search finds the one candidate bucket
// and the two edge comparisons confirm it, so membership is the
// reference's comparison bit for bit; NaN fails every comparison and is
// never counted.
// Bound: bytes — 4 B per utility in, nbins·4 B out; the edges sit in
// shared memory.  At P·N of a few thousand, launch latency dominates.
//
// utility_histogram_lanes is the lane instance of _hist_kernel (the
// reference vmaps it over tenant lanes in the ladder's PM trim,
// src/repro/runtime/guard.py:116): the grid's y axis is the lane, each
// lane its own (n,) utilities, (nbins+1,) edges and (nbins,) counts.  The
// one-lane launch above is its L = 1 case.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kInactive = 3.4e38f;

__global__ void utility_lookup_kernel(
    const int32_t* __restrict__ state, const int32_t* __restrict__ r_w,
    const uint8_t* __restrict__ active, const float* __restrict__ tables,
    const int32_t* __restrict__ bins, int n, int num_bins, int m,
    float* __restrict__ out) {
  const int p = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int64_t at = static_cast<int64_t>(p) * n + j;
  if (!active[at]) {
    out[at] = kInactive;
    return;
  }
  out[at] = repro::utility_at(tables, p, num_bins, m, state[at], r_w[at],
                              bins[p]);
}

__global__ void utility_histogram_kernel(const float* __restrict__ u,
                                         int64_t n,
                                         const float* __restrict__ edges,
                                         int nbins, int32_t* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int64_t lane = blockIdx.y;
  u += lane * n;
  edges += lane * (nbins + 1);
  out += lane * nbins;
  float* e = reinterpret_cast<float*>(smem);
  int32_t* counts = reinterpret_cast<int32_t*>(e + nbins + 1);
  for (int b = threadIdx.x; b <= nbins; b += blockDim.x) e[b] = edges[b];
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) counts[b] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int b = repro::bucket_of(u[i], e, nbins);
    if (b >= 0) atomicAdd(&counts[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    if (counts[b]) atomicAdd(&out[b], counts[b]);
  }
}

}  // namespace

extern "C" int utility_lookup_launch(const void* state, const void* r_w,
                                     const void* active, const void* tables,
                                     const void* bins, int p, int n,
                                     int num_bins, int m, void* out,
                                     void* stream) {
  if (p > 0 && n > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, p);
    utility_lookup_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(state), static_cast<const int32_t*>(r_w),
        static_cast<const uint8_t*>(active),
        static_cast<const float*>(tables), static_cast<const int32_t*>(bins),
        n, num_bins, m, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int utility_histogram_lanes_launch(const void* u, int lanes,
                                              long long n, const void* edges,
                                              int nbins, void* out,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int32_t) * nbins * static_cast<size_t>(lanes), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && lanes > 0) {
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int per_lane = static_cast<int>(want < 264 ? want : 264);
    const size_t shmem = sizeof(float) * (nbins + 1) +
                         sizeof(int32_t) * nbins;
    utility_histogram_kernel<<<dim3(per_lane, lanes), kThreads, shmem, st>>>(
        static_cast<const float*>(u), static_cast<int64_t>(n),
        static_cast<const float*>(edges), nbins, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int utility_histogram_launch(const void* u, long long n,
                                        const void* edges, int nbins,
                                        void* out, void* stream) {
  return utility_histogram_lanes_launch(u, 1, n, edges, nbins, out, stream);
}
