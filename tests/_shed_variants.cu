// Design alternatives of the shed kernels (csrc/shed_select.cu), timed
// against the shipped kernels by tests/_shed_variants.py on the card.
// Each is the shipped kernel with one choice made the other way, or the
// kernel of the previous design:
//   hist_prev      the histogram before its redesign: a memset of the
//                  counts, then min(ceil(n / 256), 264) CTAs of 256
//                  threads a lane, a bisection (repro::bucket_of) and
//                  global atomics;
//   hist_variant   the shipped kernel's structure (K utilities a thread
//                  loaded up front, one CTA a lane or a cluster) with
//                  AGG = 0 plain shared atomics, 1 warp-aggregated ones
//                  (__match_any_sync), 2 per-warp sub-histograms, 3 none;
//                  GUESS = 0 bisection, 1 the guess-and-walk, 2 no search
//                  (bucket = thread mod nbins: the kernel's skeleton);
//   lookup_prev    the lookup before its redesign: one thread a PM, the
//                  active flag first, then state, window and bin size,
//                  then the table gathers;
//   lookup_rows    the shipped lookup's layout with the row's table
//                  staged in shared memory with cp.async, or with no
//                  table read at all (the window written as the utility:
//                  the kernel's skeleton);
//   lookup_variant four PMs a thread over the flattened store (int4
//                  loads), the rows' tables staged or not.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/common.cuh"

namespace cg = cooperative_groups;

namespace {

template <int GUESS>
__device__ __forceinline__ int bucket(float v, const float* e, float e0,
                                      float inv, int nbins) {
  if (GUESS == 0) return repro::bucket_of(v, e, nbins);
  if (GUESS == 2) return v >= e0 ? static_cast<int>(threadIdx.x) % nbins : -1;
  if (!(v >= e0)) return -1;
  float g = __fmul_rn(__fsub_rn(v, e0), inv);
  g = fminf(fmaxf(g, 0.0f), __int2float_rn(nbins - 1));
  const int b = __float2int_rz(g);
  int lo, hi;
  if (e[b] <= v) {
    lo = b;
    hi = nbins;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (lo < hi) { if (e[lo + 1] <= v) ++lo; else hi = lo; }
    }
  } else {
    lo = 0;
    hi = b - 1;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (lo < hi) { if (e[hi] > v) --hi; else lo = hi; }
    }
  }
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (e[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return (lo < nbins && v >= e[lo] && v < e[lo + 1]) ? lo : -1;
}

// The shipped kernel's structure (utility_histogram_kernel): K utilities
// a thread loaded up front, no loop where K covers the share.
template <int AGG, int GUESS, bool CLUSTER, int K>
__global__ void hist_variant(const float* __restrict__ u, int n,
                             const float* __restrict__ edges, int nbins,
                             int32_t* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x, ctas = gridDim.x, rank = blockIdx.x;
  const int64_t lane = blockIdx.y;
  float* e = reinterpret_cast<float*>(smem);
  int32_t* c = reinterpret_cast<int32_t*>(e + nbins + 1);
  const int copies = AGG == 2 ? T / 32 : 1;
  const float kNone = __int_as_float(0x7fc00000);
  int v0 = 0, v1 = n;
  if (CLUSTER) {
    const int per = (n + ctas - 1) / ctas;
    v0 = min(n, rank * per);
    v1 = min(n, v0 + per);
  }
  const float* mine = u + lane * n + v0;
  const int m = v1 - v0;
  float x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * T + threadIdx.x;
    x[k] = i < m ? __ldg(mine + i) : kNone;
  }
  edges += lane * (nbins + 1);
  for (int b = threadIdx.x; b <= nbins; b += T) e[b] = edges[b];
  for (int b = threadIdx.x; b < nbins * copies; b += T) c[b] = 0;
  __syncthreads();
  const float e0 = e[0], inv = __frcp_rn(__fsub_rn(e[1], e0));
  int32_t* own = c + (AGG == 2 ? (threadIdx.x >> 5) * nbins : 0);
  int bk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) bk[k] = bucket<GUESS>(x[k], e, e0, inv, nbins);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = bk[k];
    if (AGG == 1) {
      const unsigned peers = __match_any_sync(0xffffffffu, b);
      if (b >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
        atomicAdd(&own[b], __popc(peers));
      }
    } else if (AGG == 3) {
      if (b == nbins) own[0] = 1;       // keeps the search; never true
    } else if (b >= 0) {
      atomicAdd(&own[b], 1);
    }
  }
  out += lane * nbins;
  if (!CLUSTER) {
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += T) {
      int32_t s = 0;
      for (int q = 0; q < copies; ++q) s += c[q * nbins + b];
      out[b] = s;
    }
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  for (int b = rank * T + threadIdx.x; b < nbins; b += ctas * T) {
    int32_t s = 0;
    for (int q = 0; q < ctas; ++q) s += cl.map_shared_rank(c, q)[b];
    out[b] = s;
  }
  cl.sync();
}

__global__ void hist_prev(const float* __restrict__ u, int64_t n,
                          const float* __restrict__ edges, int nbins,
                          int32_t* __restrict__ out) {
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// The shipped lookup's layout (grid (ceil(N / 256), rows), one thread a
// PM) with the row's table staged in shared memory (STAGE) or no table
// read at all (GATHER false).
template <bool STAGE, bool GATHER>
__global__ void lookup_rows(
    const int32_t* __restrict__ state, const int32_t* __restrict__ r_w,
    const uint8_t* __restrict__ active, const float* __restrict__ tables,
    const int32_t* __restrict__ bins, int n, int nb, int m,
    float* __restrict__ out) {
  extern __shared__ float row_tab[];
  const int p = blockIdx.y;
  const int j = blockIdx.x * 256 + threadIdx.x;
  const bool in = j < n;
  const int f = p * n + j;
  if (STAGE) {
    for (int i = threadIdx.x; i < nb * m; i += 256) {
      cp_async4(row_tab + i, tables + static_cast<int64_t>(p) * nb * m + i);
    }
  }
  const int32_t bs = __ldg(bins + p);
  const int32_t s = in ? state[f] : -1;
  const int32_t r = in ? r_w[f] : 0;
  const bool act = in && active[f];
  if (STAGE) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  const float v = GATHER ? repro::utility_at(STAGE ? row_tab : tables,
                                             STAGE ? 0 : p, nb, m,
                                             act ? s : -1, r, bs)
                         : __int2float_rn(r + s + bs);
  if (in) out[f] = act ? v : 3.4e38f;
}

template <int PMS, bool STAGE>
__global__ void lookup_variant(
    const int32_t* __restrict__ state, const int32_t* __restrict__ r_w,
    const uint8_t* __restrict__ active, const float* __restrict__ tables,
    const int32_t* __restrict__ bins, int total, int n, int nb, int m,
    float* __restrict__ out) {
  extern __shared__ float ts[];
  const int start = blockIdx.x * blockDim.x * PMS;
  const int f0 = start + threadIdx.x * PMS;
  const int row0 = static_cast<unsigned>(start) / static_cast<unsigned>(n);
  const int bm = nb * m;
  if (STAGE) {
    const int last = min(start + static_cast<int>(blockDim.x) * PMS,
                         total) - 1;
    const int cnt = (static_cast<unsigned>(last) / static_cast<unsigned>(n)
                     - row0 + 1) * bm;
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      cp_async4(ts + i, tables + static_cast<int64_t>(row0) * bm + i);
    }
  }
  int32_t s[PMS], r[PMS], bs[PMS], row[PMS];
  bool act[PMS];
  if (PMS == 4 && f0 + 4 <= total) {
    const int4 sv = __ldg(reinterpret_cast<const int4*>(state + f0));
    const int4 rv = __ldg(reinterpret_cast<const int4*>(r_w + f0));
    const uchar4 av = *reinterpret_cast<const uchar4*>(active + f0);
    s[0] = sv.x; s[1] = sv.y; s[2] = sv.z; s[3] = sv.w;
    r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
    act[0] = av.x; act[1] = av.y; act[2] = av.z; act[3] = av.w;
  } else {
#pragma unroll
    for (int k = 0; k < PMS; ++k) {
      const bool in = f0 + k < total;
      s[k] = in ? state[f0 + k] : -1;
      r[k] = in ? r_w[f0 + k] : 0;
      act[k] = in && active[f0 + k];
    }
  }
#pragma unroll
  for (int k = 0; k < PMS; ++k) {
    row[k] = static_cast<unsigned>(f0 + k) / static_cast<unsigned>(n) - row0;
    bs[k] = f0 + k < total ? __ldg(bins + row0 + row[k]) : 1;
  }
  if (STAGE) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  const float* tab = STAGE ? ts : tables + static_cast<int64_t>(row0) * bm;
  float uu[PMS];
#pragma unroll
  for (int k = 0; k < PMS; ++k) {
    const float v = repro::utility_at(tab, row[k], nb, m,
                                      act[k] ? s[k] : -1, r[k], bs[k]);
    uu[k] = act[k] ? v : 3.4e38f;
  }
  if (PMS == 4 && f0 + 4 <= total) {
    *reinterpret_cast<float4*>(out + f0) =
        make_float4(uu[0], uu[1], uu[2], uu[3]);
  } else {
#pragma unroll
    for (int k = 0; k < PMS; ++k) {
      if (f0 + k < total) out[f0 + k] = uu[k];
    }
  }
}

__global__ void lookup_prev(const int32_t* __restrict__ state,
                            const int32_t* __restrict__ r_w,
                            const uint8_t* __restrict__ active,
                            const float* __restrict__ tables,
                            const int32_t* __restrict__ bins, int n,
                            int num_bins, int m, float* __restrict__ out) {
  const int p = blockIdx.y;
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= n) return;
  const int64_t at = static_cast<int64_t>(p) * n + j;
  if (!active[at]) {
    out[at] = 3.4e38f;
    return;
  }
  out[at] = repro::utility_at(tables, p, num_bins, m, state[at], r_w[at],
                              bins[p]);
}

}  // namespace

// variant: 0 prev (memset + kernel), 1 plain atomics, 2 match, 3 per-warp
// sub-histograms, 4 bisection, 5 a cluster of `ctas` CTAs, 6 no search,
// 7 no search and no atomics.
extern "C" int hist_variant_launch(int variant, const void* u, int lanes,
                                   int n, const void* e, int nbins,
                                   void* out, int threads, int ctas) {
  const auto* uu = static_cast<const float*>(u);
  const auto* ee = static_cast<const float*>(e);
  auto* oo = static_cast<int32_t*>(out);
  const size_t sh = sizeof(float) * (nbins + 1) +
                    4 * nbins * (variant == 3 ? threads / 32 : 1);
  const dim3 grid(ctas, lanes);
  switch (variant) {
    case 0: {
      cudaMemsetAsync(out, 0, 4 * nbins * static_cast<size_t>(lanes));
      const int want = (n + 255) / 256;
      hist_prev<<<dim3(want < 264 ? want : 264, lanes), 256, sh>>>(
          uu, n, ee, nbins, oo);
      break;
    }
    case 1: hist_variant<0, 1, false, 3><<<grid, threads, sh>>>(uu, n, ee, nbins, oo); break;
    case 2: hist_variant<1, 1, false, 1><<<grid, threads, sh>>>(uu, n, ee, nbins, oo); break;
    case 3: hist_variant<2, 1, false, 1><<<grid, threads, sh>>>(uu, n, ee, nbins, oo); break;
    case 4: hist_variant<0, 0, false, 1><<<grid, threads, sh>>>(uu, n, ee, nbins, oo); break;
    case 6: hist_variant<0, 2, false, 1><<<grid, threads, sh>>>(uu, n, ee, nbins, oo); break;
    case 7: hist_variant<3, 2, false, 1><<<grid, threads, sh>>>(uu, n, ee, nbins, oo); break;
    case 5: {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = grid;
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = sh;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = ctas;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      return static_cast<int>(cudaLaunchKernelEx(
          &cfg, hist_variant<0, 1, true, 1>, uu, n, ee, nbins, oo));
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// variant: 0 prev, 1 one PM a thread (the shipped layout) staged, 2 four
// PMs a thread over the flattened store, 3 the same staged, 4 the shipped
// layout without the table read.
extern "C" int lookup_variant_launch(int variant, const void* s,
                                     const void* r, const void* a,
                                     const void* t, const void* b, int P,
                                     int n, int nb, int m, void* out) {
  const int total = P * n;
  const auto* S = static_cast<const int32_t*>(s);
  const auto* R = static_cast<const int32_t*>(r);
  const auto* A = static_cast<const uint8_t*>(a);
  const auto* T = static_cast<const float*>(t);
  const auto* B = static_cast<const int32_t*>(b);
  auto* O = static_cast<float*>(out);
  const int grid = (total + 1023) / 1024;
  const size_t sh = (1023 / n + 2) * static_cast<size_t>(nb) * m * 4;
  const dim3 rows((n + 255) / 256, P);
  switch (variant) {
    case 0: lookup_prev<<<dim3((n + 255) / 256, P), 256>>>(S, R, A, T, B, n, nb, m, O); break;
    case 1: lookup_rows<true, true><<<rows, 256, static_cast<size_t>(nb) * m * 4>>>(S, R, A, T, B, n, nb, m, O); break;
    case 2: lookup_variant<4, false><<<grid, 256>>>(S, R, A, T, B, total, n, nb, m, O); break;
    case 3: lookup_variant<4, true><<<grid, 256, sh>>>(S, R, A, T, B, total, n, nb, m, O); break;
    case 4: lookup_rows<false, false><<<rows, 256>>>(S, R, A, T, B, n, nb, m, O); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
