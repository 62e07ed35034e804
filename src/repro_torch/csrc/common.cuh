// Device functions shared by the port's kernels: the per-event kernels
// (nfa_transition.cu, shed_select.cu) and the event-block megakernel
// (block_step.cu) compute the SEQ advance, the pSPICE utility, the bucket
// membership and the threefry draws with this one code, so the three
// per-event kernels' math reappears bit for bit inside the block kernel.
//
// Rounding: every float op is a _rn intrinsic and the build passes
// -fmad=false, so nothing is contracted behind the code's back; a fused
// multiply-add appears only where it is written as __fmaf_rn.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// Next SEQ state of a PM in state s of pattern p under event class cls:
// trans[p, s, cls] when `go` (live, binding matched, event not dropped)
// and the indices are in range, else s.  States and classes are always in
// range on the engine's path; the guard only keeps a corrupt store from
// reading out of bounds.
__device__ __forceinline__ int32_t nfa_next(const int32_t* __restrict__ trans,
                                            int p, int32_t s, int32_t cls,
                                            int m, int c1, bool go) {
  if (go && s >= 0 && s < m && cls >= 0 && cls < c1) {
    return trans[(static_cast<int64_t>(p) * m + s) * c1 + cls];
  }
  return s;
}

// pSPICE utility of a PM in state s with r_w events left in its window,
// against pattern p's (num_bins, m) table and bin size bs:
//   pos = clip(r_w / bs - 1, 0, B - 1); j0 = floor(pos); j1 = min(j0+1, B-1)
//   u   = fma(u0, 1 - frac, u1 * frac)
// (the reference Pallas kernel's rounding).  An out-of-range state reads
// zeros, as the one-hot form does.
__device__ __forceinline__ float utility_at(const float* __restrict__ tables,
                                            int p, int num_bins, int m,
                                            int32_t s, int32_t r_w,
                                            int32_t bin_size) {
  const float bs = __int2float_rn(bin_size);
  float pos = __fsub_rn(__fdiv_rn(__int2float_rn(r_w), bs), 1.0f);
  pos = fminf(fmaxf(pos, 0.0f), __int2float_rn(num_bins - 1));
  const int j0 = __float2int_rd(pos);
  const int j1 = min(j0 + 1, num_bins - 1);
  const float frac = __fsub_rn(pos, __int2float_rn(j0));
  float u0 = 0.0f, u1 = 0.0f;
  if (s >= 0 && s < m) {
    const float* tab = tables + static_cast<int64_t>(p) * num_bins * m;
    u0 = tab[j0 * m + s];
    u1 = tab[j1 * m + s];
  }
  return __fmaf_rn(u0, __fsub_rn(1.0f, frac), __fmul_rn(u1, frac));
}

// The bucket b with edges[b] <= v < edges[b + 1], or -1 (below the range,
// or NaN, which fails every comparison).  A binary search finds the one
// candidate and the two edge comparisons confirm it, so membership is the
// reference's comparison bit for bit.  edges holds nbins + 1 monotone
// values, the top one +inf.
__device__ __forceinline__ int bucket_of(float v, const float* edges,
                                         int nbins) {
  if (!(v >= edges[0])) return -1;
  int lo = 0, hi = nbins;  // largest b with edges[b] <= v
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (edges[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return (lo < nbins && v >= edges[lo] && v < edges[lo + 1]) ? lo : -1;
}

// ---------------------------------------------------------------------------
// Threefry-2x32 (20 rounds), jax.random's default generator in its
// partitionable layout: integer arithmetic only, so exact.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int blk = 0; blk < 5; ++blk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[blk % 2][r]) ^ x0;
    }
    x0 += ks[(blk + 1) % 3];
    x1 += ks[(blk + 2) % 3] + static_cast<uint32_t>(blk + 1);
  }
}

// key, sub = jax.random.split(key): the hashes of counters 0 and 1.
__device__ __forceinline__ void threefry_split(const uint32_t key[2],
                                               uint32_t next[2],
                                               uint32_t sub[2]) {
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
  threefry2x32(key[0], key[1], a0, a1);
  threefry2x32(key[0], key[1], b0, b1);
  next[0] = a0; next[1] = a1;
  sub[0] = b0; sub[1] = b1;
}

// Element i of jax.random.uniform(key, (n,)) for i < 2**32: the mantissa
// bits of the counter's hash under 1.0f's exponent, minus 1.
__device__ __forceinline__ float threefry_uniform(const uint32_t key[2],
                                                  uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(key[0], key[1], x0, x1);
  const uint32_t bits = x0 ^ x1;
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
  return fmaxf(__fsub_rn(f, 1.0f), 0.0f);
}

// Two's-complement difference a - b of int32 event indices (the window
// tests rely on the wrap; signed overflow is undefined in C++).
__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// Floored modulo (jnp's %, Python's %) for a positive divisor.
__device__ __forceinline__ int floor_mod(int32_t x, int d) {
  return ((x % d) + d) % d;
}

}  // namespace repro
