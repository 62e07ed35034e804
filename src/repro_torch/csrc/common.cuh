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
// Threefry-2x32 (20 rounds), jax.random's default generator, in both of
// its layouts (repro_torch/prng.py::_hash_flat): integer arithmetic only,
// so exact.  `partitionable` picks the layout (jax_threefry_partitionable;
// repro_torch.prng.PARTITIONABLE on the host).
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

// key, sub = jax.random.split(key).  Partitionable: the hashes of the
// counter pairs (0, 0) and (0, 1), one key each.  Original: the four
// words of counters 0..3 hash as the pairs (0, 2) -> (a0, a1) and
// (1, 3) -> (b0, b1), and concatenate to a0 b0 a1 b1, so that
// key = (a0, b0) and sub = (a1, b1).
__device__ __forceinline__ void threefry_split(const uint32_t key[2],
                                               uint32_t next[2],
                                               uint32_t sub[2],
                                               bool partitionable) {
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
  if (!partitionable) {
    a1 = 2u;
    b0 = 1u;
    b1 = 3u;
  }
  threefry2x32(key[0], key[1], a0, a1);
  threefry2x32(key[0], key[1], b0, b1);
  if (partitionable) {
    next[0] = a0; next[1] = a1;
    sub[0] = b0; sub[1] = b1;
  } else {
    next[0] = a0; next[1] = b0;
    sub[0] = a1; sub[1] = b1;
  }
}

// Element f of jax.random.uniform(key, (n,)) for n < 2**32: 23 mantissa
// bits of the element's word under 1.0f's exponent, minus 1.
// Partitionable: the word is x0 ^ x1 of the hash of (0, f).  Original:
// counters 0..n-1 (odd n padded with one 0) split into halves of
// h = ceil(n / 2) that hash pairwise, the x0 words first: f < h takes x0
// of the hash of (f, f + h), or of (f, 0) when f + h is the pad; f >= h
// takes x1 of the hash of (f - h, f).  No XOR there.
__device__ __forceinline__ float threefry_uniform(const uint32_t key[2],
                                                  uint32_t f, uint32_t n,
                                                  bool partitionable) {
  uint32_t bits;
  if (partitionable) {
    uint32_t x0 = 0u, x1 = f;
    threefry2x32(key[0], key[1], x0, x1);
    bits = x0 ^ x1;
  } else {
    const uint32_t h = n / 2u + (n & 1u);
    const bool upper = f >= h;
    uint32_t x0 = upper ? f - h : f;
    uint32_t x1 = upper ? f : (f + h < n ? f + h : 0u);
    threefry2x32(key[0], key[1], x0, x1);
    bits = upper ? x1 : x0;
  }
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u);
  return fmaxf(__fsub_rn(u, 1.0f), 0.0f);
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
