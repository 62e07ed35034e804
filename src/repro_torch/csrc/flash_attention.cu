// Online-softmax (flash) attention in float32 (SIMT): the port of
// src/repro/kernels/flash_attention.py::_flash_kernel, which computes
// repro.models.layers.flash_attention (q_offset an integer), for float32
// inputs.  It is the exactness path, held to its plain version at 2e-5;
// bfloat16 inputs go to the tensor-core kernel of flash_attention_sm90.cu.
//
//   q (B, Sq, H, D), k (B, Sk, KVH, D), v (B, Sk, KVH, Dv), row-major and
//   contiguous, float32; out (B, Sq, H, Dv).
//   GQA: query head h reads KV head h / (H / KVH).
//   Causal: key j is visible to query row i when j <= q_offset + i.
//
// What bounds it.  At the prefill shape the work is ~300 operations per byte
// moved (attention reads Q, K and V once per q tile from L2/HBM and does
// 2·(D + Dv) operations per visible (query, key) pair), so the card's
// arithmetic rate bounds it, not its memory.  It does the products with
// scalar float32 FMAs: TF32 tensor cores would break its 2e-5 bar, so it
// runs on the 67 TFLOP/s float32 pipe.  What the design keeps out of device
// memory is what the TPU kernel kept out of HBM: the scores, the running
// max m, the denominator l and the output accumulator never leave the SM.
//
// Design.  One CTA of 256 threads per (batch·head, q tile of 64 rows); the
// CTA loops over key tiles of 64 in place of the TPU's sequential grid axis,
// and stops at the causal diagonal (the tiles above it are never visited).
// Shared memory (dynamic): the q tile, one buffer that holds the K tile
// and then the V tile, and the (64 x 64) probability tile, all float32;
// 84 992 B at D = Dv = 128 (two CTAs fit an SM), 117 760 B at MLA's
// (D, Dv) = (192, 128) (one CTA an SM).  D goes up to 192, Dv up to 128:
// a thread's output columns 4 tx + 64 e (e < 2) cover 128, while the
// score loop walks D in steps of 4 at any width.  Thread (ty, tx) of the 16 x 16
// CTA owns rows ty + 16 i (i < 4) of the tile: for the scores the key
// columns tx + 16 j (j < 4), for the output the dims 4 tx + 64 e .. +3
// (e < 2), so m, l and the rescale of the accumulator stay in that
// thread's registers; the row max and sum reduce over the 16 lanes of a
// half warp with shuffles.  Row strides of D + 4
// floats keep the float4 reads of the K tile free of bank conflicts.
// Masking is in the kernel: keys at or past Sk, keys above the diagonal and
// query rows at or past Sq (never written).  A row whose every key in a tile
// is masked keeps m = -inf and adds nothing (exp is taken against 0 then),
// as layers.flash_attention guards it.  The products are written as fmaf:
// the build passes -fmad=false for the bit-exact CEP kernels, and the
// explicit FMAs keep this kernel from paying for that.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // query rows per CTA and keys per KV tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxD = 192;      // q/k head dim (MLA's 128 + 64)
constexpr int kMaxDv = 128;     // v head dim: 2 x 64 output columns
constexpr int kPStride = kTile + 4;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows [row0, row0 + 64) of one head of x (rows strided by `row_stride`
// elements, `width` elements each) into smem rows of `ld` floats; rows at
// or past `rows` are zero.
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int row0,
                                          int rows, int width) {
  const int nvec = width / 4;
  for (int idx = threadIdx.x; idx < kTile * nvec; idx += kThreads) {
    const int r = idx / nvec;
    const int c = (idx - r * nvec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      val = load4(src + static_cast<int64_t>(row0 + r) * row_stride + c);
    }
    store4(dst + r * ld + c, val);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int Sq, int Sk, int H, int KVH, int D, int Dv,
                       int causal, int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = D + 4;
  const int ldkv = max(D, Dv) + 4;
  float* qs = smem;                       // (64, ldq)
  float* kvs = qs + kTile * ldq;          // (64, ldkv): K, then V
  float* ps = kvs + kTile * ldkv;         // (64, kPStride)

  // Heavy (late) causal tiles first: the CTAs of one head that see the most
  // keys start before the light ones.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(KVH) * D;
  const int64_t v_rs = static_cast<int64_t>(KVH) * Dv;
  const float* qh = q + static_cast<int64_t>(b) * Sq * q_rs +
                    static_cast<int64_t>(h) * D;
  const float* kh = k + static_cast<int64_t>(b) * Sk * k_rs +
                    static_cast<int64_t>(kvh) * D;
  const float* vh = v + static_cast<int64_t>(b) * Sk * v_rs +
                    static_cast<int64_t>(kvh) * Dv;

  load_tile(qs, ldq, qh, q_rs, q0, Sq, D);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }

  // Keys past the last visible one of the tile's last real row are never
  // visited: the causal tiles above the diagonal are skipped.
  int k_end = Sk;
  if (causal) {
    const int last_row = min(q0 + kTile, Sq) - 1;
    k_end = min(Sk, q_offset + last_row + 1);
  }

  for (int n0 = 0; n0 < k_end; n0 += kTile) {
    __syncthreads();   // the previous tile's P and V are consumed
    load_tile(kvs, ldkv, kh, k_rs, n0, Sk, D);
    __syncthreads();

    // Scores of rows ty + 16 i against keys tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(qs + (ty + 16 * i) * ldq + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(kvs + (tx + 16 * j) * ldkv + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = n0 + tx + 16 * j;
        const bool ok = key < Sk && (!causal || key <= qpos);
        s[i][j] = ok ? __fmul_rn(s[i][j], scale) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // A row with no visible key so far keeps m = -inf: take exp against 0
      // so every p is exp(-inf) = 0, never exp(-inf - -inf) = NaN.
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_safe));
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        rs = __fadd_rn(rs, p);
      }
      rs = half_warp_sum(rs);
      corr[i] = m[i] == -INFINITY ? 0.f : expf(__fsub_rn(m[i], m_safe));
      l[i] = fmaf(l[i], corr[i], rs);
      m[i] = m_new;
    }
    __syncthreads();   // every thread is done with K; P is complete
    load_tile(kvs, ldkv, vh, v_rs, n0, Sk, Dv);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = __fmul_rn(acc[i][e], corr[i]);
    const int n_keys = min(kTile, Sk - n0);
    for (int c = 0; c < n_keys; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d0 = 4 * tx + 64 * e;
        if (d0 < Dv) {
          const float4 vv = load4(kvs + c * ldkv + d0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * e + 0] = fmaf(p[i], vv.x, acc[i][4 * e + 0]);
            acc[i][4 * e + 1] = fmaf(p[i], vv.y, acc[i][4 * e + 1]);
            acc[i][4 * e + 2] = fmaf(p[i], vv.z, acc[i][4 * e + 2]);
            acc[i][4 * e + 3] = fmaf(p[i], vv.w, acc[i][4 * e + 3]);
          }
        }
      }
    }
  }

  const int64_t o_rs = static_cast<int64_t>(H) * Dv;
  float* oh = out + static_cast<int64_t>(b) * Sq * o_rs +
              static_cast<int64_t>(h) * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d0 = 4 * tx + 64 * e;
      if (d0 < Dv) {
        store4(oh + static_cast<int64_t>(r) * o_rs + d0,
               make_float4(__fdiv_rn(acc[i][4 * e + 0], den),
                           __fdiv_rn(acc[i][4 * e + 1], den),
                           __fdiv_rn(acc[i][4 * e + 2], den),
                           __fdiv_rn(acc[i][4 * e + 3], den)));
      }
    }
  }
}

size_t smem_bytes(int D, int Dv) {
  const int ld = (D > Dv ? D : Dv) + 4;
  return sizeof(float) *
         (static_cast<size_t>(kTile) * (D + 4) +
          static_cast<size_t>(kTile) * ld + kTile * kPStride);
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KVH, int D, int Dv, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  // Above 48 KB a CTA gets dynamic shared memory only after this opt-in
  // (per device, so it is set on every launch; it costs no device time).
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(D, Dv)));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kTile - 1) / kTile, B * H);
  flash_attention_kernel<<<grid, kThreads, smem_bytes(D, Dv), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KVH,
      D, Dv, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper
// (repro_torch/kernels/flash_attention.py) has checked the shapes: D and Dv
// multiples of 8, D at most 192 and Dv at most 128, H a multiple of KVH,
// B*H at most 65535, 16-byte aligned contiguous float32 tensors on one
// device.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int KVH, int D, int Dv,
                                      int causal, int q_offset, float scale,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (D <= 0 || D > kMaxD || Dv <= 0 || Dv > kMaxDv || KVH <= 0 ||
      H % KVH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(q, k, v, out, B, Sq, Sk, H, KVH, D, Dv, causal, q_offset,
                scale, static_cast<cudaStream_t>(stream));
}
