// Online-softmax (flash) attention in bf16 on Hopper's tensor cores: the
// port of src/repro/kernels/flash_attention.py::_flash_kernel, which
// computes repro.models.layers.flash_attention, for bfloat16 inputs (the
// float32 inputs go to the SIMT kernel of flash_attention.cu, the
// exactness path).
//
//   q (B, Sq, H, D), k (B, Sk, KVH, D), v (B, Sk, KVH, Dv), bf16, row-major
//   and contiguous; out (B, Sq, H, Dv) bf16.  GQA: query head h reads KV
//   head h / (H / KVH).  Causal: key j is visible to query row i when
//   j <= q_offset + i.
//
// What bounds it.  At the prefill shape (B=4, S=2048, H=16, KVH=8,
// D=Dv=128, causal) the work is 6.9e10 operations on 101 MB, ~680
// operations per byte, so the tensor cores' bf16 rate bounds it, not the
// memory.  Both products therefore run on wgmma, and the design keeps the
// tensor cores fed: the scores, m, l and the output accumulator never leave
// the registers, and K/V tiles arrive by TMA while the previous tile is
// being multiplied.
//
// Design.  One CTA of three warpgroups per (q tile of 128 rows,
// batch·head), on a 1-D grid that starts the heavy (late) causal q tiles
// first.  Warpgroup 2 is the producer: after giving its registers away
// (setmaxnreg), one thread loads the Q tile once and then K and V tiles of
// 128 keys into a 2-stage ring in shared memory, by TMA with the 128-byte
// swizzle, each stage with a full and an empty mbarrier.  Warpgroups 0 and
// 1 are consumers of 64 query rows each, with 240 registers:
//   S = Q·Kᵀ     wgmma m64n128k16, both operands K-major in shared memory;
//   softmax      in the float32 S fragment, in the log2 domain (one fmaf
//                per score into exp2f); row max and sum over the 4 lanes
//                of a quad; masks only on the tiles that need them (the
//                causal diagonal, the tail at Sk);
//   O += P·V     wgmma m64n{DV}k16 with P in registers: the S fragment,
//                rounded to bf16 pairs, is already the A fragment of the
//                second product, and V is read key-major as a transposed B.
// The epilogue scales O by 1 / max(l, 1e-30), rounds to bf16 and stores
// rows below Sq and columns below Dv from the registers.  D and Dv
// (multiples of 8) pad with zeros to one of three instances (DK, DV):
// (64, 64), (128, 128), and (192, 128) for MLA's prefill (q/k head dim
// 128 + 64 of decoupled RoPE, v head dim 128; deepseek-v3).  TMA fills the
// columns past D and Dv, and the rows past Sq and Sk, with zeros, which
// change no product.  The instances differ only in DK / 64 boxes per Q
// tile and K stage and DK / 16 k steps of S = Q·Kᵀ (12 at DK = 192, over
// three swizzled boxes); S and O stay 64 x 128 fragments, so the
// registers do not grow with DK.  Shared memory at (192, 128): Q 48 KB,
// the K ring 2 x 48 KB, the V ring 2 x 32 KB, 214 088 B with the barriers
// and the alignment slack, of the 232 448 B a CTA may take.  The tensor maps are encoded on the host for every call through
// the driver's entry point (cudaGetDriverEntryPoint), so the library links
// without -lcuda.  The build passes -fmad=false for the bit-exact CEP
// kernels; the softmax writes its one FMA per score as fmaf.
//
// The probe (wgmma_probe_launch) runs the parts of this kernel whose
// faults give plausible numbers instead of a crash, on two small products
// that chip_smoke.py and the gpu tests hold against torch.matmul:
//   C = A · Bᵀ      A (64, 128), B (64, 128) bf16, both K-major (a K tile's
//                   layout), by TMA with the 128-byte swizzle, eight
//                   wgmma m64n64k16 over the 128-wide depth, shared-memory
//                   descriptors for both operands;
//   E = bf16(C) · V V (64, 128) bf16 key-major (a V tile's layout, read as
//                   a transposed B), four wgmma m64n128k16 with A taken
//                   from registers: C's accumulator fragment repacked as
//                   bf16 pairs, as the flash kernel feeds P.
// Both outputs are float32, row-major.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// PTX helpers: mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Barriers and tiles are named by their 32-bit shared-memory addresses,
// which cost one register where a generic pointer costs two.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that has
// not completed after ~4e9 cycles (seconds; a real wait takes micro-
// seconds) traps, so a pipeline fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}

// A 2-D or 4-D tile of `map` at coordinates c0 (innermost) .. into
// shared memory at dst; completion is reported to `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The value of x, hidden from the compiler's loop-invariant code motion:
// an operand recomputed from it inside a loop is not hoisted out and kept
// in registers for the whole loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// wgmma shared-memory descriptor of a tile stored with the 128-byte
// swizzle (rows of 128 bytes, 8-row atoms 1024-byte aligned).  Offsets are
// in bytes here and stored in 16-byte units:
//   K-major operand (Q, K; A and B of the probe): lbo unused (1), sbo =
//     1024, the stride between 8-row groups; a 16-deep k step moves the
//     start 32 bytes inside a 64-wide atom.
//   MN-major operand (V, read transposed): lbo = the stride between the
//     64-column boxes, sbo = 1024, the stride between 8-key groups; a
//     16-key step moves the start 2048 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;   // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tells the compiler that the accumulator registers change here, so that
// no read of them moves above a wait or into an asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator fragment of m64nNk16 (f32): thread `lane` of warp w of the
// warpgroup holds d[i] at row 16 w + lane / 4 + 8 ((i % 4) / 2) and column
// 8 (i / 4) + 2 (lane % 4) + i % 2.

#define ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) (+)= A (smem, K-major) · B (smem, K-major)ᵀ, one k16 step.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) (+)= A (smem, K-major) · B (smem, K-major)ᵀ: S = Q · Kᵀ.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (registers, bf16 pairs) · B (smem, MN-major, read
// transposed): O += P · V at Dv <= 64.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 128) += A (registers) · B (smem, MN-major, transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k step kk (16 columns) from an accumulator fragment
// of the same 64 rows: columns 16 kk .. 16 kk + 15 are d[8 kk .. 8 kk + 7].
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N], int kk,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps through the driver's entry point (no -lcuda)
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Returns 0, a positive cudaError_t (entry point not found), or the
// negated CUresult of a failed encode.
int encode_bf16(CUtensorMap* map, int rank, const void* base,
                const uint64_t* dims, const uint64_t* strides_bytes,
                const uint32_t* box) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (q != cudaDriverEntryPointSuccess || fn == nullptr) {
      return static_cast<int>(cudaErrorSymbolNotFound);
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = strides_bytes[i];
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      gdim, gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// ---------------------------------------------------------------------------
// The probe
// ---------------------------------------------------------------------------

constexpr int kProbeBox = 64 * 64 * 2;        // one (64 rows x 64) bf16 box
constexpr int kProbeSmem = 6 * kProbeBox + 1024 + 64;

__global__ void __launch_bounds__(128, 1)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_v,
                   float* __restrict__ c_out, float* __restrict__ e_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sa = smem_u32(base);       // A: columns 0-63, 64-127
  const uint32_t sb = sa + 2 * kProbeBox;   // B: the same
  const uint32_t sv = sa + 4 * kProbeBox;   // V: the same
  const uint32_t bar = sa + 6 * kProbeBox;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 6 * kProbeBox);
    for (int c = 0; c < 2; ++c) {
      tma_load_2d(sa + c * kProbeBox, &map_a, bar, 64 * c, 0);
      tma_load_2d(sb + c * kProbeBox, &map_b, bar, 64 * c, 0);
      tma_load_2d(sv + c * kProbeBox, &map_v, bar, 64 * c, 0);
    }
  }
  mbar_wait(bar, 0);

  float c[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = 0.f;
  fence_regs(c);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk / 4) * kProbeBox + (kk % 4) * 32;
    wgmma_ss_n64(c, make_desc(sa + off, 16, 1024),
                 make_desc(sb + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(c);

  float e[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) e[i] = 0.f;
  fence_regs(e);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(c, kk, a);
    wgmma_rs_n128(e, a, make_desc(sv + kk * 2048, kProbeBox, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(e);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * ((i % 4) / 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    if (i < 32) c_out[row * 64 + col] = c[i];
    e_out[row * 128 + col] = e[i];
  }
}

// ---------------------------------------------------------------------------
// The bf16 flash kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 128;                 // query rows per CTA (2 x 64)
constexpr int kBN = 128;                 // keys per K/V tile
constexpr int kStages = 2;               // depth of the K/V ring
constexpr int kBox = kBN * 64 * 2;       // one (128 rows x 64) bf16 box
// Two consumer warpgroups and a producer warpgroup: 384 threads start
// with 168 registers each; the producer drops to 24 and the consumers,
// which hold the S and O fragments, rise to 240 (setmaxnreg), which uses
// the CTA's 64 512 registers exactly.  A lone producer warp (288 threads)
// does not do: ptxas still starts every thread at 168, the warp's release
// does not cover the consumers' rise, and they wait for it forever.
constexpr int kThreads = 3 * 128;
constexpr int kConsumerWarps = 8;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// atoms): the Q tile, the K ring, the V ring (each tile DK / 64 or DV / 64
// boxes of 64 columns), then the barriers.
template <int DK, int DV>
struct Layout {
  static constexpr int q = 0;
  static constexpr int k = q + (DK / 64) * kBox;
  static constexpr int v = k + kStages * (DK / 64) * kBox;
  static constexpr int bars = v + kStages * (DV / 64) * kBox;
  static constexpr int bytes = bars + 9 * 8 + 1024;   // + alignment slack
};

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            __nv_bfloat16* __restrict__ out, int BH, int Sq,
                            int Sk, int H, int KVH, int Dv, int causal,
                            int q_offset, float scale_log2) {
  using L = Layout<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(base);
  // Barriers: Q full, then per ring stage s K full, K empty, V full, V
  // empty.
  const uint32_t q_full = sbase + L::bars;
  auto k_full = [&](int s) { return sbase + L::bars + 8 + 8 * s; };
  auto k_empty = [&](int s) { return sbase + L::bars + 24 + 8 * s; };
  auto v_full = [&](int s) { return sbase + L::bars + 40 + 8 * s; };
  auto v_empty = [&](int s) { return sbase + L::bars + 56 + 8 * s; };

  // Heavy (late) causal tiles first: every head's last q tile, then the
  // one before, and so on.
  const int n_qt = (Sq + kBM - 1) / kBM;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * kBM;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  // Keys past the last visible one of the tile's last real row are never
  // loaded: the causal tiles above the diagonal are skipped.
  const int k_end =
      causal ? min(Sk, q_offset + min(q0 + kBM, Sq)) : Sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The role, as a value the compiler can see is warp-uniform (setmaxnreg
  // needs every warp of a warpgroup on the same side of the branch).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // Producer warpgroup: one thread keeps the ring full; the warpgroup
    // gives its registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, (DK / 64) * kBox);
      for (int c = 0; c < DK / 64; ++c) {
        tma_load_4d(sbase + L::q + c * kBox, &map_q, q_full, 64 * c, h, q0,
                    b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int n0 = it * kBN;
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), (DK / 64) * kBox);
        for (int c = 0; c < DK / 64; ++c) {
          tma_load_4d(sbase + L::k + (s * (DK / 64) + c) * kBox, &map_k,
                      k_full(s), 64 * c, kvh, n0, b);
        }
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), (DV / 64) * kBox);
        for (int c = 0; c < DV / 64; ++c) {
          tma_load_4d(sbase + L::v + (s * (DV / 64) + c) * kBox, &map_v,
                      v_full(s), 64 * c, kvh, n0, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg .. + 63.  This thread
    // holds rows row0 and row0 + 8 of the S and O fragments.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int warp_row = q0 + 64 * wg + 16 * warp;
    const int row0 = warp_row + lane / 4;
    const int col0 = 2 * (lane % 4);
    // Descriptors are built per tile from each operand's first k step; a
    // k step adds its offset in 16-byte units to the start-address field.
    // This warpgroup's Q rows start 64 rows of 128 bytes into each of the
    // tile's DK / 64 boxes; the k step's box offset is added per step.
    const uint32_t q_smem = sbase + L::q + wg * 64 * 128;

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};           // this thread's share of the row sum

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int n0 = it * kBN;

      // S = Q · Kᵀ (64 x 128, float32).
      float sc[64];
      const uint64_t dq = make_desc(opaque(q_smem), 16, 1024);
      const uint64_t dk = make_desc(
          opaque(sbase + L::k + s * (DK / 64) * kBox), 16, 1024);
      mbar_wait(k_full(s), ph);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const uint32_t off = ((kk / 4) * kBox + (kk % 4) * 32) >> 4;
        wgmma_ss_n128(sc, dq + off, dk + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty(s));

      // Masks only where the tile needs them: keys at or past Sk, keys
      // above the diagonal of some row of this warp.
      if (n0 + kBN > Sk || (causal && n0 + kBN - 1 > q_offset + warp_row)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = n0 + 8 * (i / 4) + col0 + i % 2;
          const int qpos = q_offset + row0 + 8 * ((i % 4) / 2);
          if (key >= Sk || (causal && key > qpos)) sc[i] = -INFINITY;
        }
      }

      // Online softmax in the log2 domain: p = 2^(s·scale·log2 e − m·scale·
      // log2 e), one fmaf per score.  A row with no visible key so far
      // keeps m = -inf and takes exp against 0, so p = 0 and never NaN.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
      }
      float neg_ms[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        neg_ms[r] = mx[r] == -INFINITY ? 0.f : -__fmul_rn(mx[r], scale_log2);
        corr[r] = exp2f(fmaf(m[r], scale_log2, neg_ms[r]));
        m[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i % 4) / 2;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, neg_ms[r]));
        rs[r] = __fadd_rn(rs[r], sc[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], rs[r]);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) {
        o[i] = __fmul_rn(o[i], corr[(i % 4) / 2]);
      }

      // O += P · V: P rounded to bf16 (as the plain version rounds it to
      // v's type) straight from the S fragment into wgmma's A registers.
      const uint64_t dv0 = make_desc(
          opaque(sbase + L::v + s * (DV / 64) * kBox), kBox, 1024);
      // Each k step's A fragment is packed just before its wgmma (behind
      // a fence, as registers written since the last wgmma require): with
      // all 32 packed up front, and the waits' trap path in the same
      // function, ptxas ran out of registers, spilled the fragment and
      // serialised every wgmma.
      mbar_wait(v_full(s), ph);
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t pa[4];
        acc_to_a(sc, kk, pa);
        wgmma_fence();
        const uint64_t dv = dv0 + kk * (2048 >> 4);
        if constexpr (DV == 128) {
          wgmma_rs_n128(o, pa, dv, 1);
        } else {
          wgmma_rs_n64(o, pa, dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty(s));
    }

    // Epilogue: O / max(l, 1e-30) in bf16 (by the fast reciprocal, within
    // an ulp of the division and far inside bf16's rounding), rows below
    // Sq and columns below Dv only, straight from the registers.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
      inv[r] = __fdividef(1.f, fmaxf(l[r], 1e-30f));
    }
#pragma unroll
    for (int i = 0; i < DV / 2; i += 2) {
      const int r = (i % 4) / 2;
      const int row = row0 + 8 * r;
      const int col = 8 * (i / 4) + col0;
      if (row < Sq && col < Dv) {
        const uint32_t pair = pack_bf16(__fmul_rn(o[i], inv[r]),
                                        __fmul_rn(o[i + 1], inv[r]));
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<int64_t>(b) * Sq + row) * H + h) * Dv + col) =
            pair;
      }
    }
  }
}

// One (DK, DV) instance: three tensor maps, the shared-memory opt-in and
// the launch.  Returns 0, a cudaError_t, or a negated CUresult.
template <int DK, int DV>
int launch_sm90(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Sk, int H, int KVH, int D, int Dv, int causal,
                int q_offset, float scale, cudaStream_t stream) {
  // (head dim, heads, sequence, batch), innermost first; a box is 64
  // columns of one head over 128 rows, so a tile never crosses a head or
  // a batch, and columns past D / Dv and rows past Sq / Sk are zero-filled.
  CUtensorMap maps[3];
  const uint32_t box[4] = {64, 1, kBN, 1};
  const struct {
    const void* ptr;
    int width, heads, rows;
  } ts[3] = {{q, D, H, Sq}, {k, D, KVH, Sk}, {v, Dv, KVH, Sk}};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[4] = {static_cast<uint64_t>(ts[i].width),
                              static_cast<uint64_t>(ts[i].heads),
                              static_cast<uint64_t>(ts[i].rows),
                              static_cast<uint64_t>(B)};
    const uint64_t row = 2ull * ts[i].width;
    const uint64_t strides[3] = {row, row * ts[i].heads,
                                 row * ts[i].heads * ts[i].rows};
    const int err = encode_bf16(&maps[i], 4, ts[i].ptr, dims, strides, box);
    if (err) return err;
  }
  // Above 48 KB a CTA gets dynamic shared memory only after this opt-in.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<DK, DV>::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid =
      static_cast<long long>((Sq + kBM - 1) / kBM) * B * H;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_sm90_kernel<DK, DV>
      <<<static_cast<unsigned>(grid), kThreads, Layout<DK, DV>::bytes,
         stream>>>(maps[0], maps[1], maps[2],
                   static_cast<__nv_bfloat16*>(out), B * H, Sq, Sk, H, KVH,
                   Dv, causal, q_offset, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The probe: a, b, v are contiguous (64, 128) bf16 on the card; c (64, 64)
// and e (64, 128) float32.  Returns 0, a cudaError_t, or the negated
// CUresult of a failed tensor-map encode.
extern "C" int wgmma_probe_launch(const void* a, const void* b, const void* v,
                                  void* c, void* e, void* stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {a, b, v};
  const uint64_t dims[2] = {128, 64};
  const uint64_t strides[1] = {128 * 2};
  const uint32_t box[2] = {64, 64};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_bf16(&maps[i], 2, ptrs[i], dims, strides, box);
    if (err) return err;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kProbeSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_probe_kernel<<<1, 128, kProbeSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(c), static_cast<float*>(e));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 flash attention (see the top of the file).  q (B, Sq, H, D),
// k (B, Sk, KVH, D), v (B, Sk, KVH, Dv), out (B, Sq, H, Dv), bf16,
// contiguous, 16-byte aligned (the wrapper,
// repro_torch/kernels/flash_attention.py, has checked them).  D and Dv
// are multiples of 8, D up to 192 and Dv up to 128, padded with zeros to
// an instance (DK, DV) of (64, 64), (128, 128) or (192, 128); scale > 0.
// Returns 0, a cudaError_t, or the negated CUresult of a failed
// tensor-map encode.  The instance is chosen here and mirrored by the
// wrapper's sm90_instance, which counts launches per instance.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int Sq, int Sk, int H, int KVH,
                                           int D, int Dv, int causal,
                                           int q_offset, float scale,
                                           void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (D <= 0 || D > 192 || D % 8 || Dv <= 0 || Dv > 128 || Dv % 8 ||
      KVH <= 0 || H % KVH || Sk <= 0 || q_offset < 0 || !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64 && Dv <= 64) {
    return launch_sm90<64, 64>(q, k, v, out, B, Sq, Sk, H, KVH, D, Dv, causal,
                               q_offset, scale, s);
  }
  if (D <= 128) {
    return launch_sm90<128, 128>(q, k, v, out, B, Sq, Sk, H, KVH, D, Dv,
                                 causal, q_offset, scale, s);
  }
  return launch_sm90<192, 128>(q, k, v, out, B, Sq, Sk, H, KVH, D, Dv, causal,
                               q_offset, scale, s);
}
