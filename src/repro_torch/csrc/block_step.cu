// The event-block megakernel: W events of the whole CEP operator in one
// launch, with the PM store, the window ring, the overload scalars, the
// latency ring and the PRNG key kept on the chip for the whole block.
//
// Replaces: src/repro/kernels/block_step.py::_block_kernel (one Pallas
// call with every operand a VMEM-resident block and an in-kernel
// fori_loop over the W events).
//
// Per event, in the order of the reference step: expire → Algorithm 1
// (lazy f-inverse) → Algorithm 2 when it fires (fused: the pSPICE lookup
// or the PM-BL uniforms, then the histogram-threshold select) → E-BL →
// SEQ / ANY advance → completions and match tiles → stats → spawn by
// rank → simulated time and latency ring → the StepOut row.  In the
// replay protocol the kernel stops before the first fire and reports it;
// the host replays that event and re-enters after it.
//
// What bounds it: neither bytes nor operations.  One CTA walks W events
// in order, and each event depends on the last through the store and the
// simulated clock, so the time per event is a chain of latencies:
// barriers, warp 0's scalar arithmetic, and every load, shuffle and
// atomic on that chain (about 3 900 cycles per event at the stock shape,
// read with clock64 marks per phase in a timing build: ~1 400 in the
// advance pass, ~1 800 in warp 0's control and tail).  Its byte bound (the store read and
// written once per launch, ~64 ns at the stock shape) is hundreds of
// times below that chain and is not the target.
//
// Design, against that chain:
// - On chip for the whole launch.  At entry the store (active, state,
//   open_idx, bind and, unless every pattern is SEQ, the idset), the
//   fire's scratch (scores, selection flags), the W event rows, the
//   model's per-pattern columns, `trans` and the utility tables, the ring,
//   ring_ptr and the per-pattern counters are staged in shared memory:
//   each piece that is 16-byte aligned and a multiple of 16 bytes long by
//   one bulk copy (cp.async.bulk completing on an mbarrier), the rest by
//   plain loads.  Everything is written back once at exit, the replay
//   protocol's early stop included.  A store too large for the 227 KB of
//   one SM (e.g. P = 8 ANY slots at N = 2048) takes the second
//   instantiation of the same kernel, kSharedStore = false, whose store
//   and scratch stay in device memory; the wrapper picks it from the byte
//   count before the launch (kernels/block_step.py::plan_layout, mirrored
//   by plan() below and checked at every launch).  The event rows, the
//   model tables and the stats counts each stay in device memory instead
//   when they alone exceed their share (32, 48 and 64 KB).
// - Stats without float atomics into device memory: each (p, s, s') cell
//   counts its hits of the launch in shared memory (integer atomics, one
//   per cell and warp), and at exit the cell's float gets c sequential
//   adds of its one addend (repeat_add, below).
// - Warp 0 runs the control phase and the tail: lane p owns pattern p (a
//   loop above 32 patterns), each lane issues all its loads before it
//   uses any, and the operator's scalars (clock, EMA, E-BL fraction,
//   counters, latency-ring pointer, key) live in the registers of all 32
//   lanes, which compute them redundantly and identically, so no value is
//   broadcast.  The tail of event j leaves n_act holding the PMs that
//   survive event j + 1's expiries (the advance pass counts the expiries
//   of the PMs it keeps, the tail those it spawns), so the next control
//   phase starts from one register; it also loads event j + 1's row
//   (per pattern into shared arrays, arrival and id into registers), and
//   stages each event's StepOut row and latency sample in shared memory
//   for the exit.  The f-inverse runs only when
//   Algorithm 1 sheds (ρ is 0 otherwise: the same bits).  The select's
//   128-bucket search is a warp scan.  Every float operation of
//   detect_overload, cost_sum, E-BL and the EMA keeps its order and its
//   _rn/__fmaf_rn intrinsic under -fmad=false.
// - Barriers per event: 2 (PR 12's kernel: 7, plus the fire's).  Control
//   (warp 0) | barrier | advance pass (all threads) | barrier | warp 0:
//   shed accounting, cost sum, spawn census, spawn writes, time step and
//   the next event's control.  The advance pass also counts the next
//   event's expiries and the completions and leaves a bitmask of the
//   free slots (warp 0 takes a pattern's lowest free slot from its first
//   set bit, the r-th by popcount and warp scan), so no pass of its own
//   is left for them; a warp whose slots are all free skips to its match
//   tiles and free slots.  A fire adds 12 barriers (scores, three
//   histogram levels of three, the leftover budget's scan, the drop).
//   The CTA has one thread per slot up to 512, spread evenly over the
//   P·N slots (stock N = 256, P = 3: 384 threads, two slots each); one
//   slot per thread (768 or 1 024 threads) measured no faster.
//
// Rounding follows the port's host path: the sites where the reference's
// compiler fuses a multiply into an add (the shed cost, the EMA, E-BL's
// raw priority and mean, the latency models, the per-pattern cost sum)
// are __fmaf_rn, every other float op a _rn intrinsic, and the build
// passes -fmad=false.  The per-pattern cost sum keeps the reference's
// order for each P (one FMA, a lane tree, or an FMA chain).  Algorithm
// 2's PRNG is threefry inside the kernel: each fire splits the key and
// PM-BL draws the fire's uniforms from the subkey, in the layout the
// argument block names (jax's partitionable one or its original one).
//
// Lanes: the launch's grid has one CTA per tenant lane (the reference
// vmaps the kernel over lanes).  Every operand is then lane-stacked and
// contiguous, so CTA l works on the l-th slice of each: at entry thread 0
// writes the CTA's view of the argument block, every pointer advanced by
// l times its slice's element count (and, for the replay protocol's
// relaunches, the lane's own start), into shared memory, and the body
// reads its pointers and start from there; the other arguments stay in
// the parameter space.  One launch with one lane is the
// single-operator kernel.  The body is one CTA's, so a launch of L lanes
// takes ceil(L / 132) waves (one CTA per SM).  Clusters for stores beyond
// one SM are not built.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kNbins = 128;          // the engine's shed histogram width
constexpr float kBig = 3.4e38f;      // finite inactive-slot sentinel
constexpr unsigned kFull = 0xffffffffu;

// Pattern kinds and spawn modes (cep/patterns.py), census codes and
// shedders as the Python wrapper encodes them.
constexpr int KIND_SEQ = 0;
constexpr int SPAWN_IN_WINDOWS = 1, SPAWN_AT_OPEN = 0;
constexpr int CENSUS_SEQ = 0, CENSUS_ANY = 1;
constexpr int CENSUS_AT_OPEN = 0, CENSUS_IN_WINDOWS = 1;
constexpr int SHED_PSPICE = 1, SHED_PMBL = 2, SHED_EBL = 3;
constexpr int LINEAR = 0;

}  // namespace

// Everything one launch needs; the wrapper fills it field by field
// (kernels/block_step.py::_Args mirrors this layout).
struct BlockStepArgs {
  // The event rows of the scan, (n_rows, ...); the kernel reads rows
  // [blk·W, blk·W + W).
  const int32_t* ev_class;     // (n_rows, P)
  const int32_t* ev_bind;      // (n_rows, P)
  const uint8_t* ev_open;      // (n_rows, P)
  const int32_t* ev_id;        // (n_rows,)
  const float* ev_rand;        // (n_rows,)
  const float* ebl_raw;        // (n_rows,)
  const float* arrival;        // (n_rows,)
  // The model.
  const int32_t* trans;        // (P, M, C1)
  const int32_t* kind;         // (P,)
  const int32_t* spawn_mode;   // (P,)
  const int32_t* window_size;  // (P,)
  const int32_t* final_state;  // (P,)
  const float* proc_cost;      // (P,)
  const uint8_t* uses_binding; // (P,)
  const uint8_t* spawn_counts; // (P,)
  const float* ut_tables;      // (P, B, M)
  const int32_t* ut_bins;      // (P,)
  const float* f_a;
  const float* f_b;
  const int32_t* f_kind;
  const float* g_a;
  const float* g_b;
  const int32_t* g_kind;
  const float* ebl_raw_mean;
  // The carry, updated in place.
  uint8_t* active;             // (P, N)
  int32_t* state;              // (P, N)
  int32_t* open_idx;           // (P, N)
  int32_t* bind;               // (P, N)
  int32_t* idset;              // (P, N, A)
  int32_t* ring;               // (P, K)
  int32_t* ring_ptr;           // (P,)
  float* sim_time;
  int32_t* key;                // (2,)
  float* ebl_frac;
  float* ema_gap;
  float* prev_arrival;
  float* complex_count;        // (P,)
  float* pms_created;          // (P,)
  float* pms_shed;
  float* shed_calls;
  float* overflow;
  float* ebl_dropped;
  float* obs_counts;           // (P, M, M)
  float* obs_rewards;          // (P, M, M)
  float* lat_n;                // (S,)
  float* lat_l;                // (S,)
  int32_t* lat_ptr;
  // The scan's StepOut rows (n_rows,) and match tiles (n_rows, P, N);
  // the kernel writes rows [blk·W + s, blk·W + stop).
  float* l_e;
  float* n_pm;
  uint8_t* shed;
  uint8_t* dropped;
  int32_t* m_open;
  int32_t* m_bind;
  // Scratch of one fire in device memory (P·N scores, P·N selection
  // flags; used by the device-memory store only) and the status [fires,
  // index of the last fire, or W].
  float* scratch_u;
  uint8_t* scratch_sel;
  int32_t* status;
  // Each lane's start of the span to run, (lanes,); NULL: every lane
  // starts at s.
  const int32_t* lane_s;
  // Shapes, the span [s, n_valid) of the block to run, its first global
  // event index and the block's index in the scan.
  int P, N, M, C1, A, K, S, B, W;
  int s, n_valid, i0, blk;
  // Static configuration; partitionable picks the threefry layout of the
  // fires' draws (repro_torch.prng.PARTITIONABLE).
  int kinds, spawn_modes, shedder, fused, emit, stats, partitionable;
  // The layout the wrapper planned: the store in shared memory (else
  // device memory); event rows, model tables and stats counts in shared
  // memory; the dynamic shared-memory bytes this implies.
  int store_shared, rows_smem, model_smem, stats_smem, smem_bytes;
  // The grid (one CTA per lane) and each lane's event rows, n_rows = the
  // scan's nb·W: every operand above holds `lanes` such slices.
  int lanes, n_rows;
  // Configuration constants, rounded to float32 by the wrapper.
  float c_base, c_match, c_ebl, c_shed_base, c_shed_pm;
  float latency_bound, safety_buffer, ebl_backlog_gain, ebl_decay;
  float ebl_floor, one_minus_floor;
};

namespace {

// ---------------------------------------------------------------------------
// The shared-memory layout (kernels/block_step.py::plan_layout mirrors it
// byte for byte; the launch refuses a block whose smem_bytes differ)
// ---------------------------------------------------------------------------

// Per-pattern arrays, each of round_up(P, 4) 32-bit words.
enum PatArray {
  PA_NACT, PA_EXPN, PA_DROP, PA_CMP, PA_TAKE, PA_RPTR,
  PA_NPROC, PA_CC, PA_PC, PA_CP, PA_WS, PA_FIN, PA_KIND, PA_SMODE, PA_USES,
  PA_SCNT, PA_BINS, PA_EB, PA_EC, PA_EO, kPatArrays
};
// Per-(pattern, ring entry) arrays, each of round_up(P·K, 4) words.
enum PkArray { PK_RING, PK_EXISTS, PK_TKOPEN, kPkArrays };
constexpr int kRedSlots = 8;   // reduction slots of 32 words (one per warp)

__host__ __device__ inline size_t pad16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

struct Layout {
  int npat, npk;
  size_t pat, pk, hist, edges, red, freemask;
  size_t o_le, o_npm, o_shed, o_drop, o_latn, o_latl;           // outputs
  size_t r_class, r_bind, r_open, r_id, r_rand, r_raw, r_arr;  // rows
  size_t trans, ut, hits;
  size_t act, state, open, bind, ids, u, sel;                   // store
  size_t total;
};

__host__ __device__ inline Layout plan(const BlockStepArgs& a) {
  Layout L{};
  const size_t P = a.P, F = static_cast<size_t>(a.P) * a.N, W = a.W;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += pad16(bytes);
    return at;
  };
  L.npat = (a.P + 3) & ~3;
  L.npk = (a.P * a.K + 3) & ~3;
  L.pat = take(4u * kPatArrays * L.npat);
  L.pk = take(4u * kPkArrays * L.npk);
  L.hist = take(4u * kNbins);
  L.edges = take(4u * (kNbins + 4));
  L.red = take(4u * kRedSlots * 32);
  L.freemask = take(4 * ((F + 31) / 32));
  L.o_le = take(4 * W);
  L.o_npm = take(4 * W);
  L.o_shed = take(W);
  L.o_drop = take(W);
  L.o_latn = take(4 * W);
  L.o_latl = take(4 * W);
  if (a.rows_smem) {
    L.r_class = take(4 * W * P);
    L.r_bind = take(4 * W * P);
    L.r_open = take(W * P);
    L.r_id = take(4 * W);
    L.r_rand = take(4 * W);
    L.r_raw = take(4 * W);
    L.r_arr = take(4 * W);
  }
  if (a.model_smem) {
    L.trans = take(4 * P * a.M * a.C1);
    L.ut = take(4 * P * a.B * a.M);
  }
  if (a.stats && a.stats_smem) L.hits = take(4 * P * a.M * a.M);
  if (a.store_shared) {
    L.act = take(F);
    L.state = take(4 * F);
    L.open = take(4 * F);
    L.bind = take(4 * F);
    if (a.kinds != CENSUS_SEQ) L.ids = take(4 * F * a.A);
    L.u = take(4 * F);
    L.sel = take(F);
  }
  L.total = o;
  return L;
}

// Threads per CTA: the P·N slots spread evenly over at most kMaxThreads,
// whole warps.
__host__ __device__ inline int block_threads(int F) {
  const int iters = (F + kMaxThreads - 1) / kMaxThreads;
  const int per = (F + iters - 1) / iters;
  return per < 32 ? 32 : ((per + 31) / 32) * 32;
}

// ---------------------------------------------------------------------------
// Stats: c sequential float adds of one addend
// ---------------------------------------------------------------------------

// REPEAT_ADD_BEGIN
// x ← x + a, c times, each add rounded to nearest even: the bits of c
// sequential __fadd_rn, in far fewer steps.  Why the stats may use it:
// PR 12's kernel added each hit with a float atomic; within one event
// every addend of a (p, s, s') cell is the same value (1, or
// c_match·proc_cost[p]) and the events are ordered by barriers, so the
// cell's float took exactly c sequential adds of its one addend — the
// same sequence as the plain version's index_add_.  Counting the hits and
// applying them here at exit gives those bits.
//
// Fast-forward: while x is a positive normal with ulp u and mantissa m
// (2^23 ≤ m < 2^24) and q = a/u = fl + fr (fl integer, 0 ≤ fr < 1), every
// add whose exact sum stays below the binade's top (m + fl ≤ 2^24 - 1)
// rounds on the grid of multiples of u, so it adds the same d ulps: fl +
// (fr > 1/2), or at a tie (fr = 1/2) the even choice, fl + (fl odd),
// once m is even (an odd m takes one plain step first; d is then even,
// so m stays even).  d = 0 means x absorbs a for good.  Anything else
// (zero, subnormal, inf, NaN, a ≤ 0, a ≥ the binade) takes plain steps.
__device__ inline float repeat_add(float x, float a, int c) {
  while (c > 0) {
    const float y = __fadd_rn(x, a);
    --c;
    if (y == x || y != y) return y;   // absorbed for good, or NaN
    x = y;
    if (c == 0 || !(a > 0.0f)) continue;
    const uint32_t bits = __float_as_uint(x);
    const int eb = static_cast<int>((bits >> 23) & 0xffu);
    if ((bits >> 31) != 0u || eb == 0 || eb == 0xff) continue;
    const int ex = eb - 127;
    const int32_t m = static_cast<int32_t>((bits & 0x7fffffu) | 0x800000u);
    const float q = ldexpf(a, 23 - ex);
    if (!(q < 16777216.0f)) continue;
    const float fl = floorf(q);
    const float fr = __fsub_rn(q, fl);
    const int32_t fli = static_cast<int32_t>(fl);
    int32_t d;
    if (fr == 0.5f) {
      if (m & 1) continue;
      d = fli + (fli & 1);
    } else {
      d = fli + (fr > 0.5f ? 1 : 0);
    }
    if (d == 0) return x;
    if (m + fli > 16777215) continue;
    const int32_t kmax = (16777215 - fli - m) / d + 1;
    const int32_t k = c < kmax ? c : kmax;
    c -= k;
    x = ldexpf(static_cast<float>(m + k * d), ex - 23);
  }
  return x;
}
// REPEAT_ADD_END

// ---------------------------------------------------------------------------
// PTX helpers: the entry's bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// A wait that has not completed after ~4e9 cycles (seconds; the copies
// take microseconds) traps, so a fault ends the launch with an error
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

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One piece to stage: `bytes` from `src` (device memory) to `dst`.
struct Piece {
  void* dst;
  const void* src;
  size_t bytes;
};

__device__ __forceinline__ bool bulk_ok(const Piece& c) {
  return c.bytes > 0 && c.bytes % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(c.src) % 16) == 0 &&
         (smem_u32(c.dst) % 16) == 0;
}

// Copy by plain loads and stores, 16 bytes a thread where both ends are
// aligned for it, else 4, else 1.
__device__ void copy_plain(void* dst, const void* src, size_t n, int tid,
                           int T) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(dst) |
                       reinterpret_cast<uintptr_t>(src);
  size_t done = 0;
  if (al % 16 == 0) {
    const size_t n16 = n / 16;
    for (size_t k = tid; k < n16; k += T) {
      static_cast<int4*>(dst)[k] = static_cast<const int4*>(src)[k];
    }
    done = n16 * 16;
  } else if (al % 4 == 0) {
    const size_t n4 = n / 4;
    for (size_t k = tid; k < n4; k += T) {
      static_cast<int32_t*>(dst)[k] = static_cast<const int32_t*>(src)[k];
    }
    done = n4 * 4;
  }
  for (size_t k = done + tid; k < n; k += T) {
    static_cast<uint8_t*>(dst)[k] = static_cast<const uint8_t*>(src)[k];
  }
}

// ---------------------------------------------------------------------------
// Warp helpers (all 32 lanes, converged)
// ---------------------------------------------------------------------------

// ctr[key] += the number of lanes with `hit` and this key: one shared
// atomic per distinct key of the warp, one key at a time (ballots and a
// shuffle; lanes hold neighbouring slots, so a warp meets one or two
// patterns, and __match_any_sync costs more here).
__device__ __forceinline__ void warp_count(int* ctr, int key, bool hit) {
  const int lane = threadIdx.x & 31;
  unsigned pending = __ballot_sync(kFull, hit);
  while (pending) {
    const int leader = __ffs(pending) - 1;
    const int k = __shfl_sync(kFull, key, leader);
    const unsigned grp = __ballot_sync(kFull, hit && key == k);
    if (lane == leader) atomicAdd(&ctr[k], __popc(grp));
    pending &= ~grp;
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// max / min that propagate a NaN, as the plain version's torch.maximum,
// torch.clamp and amin/amax do (and the reference's jnp.maximum / clip /
// min): fmaxf / fminf would drop it, so a poisoned clock (a NaN sim_time)
// would heal inside the kernel and nowhere else.
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// ---------------------------------------------------------------------------
// The control phase's scalar arithmetic (the port's host path, op by op)
// ---------------------------------------------------------------------------

__device__ float predict_latency(float a, float b, int kind, float n) {
  const float basis =
      kind == LINEAR ? n : __fmul_rn(n, log2f(__fadd_rn(n, 1.0f)));
  return __fmaf_rn(a, basis, b);
}

// f^{-1}: (l - b) / a for LINEAR; 16 Newton steps for NLOGN (log2f is not
// numpy's log2 to the bit, so NLOGN decisions are held to equal ρ only).
__device__ float invert_latency(float a, float b, int kind, float l) {
  const float t = nan_max(__fdiv_rn(__fsub_rn(l, b), a), 0.0f);
  if (kind == LINEAR) return t;
  const float ln2 = 0.693147182464599609375f;   // float32 log(2)
  float n = nan_max(t, 1.0f);
  for (int it = 0; it < 16; ++it) {
    const float lg = log2f(__fadd_rn(n, 1.0f));
    const float fn = __fsub_rn(__fmul_rn(n, lg), t);
    const float dfn =
        __fadd_rn(lg, __fdiv_rn(n, __fmul_rn(__fadd_rn(n, 1.0f), ln2)));
    n = nan_min(
        nan_max(__fsub_rn(n, __fdiv_rn(fn, nan_max(dfn, 1e-9f))), 0.0f),
        1e12f);
  }
  return n;
}

struct LatencyFits {
  float fa, fb, ga, gb;
  int fk, gk;
};

// Algorithm 1: shed when l_q + f(n) + g(n) + b_s > LB; ρ = n - floor(
// f^{-1}(LB - l_q - g(n) - b_s) + 1e-4), saturated like XLA's cast.  The
// inverse runs only when the event sheds (ρ is 0 otherwise), and only
// when the caller asks for ρ.
__device__ void detect_overload(const BlockStepArgs& a, const LatencyFits& m,
                                float l_q, int n_pm, bool want_rho,
                                bool* shed, int* rho) {
  const float n_f = __int2float_rn(n_pm);
  const float l_p = predict_latency(m.fa, m.fb, m.fk, n_f);
  const float l_s = predict_latency(m.ga, m.gb, m.gk, n_f);
  const float l_e = __fadd_rn(l_q, l_p);
  *shed = __fadd_rn(__fadd_rn(l_e, l_s), a.safety_buffer) > a.latency_bound;
  *rho = 0;
  if (!*shed || !want_rho) return;
  const float l_p_new = nan_max(
      __fsub_rn(__fsub_rn(__fsub_rn(a.latency_bound, l_q), l_s),
                a.safety_buffer), 0.0f);
  const int n_keep = __float2int_rz(
      floorf(__fadd_rn(invert_latency(m.fa, m.fb, m.fk, l_p_new), 1e-4f)));
  *rho = max(n_pm - n_keep, 0);
}

// t_proc = c_base + Σ_p cp_p·n_p in the reference's order for this P
// (engine._cost_sum): one FMA for P = 1; for P ∈ {4, 8, 8k} vector lanes
// of FMA chains (lane k over p = k, k + vf, ...) and a halving tree;
// otherwise an FMA chain.  nf holds the counts as floats.  kP > 0 fixes P
// at compile time, so the loads are issued before the chain starts.
template <int kP>
__device__ __forceinline__ float cost_sum_p(const float* cp, const float* nf,
                                            int P, float c_base) {
  if (kP > 0) P = kP;
  if (P == 1) return __fmaf_rn(cp[0], nf[0], c_base);
  if (P == 4 || P % 8 == 0) {
    const int vf = P < 8 ? P : 8;
    float lanes[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < vf) {
        float acc = __fmul_rn(cp[k], nf[k]);
        for (int p = k + vf; p < P; p += vf) acc = __fmaf_rn(cp[p], nf[p], acc);
        lanes[k] = acc;
      }
    }
#pragma unroll
    for (int h = 4; h >= 1; h /= 2) {
      if (h < vf) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < h) lanes[k] = __fadd_rn(lanes[k], lanes[k + h]);
        }
      }
    }
    return __fadd_rn(lanes[0], c_base);
  }
  float acc = __fmul_rn(cp[0], nf[0]);
  for (int p = 1; p < P; ++p) acc = __fmaf_rn(cp[p], nf[p], acc);
  return __fadd_rn(acc, c_base);
}

__device__ float cost_sum(const float* cp, const float* nf, int P,
                          float c_base) {
  switch (P) {
    case 1: return cost_sum_p<1>(cp, nf, P, c_base);
    case 2: return cost_sum_p<2>(cp, nf, P, c_base);
    case 3: return cost_sum_p<3>(cp, nf, P, c_base);
    case 4: return cost_sum_p<4>(cp, nf, P, c_base);
    case 5: return cost_sum_p<5>(cp, nf, P, c_base);
    case 6: return cost_sum_p<6>(cp, nf, P, c_base);
    case 7: return cost_sum_p<7>(cp, nf, P, c_base);
    case 8: return cost_sum_p<8>(cp, nf, P, c_base);
    default: return cost_sum_p<0>(cp, nf, P, c_base);
  }
}

// What warp 0 tells the block about the current event.
struct EventFlags {
  int flags;     // kStop | kFire | kDropped
  int need;      // PMs to drop (threshold select)
  int32_t eid;   // the event's distinctness id
  uint32_t sub[2];
};
// kStop: replay protocol, the event fires and is not committed; kFire:
// fused protocol, Algorithm 2 runs on this event; kDropped: E-BL dropped
// the event.
constexpr int kStop = 1, kFire = 2, kDropped = 4;

// Lane l's view of the argument block: each pointer at the l-th slice of
// its lane-stacked operand.
__device__ inline BlockStepArgs lane_view(const BlockStepArgs& g,
                                          int64_t l) {
  BlockStepArgs a = g;
  const int64_t P = g.P, F = P * g.N, rows = g.n_rows;
  const int64_t ev = l * rows, pat = l * P, mm = l * P * g.M * g.M;
  a.ev_class += ev * P;
  a.ev_bind += ev * P;
  a.ev_open += ev * P;
  a.ev_id += ev;
  a.ev_rand += ev;
  a.ebl_raw += ev;
  a.arrival += ev;
  a.trans += pat * g.M * g.C1;
  a.kind += pat;
  a.spawn_mode += pat;
  a.window_size += pat;
  a.final_state += pat;
  a.proc_cost += pat;
  a.uses_binding += pat;
  a.spawn_counts += pat;
  a.ut_tables += pat * g.B * g.M;
  a.ut_bins += pat;
  a.f_a += l;
  a.f_b += l;
  a.f_kind += l;
  a.g_a += l;
  a.g_b += l;
  a.g_kind += l;
  a.ebl_raw_mean += l;
  a.active += l * F;
  a.state += l * F;
  a.open_idx += l * F;
  a.bind += l * F;
  a.idset += l * F * g.A;
  a.ring += pat * g.K;
  a.ring_ptr += pat;
  a.sim_time += l;
  a.key += 2 * l;
  a.ebl_frac += l;
  a.ema_gap += l;
  a.prev_arrival += l;
  a.complex_count += pat;
  a.pms_created += pat;
  a.pms_shed += l;
  a.shed_calls += l;
  a.overflow += l;
  a.ebl_dropped += l;
  a.obs_counts += mm;
  a.obs_rewards += mm;
  a.lat_n += l * g.S;
  a.lat_l += l * g.S;
  a.lat_ptr += l;
  a.l_e += ev;
  a.n_pm += ev;
  a.shed += ev;
  a.dropped += ev;
  a.m_open += g.emit ? ev * F : 0;
  a.m_bind += g.emit ? ev * F : 0;
  a.scratch_u += l * F;
  a.scratch_sel += l * F;
  a.status += 2 * l;
  if (g.lane_s != nullptr) a.s = g.lane_s[l];
  return a;
}

// One CTA per SM at most: the registers may go to warp 0's scalar state
// instead of occupancy no launch can use.
template <bool kSharedStore>
__global__ void __launch_bounds__(kMaxThreads, 1)
block_step_kernel(const BlockStepArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ EventFlags ev;
  __shared__ uint64_t mbar;
  // The lane's pointers and start, read from shared memory where used;
  // every other argument stays in the parameter space.
  __shared__ BlockStepArgs lane_args;
  if (threadIdx.x == 0) lane_args = lane_view(args, blockIdx.x);
  __syncthreads();
  const BlockStepArgs& a = args;
  const BlockStepArgs& la = lane_args;
  const Layout L = plan(a);
  const int P = a.P, N = a.N, M = a.M, A = a.A, K = a.K, W = a.W;
  const int F = P * N;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  // Slot f = base + tid lies in pattern f / N: the first, and the step
  // from one stride of T slots to the next.
  const int p_first = tid / N, r_first = tid % N;
  const int p_step = T / N, r_step = T % N;
  const bool pm_shedder = a.shedder == SHED_PSPICE || a.shedder == SHED_PMBL;
  const bool at_open_census = a.spawn_modes == CENSUS_AT_OPEN;
  const bool any_ids = a.kinds != CENSUS_SEQ;

  // -- pointers --------------------------------------------------------------
  int* pat = reinterpret_cast<int*>(smem + L.pat);
  int* n_act = pat + PA_NACT * L.npat;
  int* n_expn = pat + PA_EXPN * L.npat;     // expiries at the next event
  int* n_drop = pat + PA_DROP * L.npat;
  int* n_cmp = pat + PA_CMP * L.npat;
  int* n_take = pat + PA_TAKE * L.npat;
  int* ring_ptr = pat + PA_RPTR * L.npat;
  // The counts each event was matched against, as floats (cost_sum).
  float* n_proc = reinterpret_cast<float*>(pat + PA_NPROC * L.npat);
  float* cc = reinterpret_cast<float*>(pat + PA_CC * L.npat);
  float* pc = reinterpret_cast<float*>(pat + PA_PC * L.npat);
  float* cp = reinterpret_cast<float*>(pat + PA_CP * L.npat);
  int* ws = pat + PA_WS * L.npat;
  int* fin_s = pat + PA_FIN * L.npat;
  int* kind = pat + PA_KIND * L.npat;
  int* smode = pat + PA_SMODE * L.npat;
  int* uses = pat + PA_USES * L.npat;
  int* scnt = pat + PA_SCNT * L.npat;
  int* bins = pat + PA_BINS * L.npat;
  // The current event's row per pattern (binding, class, open flag),
  // written by warp 0's tail of the event before.
  int* eb_s = pat + PA_EB * L.npat;
  int* ec_s = pat + PA_EC * L.npat;
  int* eo_s = pat + PA_EO * L.npat;
  int* pk = reinterpret_cast<int*>(smem + L.pk);
  int* ring = pk + PK_RING * L.npk;
  int* exists = pk + PK_EXISTS * L.npk;
  int* tk_open = pk + PK_TKOPEN * L.npk;
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  float* edges = reinterpret_cast<float*>(smem + L.edges);
  int* red = reinterpret_cast<int*>(smem + L.red);
  float* fred = reinterpret_cast<float*>(red);
  uint32_t* freemask = reinterpret_cast<uint32_t*>(smem + L.freemask);
  float* o_le = reinterpret_cast<float*>(smem + L.o_le);
  float* o_npm = reinterpret_cast<float*>(smem + L.o_npm);
  uint8_t* o_shed = smem + L.o_shed;
  uint8_t* o_drop = smem + L.o_drop;
  float* o_latn = reinterpret_cast<float*>(smem + L.o_latn);
  float* o_latl = reinterpret_cast<float*>(smem + L.o_latl);
  const int32_t lat_ptr0 = *la.lat_ptr;

  const int64_t row0 = static_cast<int64_t>(a.blk) * W;
  const int32_t* g_class = la.ev_class + row0 * P;
  const int32_t* g_bind = la.ev_bind + row0 * P;
  const uint8_t* g_open = la.ev_open + row0 * P;
  const int32_t* ev_class = a.rows_smem
      ? reinterpret_cast<const int32_t*>(smem + L.r_class) : g_class;
  const int32_t* ev_bind = a.rows_smem
      ? reinterpret_cast<const int32_t*>(smem + L.r_bind) : g_bind;
  const uint8_t* ev_open = a.rows_smem ? smem + L.r_open : g_open;
  const int32_t* ev_id = a.rows_smem
      ? reinterpret_cast<const int32_t*>(smem + L.r_id) : la.ev_id + row0;
  const float* ev_rand = a.rows_smem
      ? reinterpret_cast<const float*>(smem + L.r_rand) : la.ev_rand + row0;
  const float* ebl_raw = a.rows_smem
      ? reinterpret_cast<const float*>(smem + L.r_raw) : la.ebl_raw + row0;
  const float* arrival = a.rows_smem
      ? reinterpret_cast<const float*>(smem + L.r_arr) : la.arrival + row0;
  const int32_t* trans = a.model_smem
      ? reinterpret_cast<const int32_t*>(smem + L.trans) : la.trans;
  const float* ut = a.model_smem
      ? reinterpret_cast<const float*>(smem + L.ut) : la.ut_tables;
  int* hits = reinterpret_cast<int*>(smem + L.hits);
  const bool hits_smem = a.stats && a.stats_smem;

  uint8_t* act;
  int32_t *st, *oi, *bd, *ids;
  float* su;
  uint8_t* ssel;
  if constexpr (kSharedStore) {
    act = smem + L.act;
    st = reinterpret_cast<int32_t*>(smem + L.state);
    oi = reinterpret_cast<int32_t*>(smem + L.open);
    bd = reinterpret_cast<int32_t*>(smem + L.bind);
    ids = reinterpret_cast<int32_t*>(smem + L.ids);
    su = reinterpret_cast<float*>(smem + L.u);
    ssel = smem + L.sel;
  } else {
    act = la.active;
    st = la.state;
    oi = la.open_idx;
    bd = la.bind;
    ids = la.idset;
    su = la.scratch_u;
    ssel = la.scratch_sel;
  }

  // -- entry: stage the launch's state ----------------------------------------
  const size_t fz = static_cast<size_t>(F);
  const Piece pieces[] = {
      {smem + L.r_class, g_class, a.rows_smem ? 4ull * W * P : 0},
      {smem + L.r_bind, g_bind, a.rows_smem ? 4ull * W * P : 0},
      {smem + L.r_open, g_open, a.rows_smem ? 1ull * W * P : 0},
      {smem + L.r_id, la.ev_id + row0, a.rows_smem ? 4ull * W : 0},
      {smem + L.r_rand, la.ev_rand + row0, a.rows_smem ? 4ull * W : 0},
      {smem + L.r_raw, la.ebl_raw + row0, a.rows_smem ? 4ull * W : 0},
      {smem + L.r_arr, la.arrival + row0, a.rows_smem ? 4ull * W : 0},
      {smem + L.trans, la.trans, a.model_smem ? 4ull * P * M * a.C1 : 0},
      {smem + L.ut, la.ut_tables, a.model_smem ? 4ull * P * a.B * M : 0},
      {smem + L.act, la.active, kSharedStore ? fz : 0},
      {smem + L.state, la.state, kSharedStore ? 4 * fz : 0},
      {smem + L.open, la.open_idx, kSharedStore ? 4 * fz : 0},
      {smem + L.bind, la.bind, kSharedStore ? 4 * fz : 0},
      {smem + L.ids, la.idset, kSharedStore && any_ids ? 4 * fz * A : 0},
  };
  constexpr int kPieces = sizeof(pieces) / sizeof(pieces[0]);
  const uint32_t bar = smem_u32(&mbar);
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  if (tid == 0) {
    uint32_t tx = 0;
    for (int k = 0; k < kPieces; ++k) {
      if (bulk_ok(pieces[k])) tx += static_cast<uint32_t>(pieces[k].bytes);
    }
    mbar_expect_tx(bar, tx);
    for (int k = 0; k < kPieces; ++k) {
      if (bulk_ok(pieces[k])) {
        bulk_load(pieces[k].dst, pieces[k].src,
                  static_cast<uint32_t>(pieces[k].bytes), bar);
      }
    }
  }
  for (int k = 0; k < kPieces; ++k) {
    if (pieces[k].bytes > 0 && !bulk_ok(pieces[k])) {
      copy_plain(pieces[k].dst, pieces[k].src, pieces[k].bytes, tid, T);
    }
  }
  for (int p = tid; p < P; p += T) {
    n_act[p] = 0;
    n_expn[p] = 0;
    n_drop[p] = 0;
    n_cmp[p] = 0;
    ring_ptr[p] = la.ring_ptr[p];
    cc[p] = la.complex_count[p];
    pc[p] = la.pms_created[p];
    cp[p] = __fmul_rn(a.c_match, la.proc_cost[p]);
    ws[p] = la.window_size[p];
    fin_s[p] = la.final_state[p];
    kind[p] = la.kind[p];
    smode[p] = la.spawn_mode[p];
    uses[p] = la.uses_binding[p];
    scnt[p] = la.spawn_counts[p];
    bins[p] = la.ut_bins[p];
  }
  for (int q = tid; q < P * K; q += T) {
    ring[q] = la.ring[q];
    exists[q] = 0;
  }
  if (hits_smem) {
    for (int q = tid; q < P * M * M; q += T) hits[q] = 0;
  }
  mbar_wait(bar, 0);
  __syncthreads();

  if (la.s < a.n_valid) {
    for (int p = tid; p < P; p += T) {
      eb_s[p] = ev_bind[la.s * P + p];
      ec_s[p] = ev_class[la.s * P + p];
      eo_s[p] = ev_open[la.s * P + p];
    }
  }
  // Live PMs per pattern and the first event's expiries.  From here on
  // n_act holds, before each event, the PMs that survive its expiries.
  {
    const int32_t i = repro::wrap_add(a.i0, la.s);
    for (int base = 0; base < F; base += T) {
      const int f = base + tid;
      const bool valid = f < F;
      const int p = valid ? f / N : 0;
      const bool on = valid && act[f] != 0;
      warp_count(n_act, p, on && repro::wrap_sub(i, oi[f]) < ws[p]);
    }
  }
  __syncthreads();

  // Warp 0's control state, the same in all 32 lanes.
  float sim = 0.f, ema = 0.f, prev = 0.f, eblf = 0.f, ovf = 0.f, ebld = 0.f;
  float pshed = 0.f, scalls = 0.f, mean_eff = 0.f;
  LatencyFits fits{};
  int nfire = 0, fire_idx = W;
  int32_t lat_ptr = 0;
  uint32_t key[2] = {0u, 0u};
  if (warp == 0) {
    sim = *la.sim_time; ema = *la.ema_gap; prev = *la.prev_arrival;
    eblf = *la.ebl_frac; ovf = *la.overflow; ebld = *la.ebl_dropped;
    pshed = *la.pms_shed; scalls = *la.shed_calls; lat_ptr = lat_ptr0;
    key[0] = static_cast<uint32_t>(la.key[0]);
    key[1] = static_cast<uint32_t>(la.key[1]);
    fits = LatencyFits{*la.f_a, *la.f_b, *la.g_a, *la.g_b, *la.f_kind, *la.g_kind};
    mean_eff = __fmaf_rn(a.one_minus_floor, *la.ebl_raw_mean, a.ebl_floor);
  }
  // Per-event values warp 0 keeps from the control phase to the tail; the
  // next event's PM count comes from the tail.
  int n_pm_i = 0, n_pm_next = 0;
  float arr_next = 0.f;
  int32_t eid_next = 0;
  if (warp == 0) {
    int part = 0;
    for (int p = lane; p < P; p += 32) part += n_act[p];
    n_pm_next = warp_sum(part);
    if (la.s < a.n_valid) {
      arr_next = arrival[la.s];
      eid_next = ev_id[la.s];
    }
  }
  float arr = 0.f;
  bool did_shed = false, ev_fire = false, ev_drop = false;

  int j_end = a.n_valid;      // the first event not committed
  for (int j = la.s; j < a.n_valid; ++j) {
    const int32_t i = repro::wrap_add(a.i0, j);
    const int32_t* eb = ev_bind + j * P;
    // -- warp 0: Algorithm 1, ring, Algorithm 2's key, E-BL, EMA -------------
    if (warp == 0) {
      arr = arr_next;
      n_pm_i = n_pm_next;
      const float sim1 = nan_max(sim, arr);
      const float l_q = __fsub_rn(sim1, arr);
      bool shed = false;
      int rho = 0;
      if (pm_shedder) detect_overload(a, fits, l_q, n_pm_i, true, &shed, &rho);
      const bool fire = shed && rho > 0;
      const bool stop = fire && !a.fused;
      ev_fire = fire && a.fused;
      ev_drop = false;
      did_shed = false;
      if (stop) {
        nfire = 1;
        fire_idx = j;
      } else {
        if (!at_open_census) {
          for (int p = lane; p < P; p += 32) {
            const bool op = eo_s[p] != 0;
            const int smp = smode[p], rp = ring_ptr[p];
            if (op && smp == SPAWN_IN_WINDOWS) {
              if (rp >= 0 && rp < K) ring[p * K + rp] = i;
              ring_ptr[p] = rp >= -1 && rp + 1 < K ? rp + 1
                                                : repro::floor_mod(rp + 1, K);
            }
          }
        }
        sim = sim1;
        if (fire) {                  // fused Algorithm 2: key, sub = split
          uint32_t next[2], sub[2];
          repro::threefry_split(key, next, sub, a.partitionable != 0);
          key[0] = next[0]; key[1] = next[1];
          if (lane == 0) {
            ev.sub[0] = sub[0];
            ev.sub[1] = sub[1];
            ev.need = min(rho, n_pm_i);
          }
          ++nfire;
          fire_idx = j;
          did_shed = true;
        }
        // E-BL input drop and the inter-arrival EMA.
        const float gap = nan_max(__fsub_rn(arr, prev), 1e-9f);
        ema = __fmaf_rn(0.99f, ema, __fmul_rn(0.01f, gap));
        prev = arr;
        if (a.shedder == SHED_EBL) {
          bool shed_e = false;
          int rho_e = 0;
          detect_overload(a, fits, l_q, n_pm_i, false, &shed_e, &rho_e);
          const float l_p_est =
              predict_latency(fits.fa, fits.fb, fits.fk,
                              __int2float_rn(n_pm_i));
          const float d_ff =
              __fdiv_rn(__fsub_rn(l_p_est, ema),
                        nan_max(__fsub_rn(l_p_est, a.c_ebl), 1e-9f));
          // d_ff + gain·l_q / LB as the reference's compiler folds it:
          // fma(l_q, gain · (1 / LB), d_ff), the constant in float32.
          const float bk_rate =
              __fmul_rn(a.ebl_backlog_gain, __frcp_rn(a.latency_bound));
          const float d_need =
              nan_min(nan_max(__fmaf_rn(l_q, bk_rate, d_ff), 0.0f), 1.0f);
          const float decayed = __fmul_rn(eblf, a.ebl_decay);
          eblf = shed_e ? nan_max(decayed, d_need) : decayed;
          const float raw_eff =
              __fmaf_rn(a.one_minus_floor, ebl_raw[j], a.ebl_floor);
          const float p_drop = nan_min(
              nan_max(__fdiv_rn(__fmul_rn(raw_eff, eblf),
                                nan_max(mean_eff, 1e-9f)),
                      0.0f),
              1.0f);
          ev_drop = ev_rand[j] < p_drop;
          ebld = __fadd_rn(ebld, ev_drop ? 1.0f : 0.0f);
          did_shed = shed_e;
        }
      }
      if (lane == 0) {
        ev.eid = eid_next;
        ev.flags = (stop ? kStop : 0) | (ev_fire ? kFire : 0) |
                   (ev_drop ? kDropped : 0);
      }
    }
    __syncthreads();                                           // barrier 1
    const int flags = ev.flags;
    const int32_t eid = ev.eid;
    if (flags & kStop) {
      j_end = j;
      break;
    }
    const bool fire = (flags & kFire) != 0;
    const bool dropped = (flags & kDropped) != 0;

    // -- fused Algorithm 2: scores, histogram-threshold select, drop ---------
    // core/shedder.py::threshold_drop_mask: three levels of 128 buckets
    // over the shared edges lo + ((hi - lo)·k)/128, then the leftover
    // budget by slot index.  sel: 1 = candidate, 2 = dropped, 0 = out.
    if (fire) {
      float mn = kBig, mx = -kBig;
      for (int f = tid; f < F; f += T) {
        const int p = f / N;
        const int32_t o = oi[f];
        const bool on = act[f] != 0 && repro::wrap_sub(i, o) < ws[p];
        act[f] = on ? 1 : 0;
        float u;
        if (a.shedder == SHED_PSPICE) {
          const int32_t r_w = repro::wrap_sub(ws[p], repro::wrap_sub(i, o));
          u = on ? repro::utility_at(ut, p, a.B, M, st[f], r_w, bins[p])
                 : kBig;
        } else {
          u = repro::threefry_uniform(ev.sub, static_cast<uint32_t>(f),
                                      static_cast<uint32_t>(F),
                                      a.partitionable != 0);
        }
        su[f] = u;
        ssel[f] = on ? 1 : 0;
        if (on) {
          mn = nan_min(mn, u);
          mx = nan_max(mx, u);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mn = nan_min(mn, __shfl_xor_sync(kFull, mn, o));
        mx = nan_max(mx, __shfl_xor_sync(kFull, mx, o));
      }
      if (lane == 0) {
        fred[warp] = mn;
        fred[32 + warp] = mx;
      }
      __syncthreads();
      float lo = fred[0], hi0 = fred[32];
      for (int k = 1; k < nwarps; ++k) {
        lo = nan_min(lo, fred[k]);
        hi0 = nan_max(hi0, fred[32 + k]);
      }
      float hi = hi0 > lo ? hi0 : __fadd_rn(lo, 1.0f);
      int need = ev.need;
      for (int level = 0; level < 3; ++level) {
        for (int k = tid; k <= kNbins; k += T) {
          edges[k] = k == kNbins
              ? __int_as_float(0x7f800000)
              : __fadd_rn(lo, __fdiv_rn(__fmul_rn(__fsub_rn(hi, lo),
                                                  __int2float_rn(k)),
                                        static_cast<float>(kNbins)));
          if (k < kNbins) hist[k] = 0;
        }
        __syncthreads();
        for (int f = tid; f < F; f += T) {
          if (ssel[f] == 1) {
            const int b = repro::bucket_of(su[f], edges, kNbins);
            if (b >= 0) atomicAdd(&hist[b], 1);
          }
        }
        __syncthreads();
        // The first bucket whose cumulative count reaches `need`, else the
        // last: every warp scans the 128 counts, 4 to a lane.
        int h[4], run = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          run += hist[lane * 4 + q];
          h[q] = run;
        }
        const int before = warp_inclusive_scan(run) - run;
        int mine = kNbins;
#pragma unroll
        for (int q = 3; q >= 0; --q) {
          if (before + h[q] >= need) mine = lane * 4 + q;
        }
        const unsigned hit = __ballot_sync(kFull, mine < kNbins);
        const int kb = hit ? __shfl_sync(kFull, mine, __ffs(hit) - 1)
                           : kNbins - 1;
        const float edge = edges[kb], upper = edges[kb + 1];
        int below = 0;
        for (int f = tid; f < F; f += T) {
          if (ssel[f] == 1) {
            const float u = su[f];
            if (u < edge) {
              ssel[f] = 2;
              ++below;
            } else if (!(u < upper)) {
              ssel[f] = 0;
            }
          }
        }
        below = warp_sum(below);
        if (lane == 0) red[(2 + level) * 32 + warp] = below;
        __syncthreads();
        below = 0;
        for (int k = 0; k < nwarps; ++k) below += red[(2 + level) * 32 + k];
        need = max(need - below, 0);
        const float hi_next = kb == kNbins - 1 ? hi : upper;
        lo = edge;
        hi = hi_next > edge ? hi_next : __fadd_rn(edge, 1.0f);
      }
      // The remaining budget: the lowest-index candidates; then the drop.
      const int chunk = (F + T - 1) / T;
      const int f0 = min(tid * chunk, F), f1 = min(f0 + chunk, F);
      int c = 0;
      for (int f = f0; f < f1; ++f) c += ssel[f] == 1;
      const int incl = warp_inclusive_scan(c);
      if (lane == 31) red[5 * 32 + warp] = incl;
      __syncthreads();
      int r = incl - c;
      for (int k = 0; k < warp; ++k) r += red[5 * 32 + k];
      for (int f = f0; f < f1; ++f) {
        const int sel = ssel[f];
        bool drop = sel == 2;
        if (sel == 1) {
          drop = r < need;
          ++r;
        }
        if (drop) {
          act[f] = 0;
          atomicAdd(&n_drop[f / N], 1);
        }
      }
      __syncthreads();
    }

    // -- advance, completions, match tiles, stats; counts for warp 0 --------
    {
      const int32_t inext = repro::wrap_add(i, 1);
      int32_t* m_open = la.m_open + (row0 + j) * static_cast<int64_t>(F);
      int32_t* m_bind = la.m_bind + (row0 + j) * static_cast<int64_t>(F);
      const bool seq_only = a.kinds == CENSUS_SEQ;
      const bool any_only = a.kinds == CENSUS_ANY;
      int pn = p_first, rn = r_first;
      for (int base = 0; base < F; base += T) {
        const int f = base + tid;
        const bool valid = f < F;
        // This thread's pattern, stepped without a division.
        const int p = valid ? pn : P - 1;
        rn += r_step;
        pn += p_step + (rn >= N ? 1 : 0);
        rn -= rn >= N ? N : 0;
        // A warp whose slots are all free only writes its match tiles and
        // reports its free slots.
        const int fc = valid ? f : F - 1;
        const bool act0 = act[fc] != 0;
        const int32_t o = oi[fc], b = bd[fc], s = st[fc];
        if (__ballot_sync(kFull, valid && act0) == 0u) {
          if (valid && a.emit) {
            m_open[f] = -1;
            m_bind[f] = -1;
          }
          const unsigned word = __ballot_sync(kFull, valid);
          if (lane == 0 && base + warp * 32 < F) {
            freemask[(base + warp * 32) >> 5] = word;
          }
          continue;
        }
        // The pattern's loads go out together (an out-of-range lane read
        // the last slot and drops it).
        const int wsp = ws[p], fin = fin_s[p], usp = uses[p];
        const int32_t ebp = eb_s[p], ecp = ec_s[p];
        const int kp = seq_only || any_only ? 0 : kind[p];
        const bool on = valid && act0 && repro::wrap_sub(i, o) < wsp;
        bool completed = false;
        int cell = 0;
        if (on) {
          const bool bind_ok = !usp || b == ebp;
          const bool seq = seq_only || (!any_only && kp == KIND_SEQ);
          int32_t nxt;
          if (seq) {
            // repro::nfa_next with a 32-bit index (the table is small).
            const bool go = bind_ok && !dropped && s >= 0 && s < M &&
                            ecp >= 0 && ecp < a.C1;
            nxt = go ? trans[(p * M + s) * a.C1 + ecp] : s;
          } else {
            int32_t* id = ids + static_cast<int64_t>(f) * A;
            bool in_set = false;
            for (int q = 0; q < A; ++q) in_set |= id[q] == eid;
            const int lc = dropped ? 0 : ecp;
            const bool match = bind_ok && lc == 1 && !in_set && s < fin;
            nxt = s + (match ? 1 : 0);
            if (match) {
              const int slot = min(max(s - 1 + (scnt[p] ? 1 : 0), 0), A - 1);
              id[slot] = eid;
            }
          }
          completed = nxt == fin && s != fin;
          st[f] = nxt;
          cell = (p * M + s) * M + nxt;
          if (a.stats && !hits_smem) {
            // PR 12's path, for stats counts too large for shared memory:
            // within one event every addend of a cell is the same value,
            // so the atomics give the sequential bits.
            atomicAdd(&la.obs_counts[cell], 1.0f);
            atomicAdd(&la.obs_rewards[cell], cp[p]);
          }
        }
        const bool live = on && !completed;
        if (valid) {
          if (live != act0) act[f] = live ? 1 : 0;
          if (a.emit) {
            m_open[f] = completed ? o : -1;
            m_bind[f] = completed ? b : -1;
          }
          if (live && !at_open_census && b == ebp) {
            for (int k = 0; k < K; ++k) {
              if (o == ring[p * K + k]) exists[p * K + k] = 1;
            }
          }
        }
        if (hits_smem) warp_count(hits, cell, on);
        warp_count(n_cmp, p, completed);
        warp_count(n_expn, p, live && repro::wrap_sub(inext, o) >= wsp);
        const unsigned word = __ballot_sync(kFull, valid && !live);
        if (lane == 0 && base + warp * 32 < F) {
          freemask[(base + warp * 32) >> 5] = word;
        }
      }
    }
    __syncthreads();                                           // barrier 2

    // -- warp 0: shed accounting, time cost, spawn, time step ----------------
    if (warp == 0) {
      const int32_t inext = repro::wrap_add(i, 1);
      // The next event's arrival and id, loaded during this tail.
      const bool has_next = j + 1 < a.n_valid;
      if (has_next) {
        arr_next = arrival[j + 1];
        eid_next = ev_id[j + 1];
      }
      auto spawn = [&](int f, int32_t open, int32_t bind_v, int counts) {
        act[f] = 1;
        st[f] = 1;
        oi[f] = open;
        bd[f] = bind_v;
        if (any_ids) {
          int32_t* id = ids + static_cast<int64_t>(f) * A;
          id[0] = counts ? eid : -1;
          for (int k = 1; k < A; ++k) id[k] = -1;
        }
      };
      // Per pattern, one batch of loads: the counts the block left, the
      // pattern's columns and the event's row; then completions, the spawn
      // census (at open: the spawn itself), the new counts, the next
      // event's survivors, and the per-event counters reset for it.
      int drops = 0, novf = 0, n_after = 0, next = 0;
      for (int p = lane; p < P; p += 32) {
        const int na = n_act[p], nd = n_drop[p], nc = n_cmp[p];
        const int nen = n_expn[p];
        const int wsp = ws[p], smp = smode[p], scp = scnt[p];
        const float ccv = cc[p], pcv = pc[p];
        const bool op = eo_s[p] != 0;
        const int32_t ebp = eb_s[p], ecp = ec_s[p];
        const int q_next = has_next ? (j + 1) * P + p : j * P + p;
        const int32_t eb_n = ev_bind[q_next], ec_n = ev_class[q_next];
        const uint8_t eo_n = ev_open[q_next];
        // t_proc counts the PMs the event was matched against: the counts
        // after the shed and before the completions.
        const int nproc = na - nd;
        drops += nd;
        n_proc[p] = __int2float_rn(nproc);
        int nact = nproc - nc;
        cc[p] = __fadd_rn(ccv, __int2float_rn(nc));
        const int n_free = N - nact;
        const bool lo_p = op && !dropped;
        int take = 0, exp_spawned = 0;
        if (at_open_census) {
          // Every pattern spawns at open: one candidate, the lowest free slot.
          const bool can = lo_p && n_free > 0;
          novf += lo_p && !can;
          if (can) {
            // The lowest free slot: the first set bit of the pattern's
            // words of the advance pass's free-slot bitmask.
            const int lo_f = p * N, hi_f = lo_f + N;
            int ffree = lo_f;
            for (int w = lo_f >> 5; w * 32 < hi_f; ++w) {
              uint32_t bits = freemask[w];
              if (w * 32 < lo_f) bits &= ~0u << (lo_f - w * 32);
              if (w * 32 + 32 > hi_f) bits &= ~0u >> (w * 32 + 32 - hi_f);
              if (bits) {
                ffree = w * 32 + __ffs(bits) - 1;
                break;
              }
            }
            take = 1;
            spawn(ffree, i, ebp, scp);
            exp_spawned = repro::wrap_sub(inext, i) >= wsp;
          }
        } else {
          const bool p_at_open = smp == SPAWN_AT_OPEN;
          const int lc = dropped ? 0 : ecp;
          for (int k = 0; k < K; ++k) {
            const int q = p * K + k;
            const int32_t w = ring[q];
            const bool win = w >= 0 && repro::wrap_sub(i, w) < wsp &&
                             !exists[q] && lc == 1 && !p_at_open;
            const bool open_sp = p_at_open && lo_p && k == 0;
            const bool cand = a.spawn_modes == CENSUS_IN_WINDOWS
                                  ? win : (win || open_sp);
            exists[q] = 0;
            if (cand) {
              if (take < n_free) {
                const int32_t open =
                    (a.spawn_modes != CENSUS_IN_WINDOWS && p_at_open) ? i : w;
                tk_open[p * K + take] = open;
                exp_spawned += repro::wrap_sub(inext, open) >= wsp;
                ++take;
              } else {
                ++novf;
              }
            }
          }
        }
        n_take[p] = take;
        pc[p] = __fadd_rn(pcv, __int2float_rn(take));
        nact += take;
        n_after += nact;
        const int survive = nact - nen - exp_spawned;
        next += survive;
        n_act[p] = survive;
        n_expn[p] = 0;
        n_drop[p] = 0;
        n_cmp[p] = 0;
        eb_s[p] = eb_n;
        ec_s[p] = ec_n;
        eo_s[p] = eo_n;
      }
      n_pm_next = warp_sum(next);
      drops = warp_sum(drops);
      novf = warp_sum(novf);
      n_after = warp_sum(n_after);
      if (fire) {
        pshed = __fadd_rn(pshed, __int2float_rn(drops));
        scalls = __fadd_rn(scalls, 1.0f);
        sim = __fadd_rn(sim, __fmaf_rn(a.c_shed_pm, __int2float_rn(n_pm_i),
                                       a.c_shed_base));
      }
      float t_proc = a.c_ebl;
      __syncwarp();
      if (!dropped) {
        t_proc = cost_sum(cp, n_proc, P, a.c_base);
      }
      ovf = __fadd_rn(ovf, __int2float_rn(novf));
      if (!at_open_census) {
        // The r-th lowest free slot of each pattern that spawns, from the
        // advance pass's free-slot bitmask: popcounts and a warp scan over
        // 32 words at a time.
        __syncwarp();
        for (int c0 = 0; c0 < P; c0 += 32) {
          unsigned todo =
              __ballot_sync(kFull, c0 + lane < P && n_take[c0 + lane] > 0);
          while (todo) {
            const int p = c0 + __ffs(todo) - 1;
            todo &= todo - 1;
            const int want = n_take[p], scp = scnt[p];
            const int32_t ebp = eb[p];
            const int lo_f = p * N, hi_f = lo_f + N;
            int found = 0;
            for (int w0 = lo_f >> 5; found < want && w0 * 32 < hi_f;
                 w0 += 32) {
              const int w = w0 + lane;
              uint32_t bits = 0u;
              if (w * 32 < hi_f) {
                bits = freemask[w];
                if (w * 32 < lo_f) bits &= ~0u << (lo_f - w * 32);
                if (w * 32 + 32 > hi_f) bits &= ~0u >> (w * 32 + 32 - hi_f);
              }
              const int cnt = __popc(bits);
              const int incl = warp_inclusive_scan(cnt);
              for (int rk = found + incl - cnt; rk < found + incl && rk < want;
                   ++rk) {
                uint32_t bb = bits;
                for (int t = rk - (found + incl - cnt); t > 0; --t) bb &= bb - 1;
                spawn(w * 32 + __ffs(bb) - 1, tk_open[p * K + rk], ebp, scp);
              }
              found += __shfl_sync(kFull, incl, 31);
            }
          }
        }
      }
      sim = __fadd_rn(sim, t_proc);
      if (lane == 0) {           // written to device memory at exit
        o_latn[j] = __int2float_rn(n_pm_i);
        o_latl[j] = t_proc;
        o_le[j] = __fsub_rn(sim, arr);
        o_npm[j] = __int2float_rn(n_after);
        o_shed[j] = did_shed ? 1 : 0;
        o_drop[j] = dropped ? 1 : 0;
      }
      lat_ptr = repro::wrap_add(lat_ptr, 1);
      __syncwarp();
    }
  }
  __syncthreads();

  // -- exit: write the launch's state back -----------------------------------
  if constexpr (kSharedStore) {
    copy_plain(la.active, act, fz, tid, T);
    copy_plain(la.state, st, 4 * fz, tid, T);
    copy_plain(la.open_idx, oi, 4 * fz, tid, T);
    copy_plain(la.bind, bd, 4 * fz, tid, T);
    if (any_ids) copy_plain(la.idset, ids, 4 * fz * A, tid, T);
  }
  for (int p = tid; p < P; p += T) {
    la.ring_ptr[p] = ring_ptr[p];
    la.complex_count[p] = cc[p];
    la.pms_created[p] = pc[p];
  }
  for (int q = tid; q < P * K; q += T) la.ring[q] = ring[q];
  for (int k = la.s + tid; k < j_end; k += T) {
    la.l_e[row0 + k] = o_le[k];
    la.n_pm[row0 + k] = o_npm[k];
    la.shed[row0 + k] = o_shed[k];
    la.dropped[row0 + k] = o_drop[k];
  }
  // Event j took the latency ring's slot floor_mod(lat_ptr + (j - s), S);
  // when the block outruns the ring, the last S events' slots survive.
  for (int k = max(la.s, j_end - a.S) + tid; k < j_end; k += T) {
    const int pos = repro::floor_mod(repro::wrap_add(lat_ptr0, k - la.s), a.S);
    la.lat_n[pos] = o_latn[k];
    la.lat_l[pos] = o_latl[k];
  }
  if (hits_smem) {
    for (int q = tid; q < P * M * M; q += T) {
      const int c = hits[q];
      if (c > 0) {
        la.obs_counts[q] = repeat_add(la.obs_counts[q], 1.0f, c);
        la.obs_rewards[q] = repeat_add(la.obs_rewards[q], cp[q / (M * M)], c);
      }
    }
  }
  if (tid == 0) {
    *la.sim_time = sim; *la.ema_gap = ema; *la.prev_arrival = prev;
    *la.ebl_frac = eblf; *la.overflow = ovf; *la.ebl_dropped = ebld;
    *la.pms_shed = pshed; *la.shed_calls = scalls; *la.lat_ptr = lat_ptr;
    la.key[0] = static_cast<int32_t>(key[0]);
    la.key[1] = static_cast<int32_t>(key[1]);
    la.status[0] = nfire;
    la.status[1] = fire_idx;
  }
}

// The generator alone, for the tests: key, sub = split(key) and the n
// uniforms jax.random.uniform(sub, (n,)) draws, in the given layout.
__global__ void threefry_probe_kernel(const int32_t* __restrict__ key, int n,
                                      int partitionable,
                                      int32_t* __restrict__ keys_out,
                                      float* __restrict__ u_out) {
  const uint32_t k[2] = {static_cast<uint32_t>(key[0]),
                         static_cast<uint32_t>(key[1])};
  uint32_t next[2], sub[2];
  repro::threefry_split(k, next, sub, partitionable != 0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) {
    keys_out[0] = static_cast<int32_t>(next[0]);
    keys_out[1] = static_cast<int32_t>(next[1]);
    keys_out[2] = static_cast<int32_t>(sub[0]);
    keys_out[3] = static_cast<int32_t>(sub[1]);
  }
  for (int e = t; e < n; e += gridDim.x * blockDim.x) {
    u_out[e] = repro::threefry_uniform(sub, static_cast<uint32_t>(e),
                                       static_cast<uint32_t>(n),
                                       partitionable != 0);
  }
}

// The largest dynamic shared memory each instantiation was opened to.
int g_smem_opened[2] = {48 * 1024, 48 * 1024};

}  // namespace

extern "C" int block_step_launch(const BlockStepArgs* args, void* stream) {
  const BlockStepArgs& a = *args;
  if (a.P < 1 || a.N < 1 || a.M < 1 || a.A < 1 || a.K < 1 || a.S < 1 ||
      a.W < 1 || a.s < 0 || a.n_valid > a.W || a.blk < 0 || a.lanes < 1 ||
      a.n_rows < (a.blk + 1) * a.W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = plan(a);
  if (L.total != static_cast<size_t>(a.smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int inst = a.store_shared ? 1 : 0;
  const auto kernel = a.store_shared ? block_step_kernel<true>
                                     : block_step_kernel<false>;
  if (a.smem_bytes > g_smem_opened[inst]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_opened[inst] = a.smem_bytes;
  }
  kernel<<<a.lanes, block_threads(a.P * a.N), a.smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_probe_launch(const void* key, int n, int partitionable,
                                     void* keys_out, void* u_out,
                                     void* stream) {
  const int blocks = n > 0 ? (n + 255) / 256 < 132 ? (n + 255) / 256 : 132 : 1;
  threefry_probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), n, partitionable,
      static_cast<int32_t*>(keys_out), static_cast<float*>(u_out));
  return static_cast<int>(cudaGetLastError());
}
