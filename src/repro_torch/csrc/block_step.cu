// The event-block megakernel: W events of the whole CEP operator in one
// launch, with the PM store, the window ring, the overload scalars, the
// latency ring and the PRNG key kept on the device for the whole block.
//
// Replaces: src/repro/kernels/block_step.py::_block_kernel (one Pallas
// call with every operand a VMEM-resident block and an in-kernel
// fori_loop over the W events).
//
// Per event, in the order of the reference step: expire → Algorithm 1
// (lazy f-inverse) → Algorithm 2 when it fires (fused: the pSPICE lookup
// or the PM-BL uniforms, then the histogram-threshold select) → E-BL →
// SEQ / ANY advance → completions and match tiles → stats scatter →
// spawn by rank → simulated time and latency ring → the StepOut row.  In
// the replay protocol the kernel stops before the first fire and reports
// it; the host replays that event and re-enters after it.
//
// Design: one CTA (kThreads threads) per lane, the W-event loop inside
// the kernel, __syncthreads() between the phases of an event, threads
// striding over the P·N slots.  The store stays in device memory: at the
// stock size it is about 10 KB and lives in L2.  The operator's scalar
// control state (clock, EMA, E-BL fraction, counters, latency-ring
// pointer, key) lives in thread 0's registers and is written back once at
// the end; thread 0 also runs the per-pattern bookkeeping (P and K are
// small).  Algorithm 2's PRNG is threefry inside the kernel: each fire
// splits the key itself and PM-BL draws the fire's uniforms from the
// subkey, so no per-block key chain or uniform block is precomputed.
//
// Rounding follows the port's host path: the sites where the reference's
// compiler fuses a multiply into an add (the shed cost, the EMA, E-BL's
// raw priority and mean, the latency models, the per-pattern cost sum)
// are __fmaf_rn, every other float op a _rn intrinsic, and the build
// passes -fmad=false.  The per-pattern cost sum keeps the reference's
// order for each P (one FMA, a lane tree, or an FMA chain).
//
// Bound: neither bytes nor operations — one SM walks W events in order
// with about seven block-wide barriers each; per event it touches the
// P·N store once or twice (a few tens of KB at N = 2048, from L2).  The
// time per event is latency: barriers plus thread 0's serial scalar
// phase.  This is the simple, right version; the store in shared memory,
// fewer barriers and lanes on other SMs are later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNbins = 128;          // the engine's shed histogram width
constexpr float kBig = 3.4e38f;      // finite inactive-slot sentinel
constexpr unsigned kFull = 0xffffffffu;

// Pattern kinds and spawn modes (cep/patterns.py), census codes and
// shedders as the Python wrapper encodes them.
constexpr int KIND_SEQ = 0;
constexpr int SPAWN_AT_OPEN = 0, SPAWN_IN_WINDOWS = 1;
constexpr int CENSUS_SEQ = 0, CENSUS_ANY = 1;
constexpr int CENSUS_AT_OPEN = 0, CENSUS_IN_WINDOWS = 1;
constexpr int SHED_PSPICE = 1, SHED_PMBL = 2, SHED_EBL = 3;
constexpr int LINEAR = 0;

}  // namespace

// Everything one launch needs; the wrapper fills it field by field
// (kernels/block_step.py::_Args mirrors this layout).
struct BlockStepArgs {
  // The event block: W rows, already offset to the block.
  const int32_t* ev_class;     // (W, P)
  const int32_t* ev_bind;      // (W, P)
  const uint8_t* ev_open;      // (W, P)
  const int32_t* ev_id;        // (W,)
  const float* ev_rand;        // (W,)
  const float* ebl_raw;        // (W,)
  const float* arrival;        // (W,)
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
  // The block's StepOut rows and match tiles (W, P, N).
  float* l_e;
  float* n_pm;
  uint8_t* shed;
  uint8_t* dropped;
  int32_t* m_open;
  int32_t* m_bind;
  // Scratch of one fire (P·N scores, P·N selection flags) and the status
  // [fires, index of the last fire, or W].
  float* scratch_u;
  uint8_t* scratch_sel;
  int32_t* status;
  // Shapes, the span [s, n_valid) of the block to run, its first index.
  int P, N, M, C1, A, K, S, B, W;
  int s, n_valid, i0;
  // Static configuration.
  int kinds, spawn_modes, shedder, fused, emit, stats;
  // Configuration constants, rounded to float32 by the wrapper.
  float c_base, c_match, c_ebl, c_shed_base, c_shed_pm;
  float latency_bound, safety_buffer, ebl_backlog_gain, ebl_decay;
  float ebl_floor, one_minus_floor;
};

namespace {

// ---------------------------------------------------------------------------
// Block-wide helpers (every thread calls them; each ends in a barrier so
// the buffer may be reused at once).
// ---------------------------------------------------------------------------

__device__ int block_sum(int v, int* wbuf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) wbuf[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int k = 0; k < kWarps; ++k) t += wbuf[k];
  __syncthreads();
  return t;
}

__device__ float block_min(float v, float* fbuf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) fbuf[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = fbuf[0];
  for (int k = 1; k < kWarps; ++k) t = fminf(t, fbuf[k]);
  __syncthreads();
  return t;
}

__device__ float block_max(float v, float* fbuf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) fbuf[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = fbuf[0];
  for (int k = 1; k < kWarps; ++k) t = fmaxf(t, fbuf[k]);
  __syncthreads();
  return t;
}

// Exclusive prefix sum of v over the threads in thread order.
__device__ int block_exclusive_scan(int v, int* wbuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wbuf[warp] = x;
  __syncthreads();
  int before = 0;
  for (int k = 0; k < warp; ++k) before += wbuf[k];
  __syncthreads();
  return before + x - v;
}

// ---------------------------------------------------------------------------
// Thread 0's scalar arithmetic (the port's host path, op by op).
// ---------------------------------------------------------------------------

__device__ float predict_latency(float a, float b, int kind, float n) {
  const float basis =
      kind == LINEAR ? n : __fmul_rn(n, log2f(__fadd_rn(n, 1.0f)));
  return __fmaf_rn(a, basis, b);
}

// f^{-1}: (l - b) / a for LINEAR; 16 Newton steps for NLOGN (log2f is not
// numpy's log2 to the bit, so NLOGN decisions are held to equal ρ only).
__device__ float invert_latency(float a, float b, int kind, float l) {
  const float t = fmaxf(__fdiv_rn(__fsub_rn(l, b), a), 0.0f);
  if (kind == LINEAR) return t;
  const float ln2 = 0.693147182464599609375f;   // float32 log(2)
  float n = fmaxf(t, 1.0f);
  for (int it = 0; it < 16; ++it) {
    const float lg = log2f(__fadd_rn(n, 1.0f));
    const float fn = __fsub_rn(__fmul_rn(n, lg), t);
    const float dfn =
        __fadd_rn(lg, __fdiv_rn(n, __fmul_rn(__fadd_rn(n, 1.0f), ln2)));
    n = fminf(fmaxf(__fsub_rn(n, __fdiv_rn(fn, fmaxf(dfn, 1e-9f))), 0.0f),
              1e12f);
  }
  return n;
}

// Algorithm 1: shed when l_q + f(n) + g(n) + b_s > LB; ρ = n - floor(
// f^{-1}(LB - l_q - g(n) - b_s) + 1e-4), saturated like XLA's cast.
__device__ void detect_overload(const BlockStepArgs& a, float fa, float fb,
                                int fk, float ga, float gb, int gk,
                                float l_q, int n_pm, bool* shed, int* rho) {
  const float n_f = __int2float_rn(n_pm);
  const float l_p = predict_latency(fa, fb, fk, n_f);
  const float l_s = predict_latency(ga, gb, gk, n_f);
  const float l_e = __fadd_rn(l_q, l_p);
  *shed = __fadd_rn(__fadd_rn(l_e, l_s), a.safety_buffer) > a.latency_bound;
  const float l_p_new = fmaxf(
      __fsub_rn(__fsub_rn(__fsub_rn(a.latency_bound, l_q), l_s),
                a.safety_buffer), 0.0f);
  const int n_keep = __float2int_rz(
      floorf(__fadd_rn(invert_latency(fa, fb, fk, l_p_new), 1e-4f)));
  *rho = *shed ? max(n_pm - n_keep, 0) : 0;
}

// t_proc = c_base + Σ_p cp_p·n_p in the reference's order for this P
// (engine._cost_sum): one FMA for P = 1; for P ∈ {4, 8, 8k} vector lanes
// of FMA chains and a halving tree; otherwise an FMA chain.
__device__ float cost_sum(const float* cp, const int* n, int P,
                          float c_base) {
  if (P == 1) return __fmaf_rn(cp[0], __int2float_rn(n[0]), c_base);
  if (P == 4 || P % 8 == 0) {
    const int vf = P < 8 ? P : 8;
    float lanes[8];
    for (int k = 0; k < vf; ++k) lanes[k] = __fmul_rn(cp[k], __int2float_rn(n[k]));
    for (int p = vf; p < P; ++p) {
      lanes[p % vf] = __fmaf_rn(cp[p], __int2float_rn(n[p]), lanes[p % vf]);
    }
    for (int h = vf / 2; h >= 1; h /= 2) {
      for (int k = 0; k < h; ++k) lanes[k] = __fadd_rn(lanes[k], lanes[k + h]);
    }
    return __fadd_rn(lanes[0], c_base);
  }
  float acc = __fmul_rn(cp[0], __int2float_rn(n[0]));
  for (int p = 1; p < P; ++p) acc = __fmaf_rn(cp[p], __int2float_rn(n[p]), acc);
  return __fadd_rn(acc, c_base);
}

// What thread 0 tells the block about the current event.
struct EventFlags {
  int stop;      // replay protocol: the event fires and is not committed
  int fire;      // fused protocol: Algorithm 2 runs on this event
  int dropped;   // E-BL dropped the event
  int need;      // PMs still to drop (threshold select)
  int kb;        // the select's bucket at this level
  int spawn_any; // some in-window candidate got a slot
  int32_t eid;
  uint32_t sub[2];
  float lo, hi;
};

// One CTA per SM at most: the register budget may go to thread 0's
// scalar state instead of occupancy no launch can use.
__global__ void __launch_bounds__(kThreads, 1)
block_step_kernel(const BlockStepArgs a) {
  extern __shared__ int smem[];
  __shared__ EventFlags ev;
  const int P = a.P, N = a.N, M = a.M, A = a.A, K = a.K;
  const int F = P * N;
  const int tid = threadIdx.x, T = blockDim.x;
  const bool pm_shedder = a.shedder == SHED_PSPICE || a.shedder == SHED_PMBL;
  const bool at_open_census = a.spawn_modes == CENSUS_AT_OPEN;

  int* n_act = smem;              // (P) active PMs per pattern
  int* n_exp = n_act + P;         // (P) expiries this event
  int* n_drop = n_exp + P;        // (P) PMs dropped by this event's shed
  int* n_cmp = n_drop + P;        // (P) completions this event
  int* ec = n_cmp + P;            // (P) event class
  int* eb = ec + P;               // (P) event binding
  int* eo = eb + P;               // (P) window-open flag
  int* lc = eo + P;               // (P) live class (0 when E-BL dropped)
  int* first_free = lc + P;       // (P) lowest inactive slot (at-open)
  int* n_take = first_free + P;   // (P) candidates that get a slot
  int* base = n_take + P;         // (P) free slots of earlier patterns
  int* exists = base + P;         // (P, K) a PM of this window is live
  int* take_rank = exists + P * K;  // (P, K) rank among free slots, or -1
  int* cand_open = take_rank + P * K;  // (P, K) open index of the spawn
  int* free_at = cand_open + P * K;    // (P, K) the r-th free slot
  int* hist = free_at + P * K;         // (kNbins)
  int* wbuf = hist + kNbins;           // (kWarps)
  float* edges = reinterpret_cast<float*>(wbuf + kWarps);  // (kNbins + 1)
  float* fbuf = edges + kNbins + 1;    // (kWarps)
  float* cp = fbuf + kWarps;           // (P) c_match · proc_cost

  // Thread 0's control state.
  float sim = 0.f, ema = 0.f, prev = 0.f, eblf = 0.f, ovf = 0.f, ebld = 0.f;
  float pshed = 0.f, scalls = 0.f, fa = 0.f, fb = 0.f, ga = 0.f, gb = 0.f;
  float mean_eff = 0.f;
  int fk = 0, gk = 0, nfire = 0, fire_idx = a.W;
  int32_t lat_ptr = 0;
  uint32_t key[2] = {0u, 0u};
  if (tid == 0) {
    sim = *a.sim_time; ema = *a.ema_gap; prev = *a.prev_arrival;
    eblf = *a.ebl_frac; ovf = *a.overflow; ebld = *a.ebl_dropped;
    pshed = *a.pms_shed; scalls = *a.shed_calls; lat_ptr = *a.lat_ptr;
    key[0] = static_cast<uint32_t>(a.key[0]);
    key[1] = static_cast<uint32_t>(a.key[1]);
    fa = *a.f_a; fb = *a.f_b; fk = *a.f_kind;
    ga = *a.g_a; gb = *a.g_b; gk = *a.g_kind;
    mean_eff = __fmaf_rn(a.one_minus_floor, *a.ebl_raw_mean, a.ebl_floor);
  }
  for (int p = tid; p < P; p += T) {
    n_act[p] = 0;
    cp[p] = __fmul_rn(a.c_match, a.proc_cost[p]);
  }
  __syncthreads();
  for (int f = tid; f < F; f += T) {
    if (a.active[f]) atomicAdd(&n_act[f / N], 1);
  }
  __syncthreads();

  for (int j = a.s; j < a.n_valid; ++j) {
    const int32_t i = repro::wrap_add(a.i0, j);
    // -- the event's row; per-event counters --------------------------------
    for (int p = tid; p < P; p += T) {
      ec[p] = a.ev_class[j * P + p];
      eb[p] = a.ev_bind[j * P + p];
      eo[p] = a.ev_open[j * P + p];
      n_exp[p] = 0;
      n_drop[p] = 0;
      n_cmp[p] = 0;
      first_free[p] = N;
    }
    for (int q = tid; q < P * K; q += T) exists[q] = 0;
    __syncthreads();
    // -- 1. count the windows that closed ----------------------------------
    for (int f = tid; f < F; f += T) {
      const int p = f / N;
      if (a.active[f] &&
          repro::wrap_sub(i, a.open_idx[f]) >= a.window_size[p]) {
        atomicAdd(&n_exp[p], 1);
      }
    }
    __syncthreads();
    // -- 2-3. thread 0: Algorithm 1, ring, E-BL, EMA ---------------------------
    int n_pm_i = 0;
    float arr = 0.f, l_q = 0.f;
    bool did_shed = false;
    if (tid == 0) {
      arr = a.arrival[j];
      for (int p = 0; p < P; ++p) n_pm_i += n_act[p] - n_exp[p];
      const float sim1 = fmaxf(sim, arr);
      l_q = __fsub_rn(sim1, arr);
      bool shed = false;
      int rho = 0;
      if (pm_shedder) {
        detect_overload(a, fa, fb, fk, ga, gb, gk, l_q, n_pm_i, &shed, &rho);
      }
      const bool fire = shed && rho > 0;
      ev.stop = fire && !a.fused;
      ev.fire = fire && a.fused;
      ev.eid = a.ev_id[j];
      if (ev.stop) {
        nfire = 1;
        fire_idx = j;
      } else {
        for (int p = 0; p < P; ++p) n_act[p] -= n_exp[p];
        if (!at_open_census) {
          for (int p = 0; p < P; ++p) {
            if (eo[p] && a.spawn_mode[p] == SPAWN_IN_WINDOWS) {
              const int rp = a.ring_ptr[p];
              if (rp >= 0 && rp < K) a.ring[p * K + rp] = i;
              a.ring_ptr[p] = repro::floor_mod(rp + 1, K);
            }
          }
        }
        sim = sim1;
        if (fire) {                  // fused Algorithm 2: key, sub = split
          uint32_t next[2], sub[2];
          repro::threefry_split(key, next, sub);
          key[0] = next[0]; key[1] = next[1];
          ev.sub[0] = sub[0]; ev.sub[1] = sub[1];
          ev.need = min(rho, n_pm_i);
          ++nfire;
          fire_idx = j;
          did_shed = true;
        }
        // E-BL input drop and the inter-arrival EMA.
        const float gap = fmaxf(__fsub_rn(arr, prev), 1e-9f);
        ema = __fmaf_rn(0.99f, ema, __fmul_rn(0.01f, gap));
        prev = arr;
        bool dropped = false;
        if (a.shedder == SHED_EBL) {
          bool shed_e = false;
          int rho_e = 0;
          detect_overload(a, fa, fb, fk, ga, gb, gk, l_q, n_pm_i, &shed_e,
                          &rho_e);
          const float l_p_est =
              predict_latency(fa, fb, fk, __int2float_rn(n_pm_i));
          const float d_ff =
              __fdiv_rn(__fsub_rn(l_p_est, ema),
                        fmaxf(__fsub_rn(l_p_est, a.c_ebl), 1e-9f));
          const float d_bk =
              __fdiv_rn(__fmul_rn(a.ebl_backlog_gain, l_q), a.latency_bound);
          const float d_need = fminf(fmaxf(__fadd_rn(d_ff, d_bk), 0.0f), 1.0f);
          const float decayed = __fmul_rn(eblf, a.ebl_decay);
          eblf = shed_e ? fmaxf(decayed, d_need) : decayed;
          const float raw_eff =
              __fmaf_rn(a.one_minus_floor, a.ebl_raw[j], a.ebl_floor);
          const float p_drop = fminf(
              fmaxf(__fdiv_rn(__fmul_rn(raw_eff, eblf), fmaxf(mean_eff, 1e-9f)),
                    0.0f), 1.0f);
          dropped = a.ev_rand[j] < p_drop;
          ebld = __fadd_rn(ebld, dropped ? 1.0f : 0.0f);
          did_shed = shed_e;
        }
        ev.dropped = dropped;
        for (int p = 0; p < P; ++p) lc[p] = dropped ? 0 : ec[p];
      }
    }
    __syncthreads();
    if (ev.stop) break;
    const bool fire = ev.fire;
    // -- commit the expiries; a fire's scores ------------------------------
    for (int f = tid; f < F; f += T) {
      const int p = f / N;
      bool act = a.active[f] != 0;
      if (act && repro::wrap_sub(i, a.open_idx[f]) >= a.window_size[p]) {
        a.active[f] = 0;
        act = false;
      }
      if (fire) {
        float u;
        if (a.shedder == SHED_PSPICE) {
          const int32_t r_w = repro::wrap_sub(
              a.window_size[p], repro::wrap_sub(i, a.open_idx[f]));
          u = act ? repro::utility_at(a.ut_tables, p, a.B, M, a.state[f],
                                      r_w, a.ut_bins[p])
                  : kBig;
        } else {
          u = repro::threefry_uniform(ev.sub, static_cast<uint32_t>(f));
        }
        a.scratch_u[f] = u;
        a.scratch_sel[f] = act ? 1 : 0;
      }
    }
    __syncthreads();
    // -- 2b. fused Algorithm 2: the histogram-threshold select --------------
    // core/shedder.py::threshold_drop_mask: three levels of 128 buckets
    // over the shared edges lo + ((hi - lo)·k)/128, then the leftover
    // budget by slot index.  sel: 1 = candidate, 2 = dropped, 0 = out.
    if (fire) {
      float mn = kBig, mx = -kBig;
      for (int f = tid; f < F; f += T) {
        if (a.scratch_sel[f]) {
          mn = fminf(mn, a.scratch_u[f]);
          mx = fmaxf(mx, a.scratch_u[f]);
        }
      }
      const float lo0 = block_min(mn, fbuf);
      const float hi0 = block_max(mx, fbuf);
      if (tid == 0) {
        ev.lo = lo0;
        ev.hi = hi0 > lo0 ? hi0 : __fadd_rn(lo0, 1.0f);
      }
      __syncthreads();
      for (int level = 0; level < 3; ++level) {
        const float lo = ev.lo, hi = ev.hi;
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
          if (a.scratch_sel[f] == 1) {
            const int b = repro::bucket_of(a.scratch_u[f], edges, kNbins);
            if (b >= 0) atomicAdd(&hist[b], 1);
          }
        }
        __syncthreads();
        if (tid == 0) {
          int cum = 0, kb = kNbins - 1;
          for (int b = 0; b < kNbins; ++b) {
            cum += hist[b];
            if (cum >= ev.need) { kb = b; break; }
          }
          ev.kb = kb;
        }
        __syncthreads();
        const int kb = ev.kb;
        const float edge = edges[kb], upper = edges[kb + 1];
        int below = 0;
        for (int f = tid; f < F; f += T) {
          if (a.scratch_sel[f] == 1) {
            const float u = a.scratch_u[f];
            if (u < edge) {
              a.scratch_sel[f] = 2;
              ++below;
            } else if (!(u < upper)) {
              a.scratch_sel[f] = 0;
            }
          }
        }
        below = block_sum(below, wbuf);
        if (tid == 0) {
          ev.need = max(ev.need - below, 0);
          const float hi_next = kb == kNbins - 1 ? hi : upper;
          ev.lo = edge;
          ev.hi = hi_next > edge ? hi_next : __fadd_rn(edge, 1.0f);
        }
        __syncthreads();
      }
      // The remaining budget: the lowest-index candidates.
      const int chunk = (F + T - 1) / T;
      const int f0 = min(tid * chunk, F), f1 = min(f0 + chunk, F);
      int c = 0;
      for (int f = f0; f < f1; ++f) c += a.scratch_sel[f] == 1;
      int r = block_exclusive_scan(c, wbuf);
      const int need = ev.need;
      for (int f = f0; f < f1; ++f) {
        if (a.scratch_sel[f] == 1) {
          if (r < need) a.scratch_sel[f] = 2;
          ++r;
        }
      }
      __syncthreads();
      for (int f = tid; f < F; f += T) {
        if (a.scratch_sel[f] == 2) {
          a.active[f] = 0;
          atomicAdd(&n_drop[f / N], 1);
        }
      }
      __syncthreads();
      if (tid == 0) {
        int dropped_pms = 0;
        for (int p = 0; p < P; ++p) {
          n_act[p] -= n_drop[p];
          dropped_pms += n_drop[p];
        }
        pshed = __fadd_rn(pshed, __int2float_rn(dropped_pms));
        scalls = __fadd_rn(scalls, 1.0f);
        sim = __fadd_rn(sim, __fmaf_rn(a.c_shed_pm, __int2float_rn(n_pm_i),
                                       a.c_shed_base));
      }
    }
    // -- 4. advance, completions, match tiles, stats; spawn probes ----------
    const bool dropped = ev.dropped;
    const int32_t eid = ev.eid;
    for (int f = tid; f < F; f += T) {
      const int p = f / N;
      const bool act = a.active[f] != 0;
      bool completed = false;
      if (act) {
        const int32_t s = a.state[f], fin = a.final_state[p];
        const bool bind_ok = !a.uses_binding[p] || a.bind[f] == eb[p];
        const bool seq = a.kinds == CENSUS_SEQ ||
                         (a.kinds != CENSUS_ANY && a.kind[p] == KIND_SEQ);
        int32_t nxt;
        if (seq) {
          nxt = repro::nfa_next(a.trans, p, s, ec[p], M, a.C1,
                                bind_ok && !dropped);
        } else {
          int32_t* ids = a.idset + static_cast<int64_t>(f) * A;
          bool in_set = false;
          for (int q = 0; q < A; ++q) in_set |= ids[q] == eid;
          const bool match = bind_ok && lc[p] == 1 && !in_set && s < fin;
          nxt = s + (match ? 1 : 0);
          if (match) {
            const int slot = min(max(s - 1 + (a.spawn_counts[p] ? 1 : 0), 0),
                                 A - 1);
            ids[slot] = eid;
          }
        }
        completed = nxt == fin && s != fin;
        a.state[f] = nxt;
        if (a.stats) {
          // Within one event every addend to one (p, s, s') cell is the
          // same value (1, or c_match·proc[p]), so the float atomics give
          // the sequential scatter-add's bits in any order.
          const int64_t cell = (static_cast<int64_t>(p) * M + s) * M + nxt;
          atomicAdd(&a.obs_counts[cell], 1.0f);
          atomicAdd(&a.obs_rewards[cell], cp[p]);
        }
        if (completed) {
          a.active[f] = 0;
          atomicAdd(&n_cmp[p], 1);
        }
      }
      if (a.emit) {
        const int64_t at = static_cast<int64_t>(j) * F + f;
        a.m_open[at] = completed ? a.open_idx[f] : -1;
        a.m_bind[at] = completed ? a.bind[f] : -1;
      }
      if (!(act && !completed)) {
        if (at_open_census) atomicMin(&first_free[p], f - p * N);
      } else if (!at_open_census) {
        const int32_t o = a.open_idx[f];
        if (a.bind[f] == eb[p]) {
          for (int k = 0; k < K; ++k) {
            if (o == a.ring[p * K + k]) exists[p * K + k] = 1;
          }
        }
      }
    }
    __syncthreads();
    // -- 5. spawn candidates, ranks and overflow; 7. time (thread 0) ---------
    float t_proc = 0.f;
    if (tid == 0) {
      // t_proc counts the PMs the event was matched against: the counts
      // after the shed and before the completions.
      t_proc = dropped ? a.c_ebl : cost_sum(cp, n_act, P, a.c_base);
      int novf = 0, spawn_any = 0, free_before = 0;
      for (int p = 0; p < P; ++p) {
        n_act[p] -= n_cmp[p];
        a.complex_count[p] =
            __fadd_rn(a.complex_count[p], __int2float_rn(n_cmp[p]));
        const int n_free = N - n_act[p];
        base[p] = free_before;
        free_before += n_free;
        const bool lo_p = eo[p] && !dropped;
        if (at_open_census) {
          // Every pattern spawns at open: one candidate, the lowest free slot.
          const bool can = lo_p && n_free > 0;
          novf += lo_p && !can;
          n_take[p] = can ? 1 : 0;
          take_rank[p * K] = can ? 0 : -1;
          free_at[p * K] = first_free[p];
          cand_open[p * K] = i;
          for (int k = 1; k < K; ++k) take_rank[p * K + k] = -1;
          continue;
        }
        const bool p_at_open = a.spawn_mode[p] == SPAWN_AT_OPEN;
        int r = 0;
        for (int k = 0; k < K; ++k) {
          const int q = p * K + k;
          const int32_t w = a.ring[q];
          const bool win = w >= 0 && repro::wrap_sub(i, w) < a.window_size[p] &&
                           !exists[q] && lc[p] == 1 && !p_at_open;
          const bool open_sp = p_at_open && lo_p && k == 0;
          const bool cand = a.spawn_modes == CENSUS_IN_WINDOWS ? win
                                                               : (win || open_sp);
          cand_open[q] = (a.spawn_modes != CENSUS_IN_WINDOWS && p_at_open) ? i : w;
          take_rank[q] = -1;
          if (cand) {
            if (r < n_free) take_rank[q] = r; else ++novf;
            ++r;
          }
        }
        n_take[p] = min(r, n_free);
        spawn_any |= n_take[p] > 0;
      }
      ovf = __fadd_rn(ovf, __int2float_rn(novf));
      ev.spawn_any = spawn_any;
    }
    __syncthreads();
    // -- 5b. in-window spawns: the r-th lowest free slot of each pattern ----
    if (!at_open_census && ev.spawn_any) {
      const int chunk = (F + T - 1) / T;
      const int f0 = min(tid * chunk, F), f1 = min(f0 + chunk, F);
      int c = 0;
      for (int f = f0; f < f1; ++f) c += !a.active[f];
      int g = block_exclusive_scan(c, wbuf);
      for (int f = f0; f < f1; ++f) {
        if (!a.active[f]) {
          const int p = f / N, r = g - base[p];
          if (r < n_take[p]) free_at[p * K + r] = f - p * N;
          ++g;
        }
      }
      __syncthreads();
    }
    // -- 5c. write the spawned PMs ------------------------------------------
    for (int q = tid; q < P * K; q += T) {
      const int r = take_rank[q];
      if (r < 0) continue;
      const int p = q / K;
      const int f = p * N + free_at[p * K + r];
      a.active[f] = 1;
      a.state[f] = 1;
      a.open_idx[f] = cand_open[q];
      a.bind[f] = eb[p];
      if (a.kinds != CENSUS_SEQ) {
        int32_t* ids = a.idset + static_cast<int64_t>(f) * A;
        ids[0] = a.spawn_counts[p] ? eid : -1;
        for (int k = 1; k < A; ++k) ids[k] = -1;
      }
    }
    // -- 7. simulated time, latency ring, the StepOut row (thread 0) ---------
    if (tid == 0) {
      int n_after = 0;
      for (int p = 0; p < P; ++p) {
        a.pms_created[p] =
            __fadd_rn(a.pms_created[p], __int2float_rn(n_take[p]));
        n_act[p] += n_take[p];
        n_after += n_act[p];
      }
      sim = __fadd_rn(sim, t_proc);
      const int ptr = repro::floor_mod(lat_ptr, a.S);
      a.lat_n[ptr] = __int2float_rn(n_pm_i);
      a.lat_l[ptr] = t_proc;
      lat_ptr = repro::wrap_add(lat_ptr, 1);
      a.l_e[j] = __fsub_rn(sim, arr);
      a.n_pm[j] = __int2float_rn(n_after);
      a.shed[j] = did_shed ? 1 : 0;
      a.dropped[j] = dropped ? 1 : 0;
    }
    __syncthreads();
  }

  if (tid == 0) {
    *a.sim_time = sim; *a.ema_gap = ema; *a.prev_arrival = prev;
    *a.ebl_frac = eblf; *a.overflow = ovf; *a.ebl_dropped = ebld;
    *a.pms_shed = pshed; *a.shed_calls = scalls; *a.lat_ptr = lat_ptr;
    a.key[0] = static_cast<int32_t>(key[0]);
    a.key[1] = static_cast<int32_t>(key[1]);
    a.status[0] = nfire;
    a.status[1] = fire_idx;
  }
}

// The generator alone, for the tests: key, sub = split(key) and the n
// uniforms jax.random.uniform(sub, (n,)) draws.
__global__ void threefry_probe_kernel(const int32_t* __restrict__ key, int n,
                                      int32_t* __restrict__ keys_out,
                                      float* __restrict__ u_out) {
  const uint32_t k[2] = {static_cast<uint32_t>(key[0]),
                         static_cast<uint32_t>(key[1])};
  uint32_t next[2], sub[2];
  repro::threefry_split(k, next, sub);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) {
    keys_out[0] = static_cast<int32_t>(next[0]);
    keys_out[1] = static_cast<int32_t>(next[1]);
    keys_out[2] = static_cast<int32_t>(sub[0]);
    keys_out[3] = static_cast<int32_t>(sub[1]);
  }
  for (int e = t; e < n; e += gridDim.x * blockDim.x) {
    u_out[e] = repro::threefry_uniform(sub, static_cast<uint32_t>(e));
  }
}

}  // namespace

extern "C" int block_step_launch(const BlockStepArgs* args, void* stream) {
  const BlockStepArgs& a = *args;
  if (a.P < 1 || a.N < 1 || a.M < 1 || a.A < 1 || a.K < 1 || a.S < 1 ||
      a.W < 1 || a.s < 0 || a.n_valid > a.W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * (12 * a.P + 4 * a.P * a.K + kNbins +
                                     kWarps) +
                      sizeof(float) * (kNbins + 1 + kWarps + a.P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  block_step_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_probe_launch(const void* key, int n, void* keys_out,
                                     void* u_out, void* stream) {
  const int blocks = n > 0 ? (n + 255) / 256 < 132 ? (n + 255) / 256 : 132 : 1;
  threefry_probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), n, static_cast<int32_t*>(keys_out),
      static_cast<float*>(u_out));
  return static_cast<int>(cudaGetLastError());
}
