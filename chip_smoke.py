#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as on the H100
    python3 chip_smoke.py --phases card,build,kernels

Phases (one line each; any failure raises and exits non-zero):
  card     the GPU's name and power limit, torch/CUDA versions; TF32 off
  build    compiles repro_torch/csrc with nvcc (sm_90a) and loads it
  kernels  each per-event CUDA kernel against its plain PyTorch version,
           bitwise, at the stock shapes (P=3, N=256), at N=2048 and at a
           ragged N=1000, plus an all-inactive and a NaN-laden case; the
           block kernel against its plain version, bitwise, on W=32
           blocks that fire Algorithm 2 (stock SEQ/at-open at N=256 and
           N=2048, bus ANY/in-windows, soccer ANY/at-open with E-BL, all
           with the store in shared memory; soccer at N=2048 under PM-BL
           with the store in device memory; two of them again with the
           event rows, model tables and stats counts in device memory;
           the PM-BL cases again in jax's original threefry layout, and
           the kernel's threefry against repro_torch.prng in both
           layouts); its lane instance (one CTA per lane) at L = 3 on
           every block case, each lane equal to the plain version and to
           the one-lane kernel on that lane; times against the memory
           bound, and the launch path's host time per launch; the
           histogram's lane instance at L = 1, 3, 128 against its plain
           version and the one-lane kernel row by row, the lookup over
           128 lanes' pattern rows, and the launch floor (an empty kernel
           launched back to back)
  parity   the engine on stock specs, N=2048, 3000 events, all four
           shedders with fires: backends "cuda" and "cuda_block" on the
           card == backend "torch" on the card == backend "torch" on the
           CPU, whole carry and every StepOut, bitwise
  main     run_experiment on the stock scenario at its full 30000 events
           and on soccer and bus at 12000, first through the per-event
           kernels (backend "cuda"), then through the block kernel
           (backend "cuda_block"), with the launch counts of each path's
           kernels; the headline FN ordering, stock's pspice and E-BL
           cells exactly the committed BENCH_quality.json values (both
           are independent of the threefry layout), and FN, fires and
           compliance equal across the two paths
  quality  in jax's original threefry layout (the committed results'):
           the oracle's overload fixture and a layout-sensitive stream
           through "cuda" and "cuda_block" == the NumPy oracle, in both
           layouts; the paper's grid ({stock, soccer, bus} x {1.2, 1.4,
           1.6} x 3 shedders at 30000 events) on "cuda_block", gated by
           check_headline, with stock at 1.2 exactly the committed file
           and every other cell within 0.05 of it; "cuda" == "cuda_block"
           at the headline level on every dataset; the wall of stock's
           run_experiment split by layer
  runtime  the multi-tenant streaming runtime: 128 lanes of the stock
           configuration (30000 events each, rates 1.2..1.4 x max_rate,
           one model from lane 0's warm-up) through MultiTenantRuntime on
           "cuda_block" (one launch of the block kernel's lane instance,
           128 CTAs, per 32-event block, no host sync) against 128
           sequential run_engine calls, every lane's carry bitwise equal;
           events/s, speedup, launches, peak memory; the lane grid's time
           per launch at L = 1, 8, 128 against its byte bound; the refresh
           demo (8 drifting lanes, refresh every 4 chunks), each lane
           equal to StreamRuntime on that lane alone
  resilience  the runtime's resilience layer (bench_faults' counterpart):
           the fault matrix (clean, each stream and state fault alone,
           all faults) through StreamRuntime on "cuda_block" with ingest,
           ladder, guard and refresh on stock's configuration, 30000
           events, gated as bench_faults (no exception, finite state, a
           clean guard sweep, every decision mirrored in telemetry,
           completions >= 2 % of clean), clean and all faults also on
           "cuda" with an equal carry sha256 and counters; resilience off
           == one monolithic run_engine on both paths, configured and
           never triggered == off (one stream, and 128 lanes with both
           runs' events/s); 128 lanes under lane faults (only the
           poisoned lanes restored, every other lane bitwise its run
           without faults) and under a ladder that trims (the trim over
           lanes: one lookup launch and one launch of the histogram's lane
           instance per level, equal to its plain version and to one-lane
           trims, lane by lane; its time against lane by lane)
  recovery durable recovery (bench_recovery's counterpart): the
           supervisor's children on the card (N = 256, W = 32, 30000
           events, chunk 1024, snapshot every 4 chunks) SIGKILLed at the
           reference grid's kill sites on cuda_block x {none, pspice,
           pmbl, ebl} and cuda/pspice, relaunched, and bitwise equal to
           the uninterrupted run (carry sha256, matches, counters,
           events; a torn snapshot rejected where the kill tore one);
           then 128 stock lanes snapshot, abandoned mid-push and
           recovered in process, every lane equal to the uninterrupted
           run, with snapshot bytes, write and recovery times, WAL
           records replayed and WAL append time per push
  profile  torch.profiler over one stock pspice run per path: device
           busy time by kernel and the device's idle share; on the block
           path also the host's time per launch (the enqueue alone)
  model    the model zoo's serving path at internlm2-1.8b's full width
           and depth (bf16, random weights from a seeded generator):
           prefill of 4 prompts of 2048 tokens (the flash kernel in each
           of the 24 layers) and 32 greedy decode steps, checked against
           the plain flash and the full forward, with a planted fault
           that the float32 bound must catch; then the port's serve()
           with the reference CLI's defaults under each policy, all at
           the step cost the first run measures
The build phase reports ptxas's registers and spills of the block
kernel's two instantiations and of the bf16 flash kernel (a spill in the
flash kernel fails it).  The kernels phase also runs the wgmma probe
against torch.matmul, holds the flash kernels against their plain version
(float32 on the SIMT kernel, bf16 on the wgmma/TMA kernel; GQA/MQA,
ragged, Dv != D, decode-style, a fully masked KV tile; bf16 also row by
row, scaled to the output, with planted faults that this bar must catch)
and times the bf16 kernel at the prefill shape in turns with
scaled_dot_product_attention.
The last lines are the kernels' JSON record, the nvidia-smi line and the
contract line.  The script needs CUDA and the repository around it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PHASES = ("card", "build", "kernels", "parity", "main", "quality", "runtime",
          "resilience", "recovery", "profile", "model")

# The committed quality grid (made by the reference in jax's original
# threefry layout), read as data.  Stock at the headline level must be
# met exactly; every other cell within GRID_TOL of its match-set FN: the
# port's max_rate equals the reference's run on the CPU (jax 0.9.0), but
# there the reference's soccer and bus max_rate differ from the file's
# (made with jax 0.4.37), and a max_rate that differs in its last bits
# shifts a whole cell's arrivals.
COMMITTED_QUALITY = ROOT / "BENCH_quality.json"
GRID_TOL = 0.05
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate
# H100 SXM dense peaks: bf16 tensor cores, float32 outside them.
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

KERNEL_META = {
    "nfa_advance": ("src/repro_torch/csrc/nfa_transition.cu",
                    "src/repro/kernels/nfa_transition.py:26"),
    "utility_lookup": ("src/repro_torch/csrc/shed_select.cu",
                       "src/repro/kernels/shed_select.py:38"),
    "utility_histogram": ("src/repro_torch/csrc/shed_select.cu",
                          "src/repro/kernels/shed_select.py:115"),
    # Its lane instance: the histogram vmapped over tenant lanes by the
    # ladder's PM trim (src/repro/runtime/guard.py:116), grid y = lane.
    "utility_histogram_lanes": ("src/repro_torch/csrc/shed_select.cu",
                                "src/repro/kernels/shed_select.py:115"),
    "block_step": ("src/repro_torch/csrc/block_step.cu",
                   "src/repro/kernels/block_step.py:87"),
    # The lane instance: the same kernel vmapped over tenant lanes
    # (src/repro/cep/engine.py:877), one CTA per lane.
    "block_step_lanes": ("src/repro_torch/csrc/block_step.cu",
                         "src/repro/kernels/block_step.py:87"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention.py:29"),
}
# The path whose run counts each kernel's launches: an engine backend of
# the main phase, or the model phase's prefill and decode.
KERNEL_PATH = {"nfa_advance": "cuda", "utility_lookup": "cuda",
               "utility_histogram": "cuda", "block_step": "cuda_block",
               "block_step_lanes": "runtime",
               "utility_histogram_lanes": "resilience",
               "flash_attention": "model"}
W_BLOCK = 32                       # block_events on the block path


def paper_cost() -> dict:
    """The paper's simulated-time costs (the port's pspice_paper)."""
    from repro_torch.configs.pspice_paper import COST
    return COST


def committed_quality() -> dict:
    return json.loads(COMMITTED_QUALITY.read_text())


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 200) -> float:
    """Mean device time of ``fn`` (CUDA events around ``iters`` calls)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(torch, fn, kernel: str, iters: int = 100):
    """Device time per call of the CUDA kernel whose name contains
    ``kernel`` (torch.profiler), or None if the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(k, "self_device_time_total",
                        getattr(k, "self_cuda_time_total", 0))
                for k in prof.key_averages() if kernel in k.key)
    return total / iters if total else None


def device_rows(prof) -> list:
    """(device us, calls, name) of every device-side event of a profile
    (kernels, copies, memsets), heaviest first.  The host ops that
    launched them are left out: their device time is their kernels'
    time, and counting both would count it twice."""
    from torch.autograd import DeviceType
    rows = [(getattr(k, "self_device_time_total",
                     getattr(k, "self_cuda_time_total", 0)), k.count, k.key)
            for k in prof.key_averages() if k.device_type != DeviceType.CPU]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def same(torch, a, b) -> bool:
    """Bitwise equality, NaN equal to NaN (payloads may differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb)) and bool(
            torch.equal(a[~na], b[~nb]))
    return bool(torch.equal(a, b))


def max_abs_err(torch, a, b) -> float:
    """max |a - b| over all elements: NaN against NaN counts 0, NaN
    against a number counts inf."""
    a, b = a.double(), b.double()
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return float("inf")
    d = torch.where(a == b, 0.0, (a - b).abs())[~na]
    return float(d.max()) if d.numel() else 0.0


def bound_bytes(torch, c, nbins: int) -> dict:
    """Bytes each kernel must move on the inputs ``c``: each element it
    reads counted once, each output once.  What it reads depends on the
    data, so it is counted from this data, not the most it could read."""
    state, active, uses = c["state"], c["active"], c["uses"]
    P, N = state.shape
    _, M, C1 = c["trans"].shape
    B = c["tables"].shape[1]
    pidx = torch.arange(P, device=state.device)[:, None].expand(P, N)
    n_pm, n_bind = P * N, int(uses.sum())
    # nfa_advance: state and active in, next state and completion flag out
    # for every PM; bind only for the PMs of binding patterns; one table
    # entry per distinct (pattern, state) that a live, binding-matched PM
    # gathers; per pattern its class, final state, binding flag and, for
    # binding patterns, the event's binding.
    cls = c["ev_class"][:, None]
    gathers = active & (~uses[:, None] | (c["bind"] == c["ev_bind"][:, None])
                        ) & (state >= 0) & (state < M) & (cls >= 0) & \
        (cls < C1)
    n_col = int(torch.unique(pidx[gathers] * M + state[gathers]).numel())
    nfa = n_pm * (4 + 1 + 4 + 1) + n_bind * N * 4 + n_col * 4 + \
        P * (4 + 4 + 1) + n_bind * 4
    # utility_lookup: active in and utility out for every PM; state and r_w
    # only for active PMs; the distinct table entries (j0 and j1 rows) the
    # active PMs read; each pattern's bin size.
    bs = c["bins"].float()[:, None].expand(P, N)
    pos = (c["r_w"].float() / bs - 1.0).clamp(0.0, float(B - 1))
    j0 = pos.floor().long()
    j1 = (j0 + 1).clamp(max=B - 1)
    live = active & (state >= 0) & (state < M)
    entries = torch.cat([(pidx[live] * B + j[live]) * M + state[live]
                         for j in (j0, j1)])
    n_act = int(active.sum())
    lookup = n_pm * (1 + 4) + n_act * (4 + 4) + \
        int(torch.unique(entries).numel()) * 4 + P * 4
    # utility_histogram: every utility in, the edges in, the counts out.
    hist = c["u"].numel() * 4 + (nbins + 1) * 4 + nbins * 4
    return {"nfa_advance": nfa, "utility_lookup": lookup,
            "utility_histogram": hist}


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(np, P, N, M, C1, B, seed):
    """Seeded inputs of the three kernels at one (P, N)."""
    rng = np.random.default_rng(seed)
    state = rng.integers(0, M, (P, N)).astype(np.int32)
    bind = rng.integers(-1, 3, (P, N)).astype(np.int32)
    active = rng.random((P, N)) < 0.6
    trans = rng.integers(0, M, (P, M, C1)).astype(np.int32)
    ev_class = rng.integers(0, C1, P).astype(np.int32)
    ev_bind = rng.integers(-1, 3, P).astype(np.int32)
    final = np.full(P, M - 1, np.int32)
    uses = np.arange(P) % 2 == 0
    tables = rng.random((P, B, M)).astype(np.float32)
    bins = np.full(P, 64, np.int32)
    r_w = rng.integers(-64, B * 64 + 64, (P, N)).astype(np.int32)
    u = np.where(active.reshape(-1), rng.random(P * N), np.nan
                 ).astype(np.float32)
    return dict(state=state, bind=bind, active=active, trans=trans,
                ev_class=ev_class, ev_bind=ev_bind, final=final, uses=uses,
                tables=tables, bins=bins, r_w=r_w, u=u)


def phase_kernels(torch, np) -> dict:
    from repro_torch.core.shedder import bucket_edges
    from repro_torch.kernels import nfa_transition as kn
    from repro_torch.kernels import shed_select as ks

    dev = torch.device("cuda")
    torch.manual_seed(0)
    P, M, C1, B = 3, 11, 11, 38          # the stock scenario's shapes
    record = {}
    errs = dict.fromkeys(("nfa_advance", "utility_lookup",
                          "utility_histogram"), 0.0)
    for N in (256, 2048, 1000):
        d = {k: torch.from_numpy(v).to(dev)
             for k, v in kernel_cases(np, P, N, M, C1, B, N).items()}
        cases = {"random": d,
                 "all_inactive": dict(d, active=torch.zeros_like(d["active"]),
                                      u=torch.full_like(d["u"], float("nan"))),
                 "nan_laden": dict(d, tables=torch.where(
                     torch.rand_like(d["tables"]) < 0.3,
                     torch.full_like(d["tables"], float("nan")), d["tables"]),
                     u=torch.where(torch.rand_like(d["u"]) < 0.5,
                                   torch.full_like(d["u"], float("nan")),
                                   d["u"]))}
        for case, c in cases.items():
            nfa_args = (c["state"], c["bind"], c["active"], c["trans"],
                        c["ev_class"], c["ev_bind"], c["final"], c["uses"])
            got = kn.nfa_advance(*nfa_args)
            want = kn.nfa_advance_plain(*nfa_args)
            lk_args = (c["state"], c["r_w"], c["active"], c["tables"],
                       c["bins"])
            u_k = ks.utility_lookup(*lk_args)
            u_p = ks.utility_lookup_plain(*lk_args)
            uu = c["u"]
            fin = uu[~torch.isnan(uu)]
            lo = fin.min() if fin.numel() else torch.tensor(0.0, device=dev)
            hi = fin.max() if fin.numel() else torch.tensor(1.0, device=dev)
            hi = torch.where(hi > lo, hi, lo + 1.0)
            edges = bucket_edges(lo, hi, 128)
            h_k = ks.utility_histogram_edges(uu, edges)
            h_p = ks.utility_histogram_plain(uu, edges)
            torch.cuda.synchronize()
            ok = {"nfa_advance": same(torch, got[0], want[0]) and
                  same(torch, got[1], want[1]),
                  "utility_lookup": same(torch, u_k, u_p),
                  "utility_histogram": same(torch, h_k, h_p)}
            if not all(ok.values()):
                raise AssertionError(f"kernel != plain at N={N} {case}: {ok}")
            for name, pairs in (
                    ("nfa_advance", ((got[0], want[0]), (got[1], want[1]))),
                    ("utility_lookup", ((u_k, u_p),)),
                    ("utility_histogram", ((h_k, h_p),))):
                for a, b in pairs:
                    errs[name] = max(errs[name], max_abs_err(torch, a, b))
            if case == "random":
                bytes_ = bound_bytes(torch, c, 128)
                times = {
                    "nfa_advance": (cuda_ms(torch, lambda: kn.nfa_advance(
                        *nfa_args)), cuda_ms(torch, lambda: kn.
                                             nfa_advance_plain(*nfa_args))),
                    "utility_lookup": (cuda_ms(torch, lambda: ks.
                                               utility_lookup(*lk_args)),
                                       cuda_ms(torch, lambda: ks.
                                               utility_lookup_plain(
                                                   *lk_args))),
                    "utility_histogram": (
                        cuda_ms(torch, lambda: ks.utility_histogram_edges(
                            uu, edges)),
                        cuda_ms(torch, lambda: ks.utility_histogram_plain(
                            uu, edges))),
                }
                dev_us = {
                    "nfa_advance": device_us(torch, lambda: kn.nfa_advance(
                        *nfa_args), "nfa_advance_kernel"),
                    "utility_lookup": device_us(torch, lambda: ks.
                                                utility_lookup(*lk_args),
                                                "utility_lookup_kernel"),
                    "utility_histogram": device_us(
                        torch, lambda: ks.utility_histogram_edges(uu, edges),
                        "utility_histogram_kernel"),
                }
                for name, (k_ms, p_ms) in times.items():
                    bound = bytes_[name] / HBM_BYTES_PER_S * 1e3
                    d_us = "not measured" if dev_us[name] is None else \
                        f"{dev_us[name]:.3f} us"
                    log("kernels", f"{name} P={P} N={N}: bitwise ok "
                        f"(random, all_inactive, nan_laden); kernel "
                        f"{k_ms:.6f} ms per call (device-only {d_us}), "
                        f"plain {p_ms:.6f} ms, library none, bound "
                        f"{bound:.6f} ms ({bytes_[name]} B at 3.35 TB/s)")
                    if N == 256:     # the stock main path's shape
                        record[name] = dict(ms=k_ms, plain_ms=p_ms,
                                            bound_ms=bound,
                                            device_us=dev_us[name])
    for name, err in errs.items():
        record[name]["max_abs_err"] = err
        log("kernels", f"{name}: max |kernel - plain| {err!r} over every "
            "case and N")
    record["utility_histogram_lanes"] = phase_hist_lanes(torch, np)
    record["utility_lookup"].update(lookup_over_lanes(torch, np))
    record["nfa_advance"].update(launch_floor(torch))
    record["block_step"] = phase_block_kernel(torch, np)
    record["block_step_lanes"] = phase_block_lanes(torch, np)
    record["flash_attention"] = phase_flash_kernel(torch, np)
    return record


def phase_hist_lanes(torch, np) -> dict:
    """The histogram's lane instance (grid y = lane) against its plain
    version and, row by row, the one-lane kernel, at L = 1, 3 and 128 on
    the ladder's trim shape (P·N = 3 x 256 utilities per lane, 128 bins,
    a third of them NaN); timed at L = 128."""
    from repro_torch.core.shedder import bucket_edges
    from repro_torch.kernels import shed_select as ks

    dev = torch.device("cuda")
    n, nbins = 3 * 256, 128
    err, out = 0.0, {}
    for L in (1, 3, RT_LANES):
        rng = np.random.default_rng(L)
        u = rng.random((L, n)).astype(np.float32)
        u[rng.random((L, n)) < 1 / 3] = np.nan
        u = torch.from_numpy(u).to(dev)
        lo = torch.nan_to_num(u, nan=2.0).amin(1)
        hi = torch.nan_to_num(u, nan=-1.0).amax(1)
        edges = bucket_edges(lo, torch.where(hi > lo, hi, lo + 1.0), nbins)
        got = ks.utility_histogram_lanes(u, edges)
        want = ks.utility_histogram_lanes_plain(u, edges)
        rows = torch.stack([ks.utility_histogram_edges(u[k], edges[k])
                            for k in range(L)])
        torch.cuda.synchronize()
        if not (same(torch, got, want) and same(torch, got, rows)):
            raise AssertionError(f"utility_histogram_lanes L={L} != plain "
                                 "or the one-lane kernel")
        err = max(err, max_abs_err(torch, got, want))
        if L == RT_LANES:
            k_ms = cuda_ms(torch, lambda: ks.utility_histogram_lanes(
                u, edges))
            p_ms = cuda_ms(torch, lambda: ks.utility_histogram_lanes_plain(
                u, edges), iters=20)
            d_us = device_us(torch, lambda: ks.utility_histogram_lanes(
                u, edges), "utility_histogram_kernel")
            nbytes = L * n * 4 + L * (nbins + 1) * 4 + L * nbins * 4
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            d_txt = "not measured" if d_us is None else f"{d_us:.3f} us"
            log("kernels", f"utility_histogram_lanes L={L} n={n} "
                f"nbins={nbins}: kernel {k_ms:.6f} ms per call (device-only "
                f"{d_txt}), plain {p_ms:.6f} ms, library none, bound "
                f"{bound:.6f} ms ({nbytes} B at 3.35 TB/s)")
            out = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                       device_us=d_us, lanes=L)
    log("kernels", f"utility_histogram_lanes at L = 1, 3, {RT_LANES}: equal "
        f"to its plain version and to the one-lane kernel row by row, max "
        f"|kernel - plain| {err!r}")
    out["max_abs_err"] = err
    return out


def lookup_over_lanes(torch, np) -> dict:
    """The lookup over L·P pattern rows laid end to end (the trim over
    128 stock lanes: 384 rows of N = 256), one launch, against its plain
    version."""
    from repro_torch.kernels import shed_select as ks

    dev = torch.device("cuda")
    P, N, M, C1, B = 3 * RT_LANES, 256, 11, 11, 38
    c = {k: torch.from_numpy(v).to(dev)
         for k, v in kernel_cases(np, P, N, M, C1, B, 7).items()}
    args = (c["state"], c["r_w"], c["active"], c["tables"], c["bins"])
    got, want = ks.utility_lookup(*args), ks.utility_lookup_plain(*args)
    torch.cuda.synchronize()
    if not same(torch, got, want):
        raise AssertionError("utility_lookup over L·P rows != plain")
    k_ms = cuda_ms(torch, lambda: ks.utility_lookup(*args))
    p_ms = cuda_ms(torch, lambda: ks.utility_lookup_plain(*args), iters=20)
    d_us = device_us(torch, lambda: ks.utility_lookup(*args),
                     "utility_lookup_kernel")
    nbytes = bound_bytes(torch, c, 128)["utility_lookup"]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    d_txt = "not measured" if d_us is None else f"{d_us:.3f} us"
    log("kernels", f"utility_lookup over {RT_LANES} lanes' pattern rows "
        f"(P={P}, N={N}): bitwise ok; kernel {k_ms:.6f} ms per call "
        f"(device-only {d_txt}), plain {p_ms:.6f} ms, bound {bound:.6f} ms "
        f"({nbytes} B at 3.35 TB/s)")
    return dict(lanes_ms=k_ms, lanes_plain_ms=p_ms, lanes_bound_ms=bound,
                lanes_device_us=d_us)


def launch_floor(torch) -> dict:
    """The card's launch floor: an empty kernel launched back to back
    (10 x 1 000 launches from one host loop), as CUDA events per launch
    and as the profiler's device time per launch."""
    from repro_torch.kernels import nfa_transition as kn

    dev = torch.device("cuda")
    per = 1000
    ms = cuda_ms(torch, lambda: kn.empty_kernels(per, dev), iters=10) / per
    d_us = device_us(torch, lambda: kn.empty_kernels(100, dev),
                     "empty_kernel", iters=10)
    d_us = None if d_us is None else d_us / 100
    d_txt = "not measured" if d_us is None else f"{d_us:.3f} us"
    log("kernels", f"launch floor: an empty kernel launched back to back "
        f"takes {ms * 1e3:.3f} us per launch (CUDA events) and {d_txt} of "
        "device time per launch (profiler)")
    return dict(launch_floor_us=ms * 1e3, launch_floor_device_us=d_us)


# ---------------------------------------------------------------------------
# The block kernel against its plain version
# ---------------------------------------------------------------------------

def carry_leaves(carry):
    return list(carry.pms) + [v for k, v in carry._asdict().items()
                              if k != "pms"]


def block_bytes(torch, cfg, model, carry, blk, i0: int) -> int:
    """Bytes one block step must move on this block: each element it reads
    counted once, each output once.  What it reads depends on the data, so
    ``carry`` (a copy; it is advanced) is stepped one event at a time
    through the plain version and the reads are counted from the store
    each event meets, not the most the kernel could read:
    - every slot's active flag; the event rows; the per-pattern model
      columns, counters and scalars; the ring when patterns spawn in
      windows;
    - open_idx of the slots active at the block's start (the first
      event's expiry test), and state, bind (patterns that bind or spawn
      in windows) and the idset (ANY patterns) of those still live after
      that event's expiries.  Every other store value the block reads was
      written by the block itself.  A PM that a PM-BL fire in the first
      event drops is counted as read;
    - each distinct transition-table entry that a live, binding-matched
      SEQ PM gathers, and each distinct utility-table entry (rows j0 and
      j1) that a pSPICE fire reads for a live PM;
    - the observation cells the stats add into.
    Outputs: the whole store, ring, counters and scalars, the W rows and
    latency-ring entries, the match tiles and the observation matrices."""
    from repro_torch.cep import patterns as pat
    from repro_torch.kernels import block_step as kb

    P, N, M, A, K = (cfg.num_patterns, cfg.max_pms, cfg.max_states,
                     cfg.max_any_ids, cfg.ring_size)
    W, C1, B = (cfg.block_events, model.trans.shape[2],
                model.ut_tables.shape[1])
    in_win = cfg.spawn_modes != "at_open"
    pms = carry.pms
    pidx = torch.arange(P, device=pms.state.device)[:, None]
    ws = model.window_size[:, None]
    seq = (model.kind == pat.KIND_SEQ)[:, None]
    uses = model.uses_binding[:, None]
    bins = model.ut_bins.float()[:, None]
    obs0 = carry.obs_counts.clone()
    rows = kb.new_rows(cfg, W, pms.state.device)
    gathers, entries = [], []
    for j in range(W):
        i = ((i0 + j + 2 ** 31) % 2 ** 32) - 2 ** 31
        active, state = pms.active.clone(), pms.state.clone()
        open_idx, bind = pms.open_idx.clone(), pms.bind.clone()
        live = active & ((i - open_idx) < ws)
        if j == 0:
            n_open = int(active.sum())
            n_state = int(live.sum())
            n_bind = int((live & (uses | in_win)).sum())
            n_ids = int((live & ~seq).sum()) if cfg.kinds != "seq" else 0
        calls = float(carry.shed_calls)
        kb.block_step_plain(cfg, model, carry, blk, i0, j, j + 1, rows)
        ec, eb = blk.ev_class[j][:, None], blk.ev_bind[j][:, None]
        ok = live & (state >= 0) & (state < M)
        if cfg.kinds != "any" and not bool(rows["dropped"][j]):
            go = ok & seq & (~uses | (bind == eb)) & (ec >= 0) & (ec < C1)
            gathers.append(((pidx * M + state) * C1 + ec)[go])
        if cfg.shedder == "pspice" and float(carry.shed_calls) > calls:
            pos = ((ws - (i - open_idx)).float() / bins - 1.0).clamp(
                0.0, float(B - 1))
            j0 = pos.floor().long()
            for jj in (j0, (j0 + 1).clamp(max=B - 1)):
                entries.append(((pidx * B + jj) * M + state)[ok])
    n_trans = int(torch.cat(gathers).unique().numel()) if gathers else 0
    n_table = int(torch.cat(entries).unique().numel()) if entries else 0
    n_obs = int((carry.obs_counts != obs0).sum()) if cfg.gather_stats else 0
    scalars = 2 * P * 4 + 12 * 4 + 2 * 4     # counters, scalars, key
    ring = (P * K * 4 + P * 4) if in_win else 0
    reads = (P * N + n_open * 4 + n_state * 4 + n_bind * 4 + n_ids * A * 4 +
             ring + n_trans * 4 + n_table * 4 + W * (P * (4 + 4 + 1) + 4 * 4)
             + P * 22 + scalars + 2 * n_obs * 4)
    store = P * N * (1 + 4 * 3) + (P * N * A * 4 if cfg.kinds != "seq"
                                   else 0)
    writes = store + ring + scalars + W * (4 + 4 + 1 + 1) + W * 2 * 4
    if cfg.emit_matches:
        writes += 2 * W * P * N * 4
    if cfg.gather_stats:
        writes += 2 * P * M * M * 4
    return reads + writes


def launch_ms(torch, setup, launch, iters: int = 50) -> float:
    """Median device time of one ``launch()``: CUDA events recorded just
    before and after it, with ``setup()`` (not timed) before each."""
    times = []
    for k in range(iters + 5):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        if k >= 5:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us_per_launch(torch, launch, n: int) -> float:
    """Host microseconds per call of ``launch(k)`` for k < n: the enqueue
    alone, host-clocked without a sync (the queue holds far more than n
    launches, so no call waits for the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n):
        launch(k)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def block_vs_plain(torch, cfg, model, saved, blk, i0, what: str):
    """The block kernel and its plain version from the same carry (numpy
    ``saved``) on the W-event block ``blk``: the (kernel, plain) pairs of
    every carry leaf, row and status, the plain carry and status.  Raises
    unless every pair is equal bit for bit."""
    from repro_torch.cep import convert
    from repro_torch.kernels import block_step as kb

    dev = torch.device("cuda")
    work = {}
    for label, fn in (("kernel", kb.block_step),
                      ("plain", kb.block_step_plain)):
        c = convert.carry_from_numpy(saved, dev)
        rows = kb.new_rows(cfg, W_BLOCK, dev)
        c, rows, status = fn(cfg, model, c, blk, i0, 0, W_BLOCK, rows)
        torch.cuda.synchronize()
        work[label] = (c, rows, status)
    (ck, rk, sk), (cp_, rp, sp) = work["kernel"], work["plain"]
    names = [f"carry[{n}]" for n in range(len(carry_leaves(ck)))] + \
        list(rk) + ["status"]
    pairs = list(zip(carry_leaves(ck), carry_leaves(cp_))) + \
        [(rk[k], rp[k]) for k in rk] + [(sk, sp)]
    bad = [n for n, (a, b) in zip(names, pairs) if not same(torch, a, b)]
    if bad:
        raise AssertionError(f"block_step != plain on {what}: {bad}")
    return pairs, cp_, sp


def phase_block_kernel(torch, np) -> dict:
    from repro_torch.cep import block_cases, convert
    from repro_torch.kernels import block_step as kb

    dev = torch.device("cuda")
    record, err, seen = {}, 0.0, set()
    for name, N, shedder in block_cases.CASES:
        cfg, model, carry, blk, i0 = block_cases.firing_block(
            name, N, shedder, dev, W=W_BLOCK, **paper_cost())
        lay = kb.plan_layout(cfg, model.trans.shape[2],
                             model.ut_tables.shape[1])
        seen.add(lay.store)
        saved = convert.tree_to_numpy(carry)
        pairs, cp_, sp = block_vs_plain(torch, cfg, model, saved, blk, i0,
                                        f"{name} N={N} {shedder} "
                                        f"({lay.store} store)")
        err = max([err] + [max_abs_err(torch, a, b) for a, b in pairs])
        fires = int(sp[0])
        if shedder in ("pspice", "pmbl") and fires < 1:
            raise AssertionError(f"block {name} N={N} {shedder}: no fire")
        # Times: each launch starts from the same carry, restored by
        # copies that are timed alone and subtracted.  The launches go
        # through the main path's launcher (one argument block per scan).
        base = convert.carry_from_numpy(saved, dev)
        c = convert.carry_from_numpy(saved, dev)
        rows = kb.new_rows(cfg, W_BLOCK, dev)
        scan = kb.BlockScan(cfg, model, c, blk, rows)

        def restore():
            for dst, src in zip(carry_leaves(c), carry_leaves(base)):
                dst.copy_(src)

        def launch():
            restore()
            scan.launch(0, i0, 0, W_BLOCK)

        def plain():
            restore()
            kb.block_step_plain(cfg, model, c, blk, i0, 0, W_BLOCK, rows)

        # Device time in the profiler; per call = the median of CUDA events
        # recorded around each launch alone (the restore outside them); the
        # host's enqueue alone; the plain version host-clocked, less the
        # restore.
        t_restore = cuda_ms(torch, restore, iters=100)
        d_us = device_us(torch, launch, "block_step_kernel", iters=20)
        call_ms = launch_ms(torch, restore,
                            lambda: scan.launch(0, i0, 0, W_BLOCK))
        host_us = host_us_per_launch(
            torch, lambda k: scan.launch(0, i0, 0, W_BLOCK), 200)
        k_ms = d_us / 1e3 if d_us is not None else call_ms
        p_ms = cuda_ms(torch, plain, iters=3) - t_restore
        stepped = convert.carry_from_numpy(saved, dev)
        nbytes = block_bytes(torch, cfg, model, stepped, blk, i0)
        if not all(same(torch, a, b) for a, b in zip(
                carry_leaves(stepped), carry_leaves(cp_))):
            raise AssertionError(f"block {name} N={N} {shedder}: the "
                                 "event-by-event count left another carry")
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        src = "device time" if d_us is not None else \
            "host clock, device time not measured"
        log("kernels", f"block_step {name} P={cfg.num_patterns} N={N} "
            f"W={W_BLOCK} {shedder} ({cfg.kinds}/{cfg.spawn_modes}, "
            f"{fires} fires in the block): bitwise ok; {lay.store} store "
            f"({lay.store_bytes} B store + scratch), {lay.smem_bytes} B "
            f"dynamic shared memory; kernel {k_ms:.6f} ms per launch "
            f"({k_ms / W_BLOCK * 1e3:.3f} us per event; {src}), per call "
            f"{call_ms:.6f} ms (CUDA events), host {host_us:.3f} us per "
            f"launch (enqueue); plain {p_ms:.6f} ms, library none, bound "
            f"{bound:.6f} ms ({nbytes} B at 3.35 TB/s)")
        if (name, N, shedder) == block_cases.CASES[0]:
            record = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                          us_per_event=k_ms / W_BLOCK * 1e3,
                          call_ms=call_ms, host_us_per_launch=host_us,
                          store=lay.store, smem_bytes=lay.smem_bytes)
    if seen != {"shared", "global"}:
        raise AssertionError(f"block cases took only the {seen} store")
    # The event rows, the model tables and the stats counts left in device
    # memory (their shares set to 0 B): the same bits, both instantiations.
    shares = {k: getattr(kb, k) for k in ("ROWS_SMEM_MAX", "MODEL_SMEM_MAX",
                                          "STATS_SMEM_MAX")}
    try:
        for k in shares:
            setattr(kb, k, 0)
        for name, N, shedder in (block_cases.CASES[0],
                                 block_cases.CASES[-1]):
            cfg, model, carry, blk, i0 = block_cases.firing_block(
                name, N, shedder, dev, W=W_BLOCK, **paper_cost())
            lay = kb.plan_layout(cfg, model.trans.shape[2],
                                 model.ut_tables.shape[1])
            if lay.rows_smem or lay.model_smem or lay.stats_smem:
                raise AssertionError(f"planner kept a piece on chip: {lay}")
            pairs, _, _ = block_vs_plain(
                torch, cfg, model, convert.tree_to_numpy(carry), blk, i0,
                f"{name} N={N} {shedder} ({lay.store} store, rows, model "
                "and stats counts in device memory)")
            err = max([err] + [max_abs_err(torch, a, b) for a, b in pairs])
            log("kernels", f"block_step {name} N={N} {shedder}: bitwise ok "
                f"with the rows, model tables and stats counts in device "
                f"memory ({lay.store} store, {lay.smem_bytes} B dynamic "
                "shared memory)")
    finally:
        for k, v in shares.items():
            setattr(kb, k, v)
    err = max(err, block_original_layout(torch))
    record["max_abs_err"] = err
    log("kernels", f"block_step: max |kernel - plain| {err!r} over every "
        "case (both instantiations, both threefry layouts)")
    return record


def lane_view(tree, k: int):
    """Lane ``k`` of a lane-stacked tree (views)."""
    from repro_torch.cep import engine as eng
    return eng.tree_map(lambda x: x[k], tree)


def lanes_bytes(torch, cfg, model, carry, blk, i0: int) -> int:
    """``block_bytes`` of one lane-grid launch: the sum over its lanes,
    each stepped from a copy of its own carry."""
    from repro_torch.cep import engine as eng
    return sum(block_bytes(torch, cfg, lane_view(model, k),
                           eng.tree_map(lambda x: x[k].clone(), carry),
                           lane_view(blk, k), i0)
               for k in range(blk.ev_id.shape[0]))


def lane_grid_timing(torch, cfg, model, carry, blk, i0: int,
                     plain: bool = False) -> dict:
    """One launch of the lane instance over every lane of ``blk``, from
    the same carry each time (restored by copies timed apart): device
    time (profiler), per call (CUDA events), the host's enqueue, the
    bound over this launch's data, and with ``plain`` the plain version
    lane by lane."""
    from repro_torch.cep import engine as eng
    from repro_torch.kernels import block_step as kb

    L = blk.ev_id.shape[0]
    base = eng.tree_map(lambda x: x.clone(), carry)
    c = eng.tree_map(lambda x: x.clone(), carry)
    rows = kb.new_rows(cfg, W_BLOCK, blk.ev_id.device, lanes=L)
    scan = kb.BlockScan(cfg, model, c, blk, rows, lanes=L)

    def restore():
        for dst, src in zip(carry_leaves(c), carry_leaves(base)):
            dst.copy_(src)

    def launch():
        restore()
        scan.launch(0, i0, 0, W_BLOCK)

    t_restore = cuda_ms(torch, restore, iters=50)
    d_us = device_us(torch, launch, "block_step_kernel", iters=20)
    call_ms = launch_ms(torch, restore, lambda: scan.launch(0, i0, 0,
                                                             W_BLOCK))
    host_us = host_us_per_launch(
        torch, lambda k: scan.launch(0, i0, 0, W_BLOCK), 100)
    out = dict(ms=d_us / 1e3 if d_us is not None else call_ms,
               call_ms=call_ms, host_us_per_launch=host_us,
               device_measured=d_us is not None)
    if plain:
        def run_plain():
            restore()
            for k in range(L):
                kb.block_step_plain(
                    cfg, lane_view(model, k), lane_view(c, k),
                    lane_view(blk, k), i0, 0, W_BLOCK,
                    {n: v[k] for n, v in rows.items()})
        out["plain_ms"] = cuda_ms(torch, run_plain, iters=2) - t_restore
    nbytes = lanes_bytes(torch, cfg, model, base, blk, i0)
    out.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    return out


def phase_block_lanes(torch, np) -> dict:
    """The block kernel's lane instance (one CTA per lane) at L = 3 on
    every block case, each lane with its own stream, model and carry:
    equal, lane by lane, to block_step_plain and to the one-lane kernel
    on that lane alone, bit for bit, in both instantiations.  Times the
    first case's launch."""
    from repro_torch.cep import block_cases, convert
    from repro_torch.cep import engine as eng
    from repro_torch.kernels import block_step as kb

    dev = torch.device("cuda")
    record, err, seen = {}, 0.0, set()
    for name, N, shedder in block_cases.CASES:
        cfg, model, carry, blk, i0 = block_cases.firing_lanes(
            name, N, shedder, dev, W=W_BLOCK, **paper_cost())
        L = blk.ev_id.shape[0]
        lay = kb.plan_layout(cfg, model.trans.shape[-1],
                             model.ut_tables.shape[-2])
        seen.add(lay.store)
        saved = convert.tree_to_numpy(carry)
        c = convert.carry_from_numpy(saved, dev)
        _, rows, status = kb.block_step_lanes(cfg, model, c, blk, i0, 0,
                                              W_BLOCK)
        torch.cuda.synchronize()
        fired = 0
        for k in range(L):
            got = carry_leaves(lane_view(c, k)) + \
                [rows[n][k] for n in rows] + [status[k]]
            for label, fn in (("plain", kb.block_step_plain),
                              ("one-lane kernel", kb.block_step)):
                ck = eng.tree_map(lambda x: x[k].clone(),
                                  convert.carry_from_numpy(saved, dev))
                rk = kb.new_rows(cfg, W_BLOCK, dev)
                ck, rk, sk = fn(cfg, lane_view(model, k), ck,
                                lane_view(blk, k), i0, 0, W_BLOCK, rk)
                torch.cuda.synchronize()
                want = carry_leaves(ck) + [rk[n] for n in rows] + [sk]
                bad = [i for i, (a, b) in enumerate(zip(got, want))
                       if not same(torch, a, b)]
                if bad:
                    raise AssertionError(
                        f"lane grid {name} N={N} {shedder}: lane {k} != "
                        f"{label} in leaves {bad}")
                err = max([err] + [max_abs_err(torch, a, b)
                                   for a, b in zip(got, want)])
            fired += int(status[k, 0]) > 0
        if shedder in ("pspice", "pmbl") and fired < 2:
            raise AssertionError(f"lane grid {name} N={N} {shedder}: "
                                 f"{fired} lanes fired, need 2")
        log("kernels", f"block_step_lanes {name} P={cfg.num_patterns} "
            f"N={N} W={W_BLOCK} {shedder}, L={L} lanes ({lay.store} store, "
            f"fires per lane {status[:, 0].tolist()}): every lane bitwise "
            "equal to block_step_plain and to the one-lane kernel")
        if (name, N, shedder) == block_cases.CASES[0]:
            t = lane_grid_timing(torch, cfg, model, carry, blk, i0,
                                 plain=True)
            src = "device time" if t["device_measured"] else \
                "CUDA events, device time not measured"
            log("kernels", f"block_step_lanes {name} N={N} L={L}: kernel "
                f"{t['ms']:.6f} ms per launch ({src}), per call "
                f"{t['call_ms']:.6f} ms, host {t['host_us_per_launch']:.3f}"
                f" us per launch; plain (lane by lane) {t['plain_ms']:.6f} "
                f"ms, library none, bound {t['bound_ms']:.6f} ms "
                f"({t['bytes']} B at 3.35 TB/s)")
            record = dict(ms=t["ms"], plain_ms=t["plain_ms"],
                          bound_ms=t["bound_ms"], call_ms=t["call_ms"],
                          host_us_per_launch=t["host_us_per_launch"],
                          lanes=L, store=lay.store,
                          smem_bytes=lay.smem_bytes)
    if seen != {"shared", "global"}:
        raise AssertionError(f"lane-grid cases took only the {seen} store")
    record["max_abs_err"] = err
    log("kernels", f"block_step_lanes: max |kernel - plain|, |kernel - "
        f"one-lane kernel| {err!r} over every case and lane")
    return record


# ---------------------------------------------------------------------------
# The multi-tenant streaming runtime
# ---------------------------------------------------------------------------

RT_LANES, RT_EVENTS, RT_CHUNK = 128, 30000, 1024
# The refresh demo's simulated-time costs (examples/runtime_multitenant.py).
DEMO_COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4,
                 c_shed_pm=1.5e-6, c_ebl=6e-5)


def _cut(raw, a: int, b: int):
    import dataclasses
    return dataclasses.replace(raw, n=b - a, type_id=raw.type_id[a:b],
                               attr=raw.attr[a:b], group=raw.group[a:b])


def phase_runtime(torch, np) -> dict:
    """The streaming runtime on the card: 128 tenant lanes of the stock
    configuration through MultiTenantRuntime against 128 sequential
    single-lane runs (every lane's carry equal), the lane grid's time
    per launch at L = 1, 8 and 128, and the refresh demo at L = 8.
    Returns the lane instance's launches on the 128-lane run and its
    time and bound per launch at each L."""
    launches = runtime_throughput(torch, np)
    runtime_refresh(torch, np)
    return launches


def runtime_throughput(torch, np) -> dict:
    from repro_torch import runtime as RT
    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams
    from repro_torch.kernels import ops as kops

    dev = torch.device("cuda")
    L, n = RT_LANES, RT_EVENTS
    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(
        cp, max_pms=sc.max_pms, latency_bound=sc.latency_bound,
        shedder="pspice", backend="cuda_block", block_events=W_BLOCK,
        **paper_cost())
    t0 = time.perf_counter()
    raws = [sc.raw(n=n, seed=sc.seed + k) for k in range(L)]
    warm = streams.classify(specs, _cut(raws[0], 0, int(n * 0.3)),
                            rate=1.0, seed=sc.seed, device=dev)
    built = runner.build_model(specs, cfg, warm, bin_size=sc.bin_size,
                               seed=sc.seed, device=dev)
    rates = [built.max_rate * (1.2 + 0.2 * k / (L - 1)) for k in range(L)]
    evs = [streams.classify(specs, raws[k], rate=rates[k], seed=sc.seed + k,
                            device=dev) for k in range(L)]
    model = eng.make_model(
        cp, cfg, ut_tables=built.ut_stacked, ut_bins=built.ut_bins,
        f_model=built.f_model, g_model=built.g_model,
        ebl_raw_mean=float(evs[0].ebl_raw.mean()), device=dev)
    log("runtime", f"{L} lanes x {n} stock events (3 x Q1, N={sc.max_pms}, "
        f"W={W_BLOCK}, pspice, LB {sc.latency_bound} s), rates "
        f"{rates[0]:.1f}..{rates[-1]:.1f} events/s (max_rate "
        f"{built.max_rate!r} x 1.2..1.4); set-up "
        f"{time.perf_counter() - t0:.2f} s")

    # -- the sequential baseline: one run_engine per lane ---------------
    eng.run_engine(cfg, model, evs[0], eng.init_carry(cfg, device=dev),
                   device=dev)
    carries = [eng.init_carry(cfg, seed=k, device=dev) for k in range(L)]
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    seq = []
    for k in range(L):
        c, _ = eng.run_engine(cfg, model, evs[k], carries[k], device=dev)
        torch.cuda.synchronize()
        seq.append(c)
    wall_seq = time.perf_counter() - t0
    seq_launches = kops.launch_counts()["block_step"]

    # -- the lane-parallel runtime ---------------------------------------
    mL, evL = RT.broadcast_model(model, L), RT.stack(evs)
    rt = RT.RuntimeConfig(chunk_size=RT_CHUNK)
    walls = []
    for rep in range(2):                 # the first run warms the path
        mt = RT.MultiTenantRuntime(cfg, mL, L, rt=rt, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        kops.reset_launch_counts()
        eng.host_syncs = 0
        t0 = time.perf_counter()
        stats = mt.push(evL, flush=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts, syncs = kops.launch_counts(), eng.host_syncs
        peak = torch.cuda.max_memory_allocated()
    wall_mt = walls[-1]
    want = sum(-(-s.n_events // (L * W_BLOCK)) for s in stats)
    if counts["block_step_lanes"] != want or counts["block_step"] != 0:
        raise AssertionError(f"runtime launches {counts}, expected {want} "
                             "lane-grid launches and no one-lane launch")
    if syncs:
        raise AssertionError(f"{syncs} engine host syncs on the fused path")
    bad = [k for k in range(L) if not all(
        same(torch, a, b) for a, b in zip(
            carry_leaves(lane_view(mt.carry, k)),
            carry_leaves(seq[k])))]
    if bad:
        raise AssertionError(f"MultiTenantRuntime lanes {bad} != their "
                             "sequential single-lane runs")
    agg = mt.telemetry.aggregate()
    total = L * n
    log("runtime", f"MultiTenantRuntime: {total} events in {wall_mt:.4f} s "
        f"= {total / wall_mt:.1f} events/s (warm-up run {walls[0]:.4f} s); "
        f"sequential ({L} x run_engine, carries made before the clock): "
        f"{wall_seq:.4f} s = {total / wall_seq:.1f} events/s; speedup "
        f"{wall_seq / wall_mt:.2f}x")
    log("runtime", f"lane-grid launches {counts['block_step_lanes']} (grid "
        f"= {L} CTAs each; sequential: {seq_launches} one-lane launches), "
        f"engine host syncs {syncs}, {len(stats)} chunks; peak device "
        f"memory {peak / 2**20:.1f} MiB ({(peak - mem0) / 2**20:.1f} MiB "
        f"above the {mem0 / 2**20:.1f} MiB held before the run); "
        f"telemetry: p99 max {agg['l_e_p99_max']:.6f} s, pms_shed "
        f"{agg['pms_shed']:g}, shed_calls {agg['shed_calls']:g}, "
        f"completions {agg['completions']:g}")
    log("runtime", f"every lane of MultiTenantRuntime == its sequential "
        f"single-lane run in every carry leaf (bitwise, {L} lanes)")

    # -- time per lane-grid launch at L = 1, 8, 128 -----------------------
    half = n // 2 // W_BLOCK * W_BLOCK
    by_lanes = {}
    at = RT.MultiTenantRuntime(cfg, mL, L, rt=rt, device=dev)
    at.push(eng.EventBatch(*(x[:, :half] for x in evL)), flush=True)
    for lx in (1, 8, L):
        sub = lambda t, lx=lx: eng.tree_map(  # noqa: E731
            lambda x: x[:lx].contiguous(), t)
        blk = eng.EventBatch(*(x[:lx, half:half + W_BLOCK].contiguous()
                               for x in evL))
        tm = lane_grid_timing(torch, cfg, sub(mL), sub(at.carry), blk, half)
        src = "device time" if tm["device_measured"] else \
            "CUDA events, device time not measured"
        log("runtime", f"lane grid L={lx}: {tm['ms']:.6f} ms per launch "
            f"({src}; per call {tm['call_ms']:.6f} ms, host "
            f"{tm['host_us_per_launch']:.3f} us), "
            f"{tm['ms'] / (lx * W_BLOCK) * 1e3:.4f} us per lane-event; "
            f"bound {tm['bound_ms']:.6f} ms ({tm['bytes']} B at 3.35 TB/s),"
            f" {tm['ms'] / tm['bound_ms']:.1f}x the bound")
        by_lanes[str(lx)] = (tm["ms"], tm["bound_ms"])
    return {"block_step_lanes": dict(
        launches=counts["block_step_lanes"],
        ms_by_lanes={k: v[0] for k, v in by_lanes.items()},
        bound_ms_by_lanes={k: v[1] for k, v in by_lanes.items()})}


def runtime_refresh(torch, np) -> None:
    """The refresh demo (examples/runtime_multitenant.py at L = 8): Q1
    over 4 symbols, drifting streams and rates, per-lane refresh every 4
    chunks; every lane equal to the StreamRuntime run on that lane alone."""
    from repro_torch import runtime as RT
    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams

    dev = torch.device("cuda")
    L, n, chunk = 8, 16384, 1024
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=128, latency_bound=0.02,
                                gather_stats=True, shedder="pspice",
                                backend="cuda_block", block_events=W_BLOCK,
                                **DEMO_COST)
    model = eng.make_model(cp, cfg, device=dev)
    rate = 1.0 / (cfg.c_base + cfg.c_match * 0.3 * cfg.max_pms)
    evs = [streams.classify(
        specs, streams.gen_stock_drift(n, num_symbols=50, pattern_symbols=4,
                                       p_class=0.03, p_class_end=0.10,
                                       seed=100 + k),
        rate=rate * (1 + 0.2 * k), rate_end=4.0 * rate, seed=k, device=dev)
        for k in range(L)]
    rt = RT.RuntimeConfig(chunk_size=chunk, refresh=RT.RefreshConfig(
        every_chunks=4, min_observations=256, decay=0.5))
    mt = RT.MultiTenantRuntime(cfg, RT.broadcast_model(model, L), L, rt=rt,
                               specs=specs, device=dev)
    evL = RT.stack(evs)
    t0 = time.perf_counter()
    for s in range(0, n, 3000):
        mt.push(eng.EventBatch(*(x[:, s:s + 3000] for x in evL)),
                flush=s + 3000 >= n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    agg = mt.telemetry.aggregate()
    counts = [s.refresh_count for s in mt.refresh_state]
    if agg["refreshes"] < 1 or min(counts) < 1:
        raise AssertionError(f"refresh demo: no refresh ({agg}, {counts})")
    for k in range(L):
        srt = RT.StreamRuntime(cfg, model, rt=rt, specs=specs, seed=k,
                               device=dev)
        srt.push(evs[k], flush=True)
        torch.cuda.synchronize()
        if srt.refresh_state.refresh_count != counts[k] or not all(
                same(torch, a, b) for a, b in zip(
                    carry_leaves(lane_view(mt.carry, k)),
                    carry_leaves(srt.carry))):
            raise AssertionError(f"refresh demo lane {k} != StreamRuntime "
                                 "on that lane alone")
    log("runtime", f"refresh demo: {L} lanes x {n} events, chunk {chunk}, "
        f"{agg['n_chunks']} chunks in {wall:.4f} s ({L * n / wall:.1f} "
        f"events/s host clock); {agg['refreshes']} refresh rounds, per-lane "
        f"refreshes {counts}, host time in refresh "
        f"{agg['refresh_wall_s']:.4f} s; aggregate {json.dumps(agg)}")
    log("runtime", "refresh demo: every lane == StreamRuntime on that lane "
        "alone (carry bitwise, refresh counts equal)")


# ---------------------------------------------------------------------------
# The runtime's resilience layer (counterpart of benchmarks/bench_faults.py)
# ---------------------------------------------------------------------------

RES_EVENTS, RES_CHUNK, RES_PUSH = 30000, 1024, 4096
RES_FN_BOUND = 0.98        # bench_faults.FN_BOUND: a liveness bound
RES_POISONED = (3, 64, 127)
DEV = "cuda"               # the card; the phases' functions run there


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def stock_setup(torch, dev, backend: str, n: int, lanes: int = 1,
                rates=(1.0, 1.0), gather: bool = False):
    """The stock main path's configuration (3 x Q1, N = 256, W = 32,
    pspice, LB 0.05 s) with the model built on lane 0's warm-up (the
    runtime phase's recipe); lane l's stream is seed 7 + l at max_rate x
    (rates[0] + (rates[1] - rates[0]) l / (lanes - 1)).  Returns (specs,
    cfg, model, [events per lane], max_rate)."""
    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams

    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(
        cp, max_pms=sc.max_pms, latency_bound=sc.latency_bound,
        shedder="pspice", backend=backend, block_events=W_BLOCK,
        gather_stats=gather, **paper_cost())
    raws = [sc.raw(n=n, seed=sc.seed + k) for k in range(lanes)]
    warm = streams.classify(specs, _cut(raws[0], 0, int(n * 0.3)),
                            rate=1.0, seed=sc.seed, device=dev)
    built = runner.build_model(specs, cfg, warm, bin_size=sc.bin_size,
                               seed=sc.seed, device=dev)
    mult = [rates[0] + (rates[1] - rates[0]) * k / max(lanes - 1, 1)
            for k in range(lanes)]
    evs = [streams.classify(specs, raws[k], rate=built.max_rate * mult[k],
                            seed=sc.seed + k, device=dev)
           for k in range(lanes)]
    model = eng.make_model(
        cp, cfg, ut_tables=built.ut_stacked, ut_bins=built.ut_bins,
        f_model=built.f_model, g_model=built.g_model,
        ebl_raw_mean=float(evs[0].ebl_raw.mean()), device=dev)
    return specs, cfg, model, evs, built.max_rate


def resilience_rt(RT, cfg, **kw):
    """benchmarks/bench_faults.py's resilience_rt values at the stock
    chunk, with the ladder's bound at 2 x LB (as the reference's 0.01 is
    to its 0.005)."""
    return RT.RuntimeConfig(
        chunk_size=RES_CHUNK,
        refresh=RT.RefreshConfig(every_chunks=4, min_observations=64.0),
        ingest=RT.IngestConfig(max_queue_events=1 << 15,
                               high_watermark=1 << 13,
                               low_watermark=1 << 11, seed=5),
        ladder=RT.LadderConfig(escalate_streak=2, deescalate_streak=2,
                               latency_bound=2 * cfg.latency_bound),
        guard=RT.GuardConfig(check_every_chunks=1,
                             checkpoint_every_chunks=4), **kw)


def floats_finite(torch, tree) -> bool:
    from repro_torch.cep import engine as eng
    return all(np_finite(a) for _, a in eng.tree_leaves_with_path(tree))


def np_finite(a) -> bool:
    import numpy as np
    return not np.issubdtype(a.dtype, np.floating) or bool(
        np.isfinite(a).all())


def push_all(RT, srt, ev, axis: int = 0, inj=None, lanes=None) -> None:
    """Push ``ev`` in pieces of RES_PUSH events, then flush.  With an
    injector, state faults strike between pushes (into ``lanes``, or the
    whole state) and stream faults rewrite each push."""
    n = RT.num_events(ev, axis)
    for s in range(0, n, RES_PUSH):
        batch = RT.slice_events(ev, s, min(s + RES_PUSH, n), axis)
        if inj is not None:
            for lane in (lanes or [None]):
                srt.carry = inj.corrupt_carry(srt.carry, lane=lane)
                srt.model = inj.corrupt_model(srt.model, lane=lane)
            batch = inj.corrupt_events(batch, axis=axis)
        srt.push(batch)
    srt.flush()


def fault_cell(torch, dev, specs, cfg, model, ev, kinds) -> tuple:
    """One cell of bench_faults' matrix on the card: the resilient
    StreamRuntime over the stream, state faults between pushes and
    stream faults on each push (seed 3, p 0.35), then the end-of-run
    guard sweep.  Returns (row with its gates, runtime)."""
    from repro_torch import runtime as RT

    inj = RT.FaultInjector(RT.FaultConfig(kinds=kinds, seed=3,
                                          p_fault=0.35)) if kinds else None
    srt = RT.StreamRuntime(cfg, model, resilience_rt(RT, cfg), specs=specs,
                           device=dev)
    t0 = time.perf_counter()
    push_all(RT, srt, ev, inj=inj)
    srt.guard_now()
    sync(torch, dev)
    agg = srt.telemetry.aggregate()
    tel = srt.telemetry
    row = dict(
        wall_s=time.perf_counter() - t0, events=srt.events_processed,
        completions=agg.get("completions", 0.0),
        faults=len(inj.log) if inj else 0, restores=srt.guard.restores,
        violations=srt.guard.violations, max_rung=agg.get("max_rung", 0),
        transitions=len(srt.ladder.transitions),
        admission_shed=srt.ingest.total_shed,
        quarantine_dropped=srt.quarantine_dropped,
        refreshes=agg.get("refreshes", 0))
    row["ok_state_finite"] = floats_finite(torch, srt.carry) and \
        floats_finite(torch, srt.model)
    row["ok_guard_clean"] = srt.guard.check(srt.carry, srt.model) == []
    row["ok_mirrored"] = (
        len(srt.ladder.transitions) == len(tel.events_of("ladder"))
        == agg.get("ladder_transitions", -1)
        and srt.guard.violations == len(tel.events_of("guard_violation"))
        and srt.guard.restores == len(tel.events_of("guard_restore")))
    return row, srt


def phase_resilience(torch, np) -> dict:
    """The resilience layer on the card: bench_faults' matrix on
    cuda_block (clean and all faults also on cuda, equal in carry sha256
    and counters); resilience off and inert cost nothing (one stream on
    both paths, and 128 lanes); 128 lanes under lane faults (a per-lane
    restore) and under a ladder that trims, the trim over lanes on the
    kernels against its plain version and lane by lane.  Returns the lane
    histogram's launches on the trimming run and its trim times."""
    resilience_matrix(torch, np)
    resilience_inert(torch, np)
    return resilience_lanes(torch, np)


def resilience_matrix(torch, np) -> None:
    import dataclasses

    from repro_torch import runtime as RT
    from repro_torch.runtime import supervisor as SV

    dev = torch.device(DEV)
    specs, cfg, model, (ev,), max_rate = stock_setup(
        torch, dev, "cuda_block", RES_EVENTS, gather=True)
    log("resilience", f"fault matrix: stock {RES_EVENTS} events (3 x Q1, "
        f"N={cfg.max_pms}, W={W_BLOCK}, pspice, LB {cfg.latency_bound} s) "
        f"at max_rate {max_rate!r} x 1.0, chunk {RES_CHUNK}, pushes of "
        f"{RES_PUSH}; ingest + ladder (bound {2 * cfg.latency_bound} s) + "
        "guard + refresh every 4 chunks; faults seed 3, p 0.35")
    cells = [("clean", ())] + [(k, (k,)) for k in RT.STREAM_FAULTS +
                               RT.STATE_FAULTS] + \
        [("all_faults", RT.STREAM_FAULTS + RT.STATE_FAULTS)]
    clean = None
    kept = {}
    for name, kinds in cells:
        row, srt = fault_cell(torch, dev, specs, cfg, model, ev, kinds)
        if name == "clean":
            clean = row["completions"]
            row["ok_clean_nonempty"] = clean > 0
        else:
            row["fn_vs_clean"] = 1.0 - row["completions"] / clean
            row["ok_fn_bounded"] = row["fn_vs_clean"] <= RES_FN_BOUND
        bad = [k for k, v in row.items() if k.startswith("ok_") and not v]
        log("resilience", f"cell {name} (cuda_block): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if not k.startswith("ok_")) +
            f"; gates {'FAIL ' + '+'.join(bad) if bad else 'pass'}")
        if bad:
            raise AssertionError(f"fault cell {name}: gates {bad} failed")
        if name in ("clean", "all_faults"):
            kept[name] = cell_digest(SV, srt)
    for name, kinds in (cells[0], cells[-1]):
        row, srt = fault_cell(torch, dev, specs,
                              dataclasses.replace(cfg, backend="cuda"),
                              model, ev, kinds)
        got = cell_digest(SV, srt)
        if got != kept[name]:
            raise AssertionError(f"fault cell {name}: cuda {got} != "
                                 f"cuda_block {kept[name]}")
        log("resilience", f"cell {name} on cuda ({row['wall_s']:.2f} s): "
            f"carry sha256 {got[0][:16]}... and semantic counters equal "
            "cuda_block's")


def cell_digest(SV, srt) -> tuple:
    """(carry sha256, semantic counters as sorted JSON): a poisoned
    chunk's NaN latencies compare equal as text."""
    return SV.carry_sha(srt), json.dumps(SV.semantic_counters(srt),
                                         sort_keys=True)


def resilience_inert(torch, np) -> None:
    """Resilience off: the chunked runtime equals one monolithic
    run_engine (cuda_block and cuda).  Configured but never triggered: it
    equals resilience off (one stream; 128 lanes, with both runs'
    events/s and the guard's host reads per chunk)."""
    import dataclasses

    from repro_torch import runtime as RT
    from repro_torch.cep import engine as eng

    dev = torch.device(DEV)
    specs, cfg, model, (ev,), _ = stock_setup(torch, dev, "cuda_block",
                                              RES_EVENTS)
    inert = dict(ingest=RT.IngestConfig(),
                 ladder=RT.LadderConfig(latency_bound=1e6, max_rung=1),
                 guard=RT.GuardConfig(check_every_chunks=1,
                                      checkpoint_every_chunks=4))
    for backend in ("cuda_block", "cuda"):
        c = dataclasses.replace(cfg, backend=backend)
        mono, _ = eng.run_engine(c, model, ev, eng.init_carry(c, device=dev),
                                 device=dev)
        runs = {}
        for label, kw in (("off", {}), ("inert", inert)):
            if backend == "cuda" and label == "inert":
                continue
            srt = RT.StreamRuntime(c, model, RT.RuntimeConfig(
                chunk_size=RES_CHUNK, **kw), device=dev)
            push_all(RT, srt, ev)
            sync(torch, dev)
            runs[label] = srt
        for label, srt in runs.items():
            bad = [i for i, (a, b) in enumerate(zip(
                carry_leaves(mono), carry_leaves(srt.carry)))
                if not same(torch, a, b)]
            if bad:
                raise AssertionError(f"resilience {label} on {backend}: "
                                     f"carry leaves {bad} != run_engine")
        log("resilience", f"{backend}: resilience off == one monolithic "
            f"run_engine" + (" == resilience configured and never "
                             "triggered" if "inert" in runs else "") +
            f" (every carry leaf, {RES_EVENTS} events, pushes of "
            f"{RES_PUSH}, chunk {RES_CHUNK})")

    # -- 128 lanes, the runtime phase's cell --------------------------------
    specs, cfg, model, evs, _ = stock_setup(torch, dev, "cuda_block",
                                            RES_EVENTS, lanes=RT_LANES,
                                            rates=(1.2, 1.4))
    mL, evL = RT.broadcast_model(model, RT_LANES), RT.stack(evs)
    out = {}
    for label, kw in (("off", {}), ("inert", inert), ("off", {}),
                      ("inert", inert)):
        mt = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=RT.RuntimeConfig(
            chunk_size=RES_CHUNK, **kw), device=dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        push_all(RT, mt, evL, axis=1)
        sync(torch, dev)
        out[label] = (time.perf_counter() - t0, mt)   # the second run kept
    (w_off, off), (w_in, inr) = out["off"], out["inert"]
    bad = [k for k in range(RT_LANES) if not all(
        same(torch, a, b) for a, b in zip(
            carry_leaves(lane_view(off.carry, k)),
            carry_leaves(lane_view(inr.carry, k))))]
    if bad:
        raise AssertionError(f"inert resilience changed lanes {bad}")
    total = RT_LANES * RES_EVENTS
    n_chunks = inr.telemetry.aggregate()["n_chunks"]
    g = inr.guard
    log("resilience", f"{RT_LANES} lanes x {RES_EVENTS} events, pushes of "
        f"{RES_PUSH}: resilience off {w_off:.4f} s = {total / w_off:.1f} "
        f"events/s; inert (ingest + ladder + guard) {w_in:.4f} s = "
        f"{total / w_in:.1f} events/s ({w_in / w_off:.2f}x the time); every "
        f"lane's carry equal; guard: {g.checks_run} checks (one host read "
        f"each, at the end of each group of chunks) over {n_chunks} chunks "
        f"= {g.checks_run / n_chunks:.3f} host reads per chunk, "
        f"{g.checkpoints} host-copy checkpoints")


def resilience_lanes(torch, np) -> dict:
    """128 lanes under lane faults (lane_poison and table_corrupt into
    lanes 3, 64 and 127 at one push, ladder off) and under a ladder whose
    bound forces the PM-trim rung (trim_store_lanes on the kernels)."""
    from repro_torch import runtime as RT
    from repro_torch.cep import engine as eng
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import guard as GD

    dev = torch.device(DEV)
    specs, cfg, model, evs, _ = stock_setup(torch, dev, "cuda_block",
                                            RES_EVENTS, lanes=RT_LANES,
                                            rates=(1.2, 1.4))
    mL, evL = RT.broadcast_model(model, RT_LANES), RT.stack(evs)

    # -- (a) per-lane restore -------------------------------------------------
    rt = RT.RuntimeConfig(chunk_size=RES_CHUNK, guard=RT.GuardConfig(
        check_every_chunks=1, checkpoint_every_chunks=4))
    clean = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt, device=dev)
    push_all(RT, clean, evL, axis=1)
    hit = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt, device=dev)
    inj = RT.FaultInjector(RT.FaultConfig(
        kinds=("lane_poison", "table_corrupt"), seed=3, p_fault=1.0))
    n = RES_EVENTS
    for k, s in enumerate(range(0, n, RES_PUSH)):
        if k == 3:
            for lane in RES_POISONED:
                hit.carry = inj.corrupt_carry(hit.carry, lane=lane)
                hit.model = inj.corrupt_model(hit.model, lane=lane)
        hit.push(RT.slice_events(evL, s, min(s + RES_PUSH, n), 1))
    hit.flush()
    sync(torch, dev)
    restored = [e.detail["lanes"] for e in
                hit.telemetry.events_of("guard_restore")]
    if restored != [list(RES_POISONED)]:
        raise AssertionError(f"lane faults: restores {restored}, expected "
                             f"one of lanes {list(RES_POISONED)}")
    bad = [k for k in range(RT_LANES) if k not in RES_POISONED and not all(
        same(torch, a, b) for a, b in zip(
            carry_leaves(lane_view(clean.carry, k)),
            carry_leaves(lane_view(hit.carry, k))))]
    if bad or not floats_finite(torch, hit.carry) or \
            not floats_finite(torch, hit.model):
        raise AssertionError(f"lane faults: lanes {bad} differ from the run "
                             "without faults, or state not finite")
    log("resilience", f"lane faults into lanes {list(RES_POISONED)} of "
        f"{RT_LANES} at push 4 ({len(inj.log)} faults): the guard restored "
        f"exactly those lanes ({hit.guard.violations} violations, "
        f"{hit.guard.restores} restore); the other {RT_LANES - 3} lanes "
        "equal the run without faults in every carry leaf")

    # -- (b) the PM-trim rung over lanes --------------------------------------
    trims = []

    class Capturing(RT.MultiTenantRuntime):
        def _trim_call(self, i, frac):
            keep = len(trims) < 2
            if keep:
                before = (GD.host_copy(self.carry), GD.host_copy(self.model))
            out = super()._trim_call(i, frac)
            if keep:
                trims.append((before, i, frac, GD.host_copy(out)))
            return out

    rt = RT.RuntimeConfig(chunk_size=RES_CHUNK, group_chunks=1,
                          ladder=RT.LadderConfig(
                              escalate_streak=1, deescalate_streak=2,
                              latency_bound=cfg.latency_bound / 2,
                              max_rung=RT.RUNG_PM_TRIM, trim_frac=0.25))
    mt = Capturing(cfg, mL, RT_LANES, rt=rt, device=dev)
    sync(torch, dev)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    push_all(RT, mt, evL, axis=1)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    n_trims = sum(1 for s in mt.telemetry.chunks if s.rung >= 1)
    if not trims or counts["utility_histogram_lanes"] != 3 * n_trims or \
            counts["utility_lookup"] != n_trims:
        raise AssertionError(f"trim rung: {n_trims} trims, launches "
                             f"{counts}: expected 1 lookup and 3 lane "
                             "histograms per trim")
    err = 0.0
    on_card = lambda t: eng.tree_map(lambda x: x.to(dev), t)  # noqa: E731
    for (carry0, model0), i, frac, out in trims:
        plain = GD.trim_store_lanes(cfg, model0, carry0, i, frac)
        c_card, m_card = on_card(carry0), on_card(model0)
        for k in range(RT_LANES):
            one = GD.trim_store(cfg, lane_view(m_card, k),
                                lane_view(c_card, k), i, frac)
            got = carry_leaves(lane_view(out, k))
            for label, want in (("plain", carry_leaves(lane_view(plain, k))),
                                ("lane by lane", carry_leaves(one))):
                if not all(same(torch, a, b.cpu())
                           for a, b in zip(got, want)):
                    raise AssertionError(f"trim lanes != {label} at lane "
                                         f"{k}")
                err = max([err] + [max_abs_err(torch, a, b.cpu())
                                   for a, b in zip(got, want)])
    # Time one trim over 128 lanes against 128 one-lane trims.
    (carry0, model0), i, frac, _ = trims[0]
    c_card, m_card = on_card(carry0), on_card(model0)
    kops.reset_launch_counts()
    GD.trim_store_lanes(cfg, m_card, c_card, i, frac)
    per_lanes = sum(kops.launch_counts().values())
    kops.reset_launch_counts()
    views = [(lane_view(m_card, k), lane_view(c_card, k))
             for k in range(RT_LANES)]
    for m1, c1 in views:
        GD.trim_store(cfg, m1, c1, i, frac)
    per_lane = sum(kops.launch_counts().values())
    ms_lanes = cuda_ms(torch, lambda: GD.trim_store_lanes(
        cfg, m_card, c_card, i, frac), iters=20)
    ms_one = cuda_ms(torch, lambda: [GD.trim_store(cfg, m1, c1, i, frac)
                                     for m1, c1 in views], iters=3)
    n_active = int(c_card.pms.active.sum())
    hist_bytes = RT_LANES * cfg.num_patterns * cfg.max_pms * 4 + \
        RT_LANES * (2 * 128 + 1) * 4
    log("resilience", f"trim rung at L={RT_LANES}: {n_trims} trims in "
        f"{len(mt.telemetry.chunks)} chunks ({wall:.3f} s), launches "
        f"{ {k: v for k, v in counts.items() if v} }; the first two trims "
        f"equal the plain version (CPU) and {RT_LANES} one-lane trims on the "
        f"card, "
        f"lane by lane, max |d| {err!r}")
    log("resilience", f"one trim over {RT_LANES} lanes ({n_active} active "
        f"PMs): {ms_lanes:.4f} ms, {per_lanes} launches; lane by lane "
        f"{ms_one:.4f} ms, {per_lane} launches ({ms_one / ms_lanes:.1f}x)")
    return {"utility_histogram_lanes": dict(
        launches=counts["utility_histogram_lanes"], trim_ms=ms_lanes,
        trim_lane_by_lane_ms=ms_one, trim_launches=per_lanes,
        trim_lane_by_lane_launches=per_lane, trim_hist_bytes=hist_bytes)}


# ---------------------------------------------------------------------------
# Durable recovery (counterpart of benchmarks/bench_recovery.py)
# ---------------------------------------------------------------------------

# bench_recovery's kill draws per site (the snapshot site strikes the
# SECOND write, so a previous generation exists to fall back to) and its
# grid's cells for pallas_block and pallas, with the site and seed that
# grid's cycling gives them (cell i: site KILL_SITES[i % 3], seed 100 + i).
REC_KILL_RANGES = {"chunk": (2, 10), "refresh": (1, 2), "snapshot": (2, 2)}
REC_CELLS = (("cuda_block", "none", 8), ("cuda_block", "pspice", 9),
             ("cuda_block", "pmbl", 10), ("cuda_block", "ebl", 11),
             ("cuda", "pspice", 5))


def rec_spec(backend: str, shedder: str) -> dict:
    """The supervisor's workload at full width: N = 256, W = 32, 30 000
    events, chunk 1 024, pushes of 4 096, snapshot every 4 chunks."""
    return {"backend": backend, "shedder": shedder, "n": RES_EVENTS,
            "push": RES_PUSH, "chunk": RES_CHUNK, "max_pms": 256,
            "block_events": W_BLOCK, "rate_mult": 3.0, "refresh_every": 4,
            "snapshot_every": 4, "min_observations": 64.0, "device": DEV}


def phase_recovery(torch, np) -> None:
    """SIGKILL recovery on the card: the supervisor's children run on the
    card, die at a seeded kill site, and the relaunched child must end
    bitwise equal to the uninterrupted run; then an in-process snapshot +
    recovery of 128 stock lanes."""
    import shutil
    import tempfile

    from repro_torch import runtime as RT
    from repro_torch.runtime import supervisor as SV

    work = pathlib.Path(tempfile.mkdtemp(prefix="smoke-persist-",
                                         dir=ROOT / "build"))
    try:
        for backend, shedder, i in REC_CELLS:
            site = RT.KILL_SITES[i % len(RT.KILL_SITES)]
            inj = RT.FaultInjector(RT.FaultConfig(kinds=RT.PROCESS_FAULTS,
                                                  seed=100 + i))
            ks = inj.plan_kill(site, *REC_KILL_RANGES[site])
            spec = rec_spec(backend, shedder)
            t0 = time.perf_counter()
            ref = SV.run_service(spec)
            t_ref = time.perf_counter() - t0
            d = work / f"{backend}-{shedder}"
            d.mkdir()
            t0 = time.perf_counter()
            res = SV.Supervisor(str(d)).run(spec, kill=ks.spec())
            t_sup = time.perf_counter() - t0
            rep, rec = res["report"], res["report"]["recovery"]
            gates = {
                "ok_killed": res["killed"] and res["attempts"][0][
                    "returncode"] == -9,
                "ok_recovered": res["recovered"],
                "ok_bitwise": all(rep[k] == ref[k] for k in (
                    "carry_sha", "matches", "counters",
                    "events_processed"))}
            if site == "snapshot":
                gates["ok_torn_rejected"] = len(rec["rejected_snapshots"]) \
                    >= 1
            snaps = sorted((d / "persist").glob("snap-*.ckpt"))
            log("recovery", f"{backend}/{shedder} kill {ks.spec()}: "
                f"attempts {[a['returncode'] for a in res['attempts']]}, "
                f"snapshot chunk {rec['snapshot_chunk']}, replayed "
                f"{rec['replayed_records']} WAL records, rejected "
                f"{len(rec['rejected_snapshots'])}, recovery "
                f"{rec['recovery_wall_s'] * 1e3:.1f} ms in the child, "
                f"snapshot {snaps[-1].stat().st_size if snaps else 0} B; "
                f"{sum(len(m) for m in rep['matches'])} matches, "
                f"{rep['events_processed']} events; uninterrupted run "
                f"{t_ref:.2f} s, supervised {t_sup:.2f} s; gates " +
                ", ".join(f"{k} {v}" for k, v in gates.items()))
            if not all(gates.values()):
                raise AssertionError(f"recovery {backend}/{shedder}: "
                                     f"{gates}")
        recovery_lanes(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def recovery_lanes(torch, work) -> None:
    """128 stock lanes with the guard and persistence: snapshot, abandon
    the runtime mid-stream (what a SIGKILL leaves on disk), recover into
    a fresh MultiTenantRuntime and finish; every lane equals the
    uninterrupted run."""
    from repro_torch import runtime as RT

    dev = torch.device(DEV)
    specs, cfg, model, evs, _ = stock_setup(torch, dev, "cuda_block",
                                            RES_EVENTS, lanes=RT_LANES,
                                            rates=(1.2, 1.4))
    mL, evL = RT.broadcast_model(model, RT_LANES), RT.stack(evs)
    d = work / "lanes"

    def rt(persist):
        return RT.RuntimeConfig(
            chunk_size=RES_CHUNK, guard=RT.GuardConfig(
                check_every_chunks=1, checkpoint_every_chunks=4),
            persist=RT.PersistConfig(dir=str(d), snapshot_every_chunks=4)
            if persist else None)

    clean = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt(False),
                                  device=dev)
    push_all(RT, clean, evL, axis=1)
    a = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt(True), device=dev)
    append_s = []
    wal_append = a.persist.wal.append

    def timed(ev):
        t0 = time.perf_counter()
        rid = wal_append(ev)
        append_s.append(time.perf_counter() - t0)
        return rid

    a.persist.wal.append = timed
    cut = 3 * RES_PUSH + RES_CHUNK + RES_CHUNK // 2   # a buffered tail
    for s in range(0, 3 * RES_PUSH, RES_PUSH):
        a.push(RT.slice_events(evL, s, s + RES_PUSH, 1))
    t0 = time.perf_counter()
    path = a.snapshot_now()
    write_ms = (time.perf_counter() - t0) * 1e3
    snap_bytes = pathlib.Path(path).stat().st_size   # rotated away later
    a.push(RT.slice_events(evL, 3 * RES_PUSH, cut, 1))
    a.persist.wal.close()
    del a
    b = RT.MultiTenantRuntime(cfg, mL, RT_LANES, rt=rt(True), device=dev)
    t0 = time.perf_counter()
    rec = b.recover_from_disk()
    sync(torch, dev)
    rec_ms = (time.perf_counter() - t0) * 1e3
    for s in range(cut, RES_EVENTS, RES_PUSH):
        b.push(RT.slice_events(evL, s, min(s + RES_PUSH, RES_EVENTS), 1))
    b.flush()
    sync(torch, dev)
    bad = [k for k in range(RT_LANES) if not all(
        same(torch, x, y) for x, y in zip(
            carry_leaves(lane_view(clean.carry, k)),
            carry_leaves(lane_view(b.carry, k))))]
    if bad or rec["replayed_records"] != 1:
        raise AssertionError(f"128-lane recovery: lanes {bad} differ, "
                             f"{rec['replayed_records']} records replayed")
    log("recovery", f"{RT_LANES} lanes in process: snapshot "
        f"{snap_bytes} B written in {write_ms:.2f} "
        f"ms (fsync included), recovery {rec_ms:.2f} ms replaying "
        f"{rec['replayed_records']} WAL record, WAL append "
        f"{statistics.mean(append_s) * 1e6:.1f} us per push of "
        f"{RT_LANES} x {RES_PUSH} events (mean of {len(append_s)}); every "
        "lane equals the uninterrupted run in every carry leaf")


def block_original_layout(torch) -> float:
    """The block kernel in jax's original threefry layout (the committed
    quality results'), bit for bit against its plain version on the
    PM-BL cases: the store in shared memory (stock, bus) and in device
    memory (soccer N=2048); then the kernel's generator alone against
    repro_torch.prng in both layouts, at an odd n (the original layout's
    padded pair) and at soccer's P·N.  Returns the largest |Δ|."""
    from repro_torch import prng
    from repro_torch.cep import block_cases, convert
    from repro_torch.kernels import block_step as kb

    dev = torch.device("cuda")
    err, seen = 0.0, set()
    with prng.layout(False):
        for name, N, shedder in block_cases.CASES:
            if shedder != "pmbl":
                continue
            cfg, model, carry, blk, i0 = block_cases.firing_block(
                name, N, shedder, dev, W=W_BLOCK, **paper_cost())
            lay = kb.plan_layout(cfg, model.trans.shape[2],
                                 model.ut_tables.shape[1])
            seen.add(lay.store)
            pairs, _, sp = block_vs_plain(
                torch, cfg, model, convert.tree_to_numpy(carry), blk, i0,
                f"{name} N={N} pmbl, original threefry layout")
            if int(sp[0]) < 1:
                raise AssertionError(f"block {name} N={N} pmbl: no fire")
            err = max([err] + [max_abs_err(torch, a, b) for a, b in pairs])
            log("kernels", f"block_step {name} N={N} pmbl in the original "
                f"threefry layout ({int(sp[0])} fires, {lay.store} store): "
                "bitwise ok")
    if seen != {"shared", "global"}:
        raise AssertionError(f"original-layout cases took only {seen}")
    for part in (True, False):
        for n in (4097, 8 * 2048):
            key = prng.PRNGKey(n, device=dev)
            keys, u = kb.threefry_probe(key, n, partitionable=part)
            want = prng.split(key, partitionable=part)
            want_u = prng.uniform(want[1], (n,), partitionable=part)
            torch.cuda.synchronize()
            if not (same(torch, keys, want) and same(torch, u, want_u)):
                raise AssertionError(f"threefry_probe != prng (partitionable"
                                     f"={part}, n={n})")
            err = max(err, max_abs_err(torch, u, want_u))
        log("kernels", f"threefry on the card == repro_torch.prng in the "
            f"{'partitionable' if part else 'original'} layout (split and "
            "uniform, n = 4097 and 16384): bitwise ok")
    return err


# ---------------------------------------------------------------------------
# Engine parity: cuda on the card == torch on the card == torch on the CPU
# ---------------------------------------------------------------------------

def phase_parity(torch, np, runs=(("cuda@gpu", "cuda", "cuda"),
                                   ("cuda_block@gpu", "cuda_block", "cuda"),
                                   ("torch@gpu", "torch", "cuda"),
                                   ("torch@cpu", "torch", "cpu")),
                 n: int = 3000, N: int = 2048) -> None:
    import dataclasses

    from repro_torch.cep import convert, engine as eng, patterns as pat
    from repro_torch.cep import runner
    from repro_torch.data import streams

    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=N, latency_bound=0.02,
                                emit_matches=True, gather_stats=True,
                                **paper_cost())
    raw = sc.raw(n=n + 1000)
    cut = lambda a, b: dataclasses.replace(  # noqa: E731
        raw, n=b - a, type_id=raw.type_id[a:b], attr=raw.attr[a:b],
        group=raw.group[a:b])
    cpu = torch.device("cpu")
    built = runner.build_model(
        specs, cfg, streams.classify(specs, cut(0, 1000), rate=1.0, seed=7,
                                     device=cpu), device=cpu)
    # The built utility tables with a LINEAR f (the engine's cost model).
    tree = dict(convert.tree_to_numpy(built), f_model=dict(
        a=np.float32(cfg.c_match), b=np.float32(cfg.c_base),
        kind=np.int32(0)))
    rate = 6.0 / (cfg.c_base + cfg.c_match * 60)
    for shedder in ("none", "pspice", "pmbl", "ebl"):
        results = {}
        for label, backend, dev in runs:
            rcfg = dataclasses.replace(cfg, backend=backend, shedder=shedder)
            b = convert.built_from_numpy(tree, dev)
            ev = streams.classify(specs, cut(1000, n + 1000), rate=rate,
                                  seed=7, device=dev)
            model = eng.make_model(cp, rcfg, ut_tables=b.ut_stacked,
                                   ut_bins=b.ut_bins, f_model=b.f_model,
                                   g_model=b.g_model, ebl_raw_mean=0.5,
                                   device=dev)
            t0 = time.perf_counter()
            carry, outs = eng.run_engine(
                rcfg, model, ev, eng.init_carry(rcfg, seed=7, device=dev),
                device=dev)
            results[label] = (convert.tree_to_numpy((carry, outs)),
                              time.perf_counter() - t0)
        ref, _ = results[runs[-1][0]]
        for label, (got, _) in results.items():
            bad = [k for k, a, b in _leaves(got, ref)
                   if not np.array_equal(a, b, equal_nan=a.dtype.kind == "f")]
            if bad:
                raise AssertionError(f"{shedder}: {label} != {runs[-1][0]} "
                                     f"in {bad}")
        fires = float(ref[0]["shed_calls"])
        drops = float(ref[0]["ebl_dropped"])
        if shedder in ("pspice", "pmbl") and fires < 5:
            raise AssertionError(f"{shedder}: only {fires:g} fires")
        if shedder == "ebl" and drops < 5:
            raise AssertionError(f"ebl: only {drops:g} dropped events")
        secs = ", ".join(f"{k} {s:.2f} s" for k, (_, s) in results.items())
        log("parity", f"stock N={N} {n} events shedder={shedder}: carry + "
            f"StepOut bitwise across {', '.join(r[0] for r in runs)} "
            f"(fires {fires:g}, E-BL drops {drops:g}; {secs})")


def _leaves(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _leaves(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


# ---------------------------------------------------------------------------
# The main path: run_experiment on the card
# ---------------------------------------------------------------------------

def run_scenario(torch, name: str, n: int, backend: str,
                 device: str = "cuda") -> tuple[dict, dict, float, int]:
    """run_experiment on one scenario through one engine path, with the
    launch counts and host syncs set to 0 just before and read after."""
    from repro_torch.cep import engine as eng, runner
    from repro_torch.data import streams
    from repro_torch.kernels import ops as kops

    sc = streams.get_scenario(name)
    raw = sc.raw(n=n)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    kops.reset_launch_counts()
    eng.host_syncs = 0
    t0 = time.perf_counter()
    res = runner.run_experiment(
        sc.specs(), raw, shedders=("pspice", "pmbl", "ebl"),
        rate_multiplier=1.2, max_pms=sc.max_pms, bin_size=sc.bin_size,
        latency_bound=sc.latency_bound, seed=sc.seed, backend=backend,
        block_events=W_BLOCK, device=device, **paper_cost())
    sync()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    syncs = eng.host_syncs
    n_run = raw.n - int(raw.n * 0.3)
    for sh, er in res.items():
        log("main", f"{name} n={n} {backend} {sh}: fn {er.fn:.6f} fn_match "
            f"{er.fn_match:.6f} lb_compliance {er.lb_compliance:.6f} "
            f"shed_calls {er.result.shed_calls:g} run {er.seconds:.2f} s "
            f"({n_run / er.seconds:.1f} events/s)")
    fn = {sh: er.fn_match for sh, er in res.items()}
    if not (fn["pspice"] <= fn["pmbl"] + 1e-9 and
            fn["pspice"] <= fn["ebl"] + 1e-9):
        raise AssertionError(f"{name}: headline ordering violated: {fn}")
    events = n_run * 4 + int(raw.n * 0.3)
    built = res["pspice"].built
    log("main", f"{name} {backend}: wall {wall:.2f} s for {events} engine "
        f"events ({events / wall:.1f} events/s, {wall / events * 1e6:.2f} "
        f"us/event); launches {counts}; host syncs {syncs} "
        f"({syncs / events:.3f} per event); f kind "
        f"{int(built.f_model.kind)} g kind {int(built.g_model.kind)} "
        f"(0 = LINEAR); ordering ok {fn}")
    return res, counts, wall, events


def phase_main(torch) -> dict:
    """Both engine paths on every scenario.  Returns each kernel's
    launches from the run of its own path on the stock scenario."""
    launches = {}
    for name, n in (("stock", 30000), ("soccer", 12000), ("bus", 12000)):
        runs = {}
        for backend in ("cuda", "cuda_block"):
            res, counts, wall, events = run_scenario(torch, name, n, backend)
            runs[backend] = res
            path = [k for k, b in KERNEL_PATH.items() if b == backend]
            if name == "stock":      # stock runs every kernel of its path
                for k in path:
                    if counts[k] <= 0:
                        raise AssertionError(f"kernel {k} never launched on "
                                             f"the {backend} path")
                launches.update({k: counts[k] for k in path})
            if backend == "cuda_block":
                want = sum(-(-e // W_BLOCK) for e in (
                    int(n * 0.3),) + (n - int(n * 0.3),) * 4)
                log("main", f"{name} cuda_block: {counts['block_step']} "
                    f"block launches (ceil(n/W) per run: {want}); "
                    f"{wall / counts['block_step'] * 1e3:.4f} ms of wall "
                    "per launch")
                if counts["block_step"] != want:
                    raise AssertionError(f"{name}: {counts['block_step']} "
                                         f"block launches, expected {want}")
        for sh in runs["cuda"]:
            a, b = runs["cuda"][sh], runs["cuda_block"][sh]
            got = (b.fn, b.fn_match, b.result.shed_calls, b.lb_compliance)
            want = (a.fn, a.fn_match, a.result.shed_calls, a.lb_compliance)
            if got != want:
                raise AssertionError(f"{name} {sh}: cuda_block {got} != "
                                     f"cuda {want}")
        log("main", f"{name}: cuda_block == cuda in FN, fires and LB "
            "compliance for every shedder")
        if name == "stock":
            # pspice and E-BL draw nothing from threefry: in the port's
            # default layout they must meet the committed cells exactly
            # (PM-BL's cell is held in its own layout by phase_quality).
            cells = committed_quality()["datasets"]["stock"]["levels"]["1.2"]
            for sh in ("pspice", "ebl"):
                er = runs["cuda_block"][sh]
                got = (er.fn_match, er.result.shed_calls)
                want = (cells[sh]["fn"], cells[sh]["shed_calls"])
                if got != want:
                    raise AssertionError(f"stock {sh} (FN, fires) {got} != "
                                         f"committed {want}")
            log("main", "stock pspice and ebl: FN and fires exactly the "
                "committed BENCH_quality.json cells (" + ", ".join(
                    f"{sh} {cells[sh]['fn']!r} / {cells[sh]['shed_calls']:g}"
                    for sh in ("pspice", "ebl")) + ")")
    return launches


# ---------------------------------------------------------------------------
# The quality evaluation at the paper's grid, in the committed layout
# ---------------------------------------------------------------------------

def phase_quality(torch, np) -> dict:
    """The oracle, the paper's grid on both engine paths and the layer
    split, with repro_torch.prng in jax's original threefry layout (the
    committed BENCH_quality.json's) for the phase.  Returns each CEP
    kernel's launches on the grid's runs (counts from 0 before each
    path)."""
    from repro_torch import prng

    with prng.layout(False):
        quality_oracle(torch, np)
        launches = quality_grid(torch)
        layer_split(torch, np)
    return launches


def quality_oracle(torch, np) -> None:
    """The NumPy oracle against both engine paths on the card, in both
    layouts: the oracle's overload fixture (Q1, N=48, 300 events at
    x1.2/1.4/1.6) and a stock stream whose PM-BL fires keep some of the
    live PMs (so the layout decides which), every shedder, the literal
    sort-based Algorithm 2."""
    from repro_torch import prng

    dev = torch.device("cuda")
    pmbl_matches = {}
    for part in (True, False):
        for shedder in ("none", "pspice", "pmbl", "ebl"):
            with prng.layout(part):
                fires, matches = oracle_cases_on_card(torch, np, dev,
                                                      shedder, part)
            if shedder == "pmbl":
                pmbl_matches[part] = matches
            if shedder in ("pspice", "pmbl") and min(fires[:3]) < 8:
                raise AssertionError(f"{shedder}: the overload fixture "
                                     f"fired only {fires}")
            log("quality", f"oracle == cuda == cuda_block (matches, "
                f"counters, l_e, shed, dropped), {shedder}, "
                f"{'partitionable' if part else 'original'} layout: "
                f"fires {[int(f) for f in fires]} (x1.2/1.4/1.6, stock)")
    if pmbl_matches[True] == pmbl_matches[False]:
        raise AssertionError("the stock stream's PM-BL matches do not "
                             "depend on the layout: the check is blind")


def oracle_cases_on_card(torch, np, dev, shedder: str, part: bool):
    """The oracle's cases under one shedder through both engine paths on
    the card; raises on a difference.  Returns the oracle's fires per
    case and its matches on the stock stream."""
    import dataclasses

    from repro_torch.cep import engine as eng
    from repro_torch.eval import oracle, oracle_cases

    cases = [(f"overload x{m}", oracle_cases.overload_case(shedder, m, dev))
             for m in oracle_cases.OVERLOAD_LEVELS]
    cases.append(("stock", oracle_cases.layout_case(shedder, dev)))
    fires = []
    for label, (cfg, model, ev) in cases:
        o = oracle.run_oracle(cfg, model, ev, seed=0)
        for backend in ("cuda", "cuda_block"):
            c = dataclasses.replace(cfg, backend=backend)
            carry, outs = eng.run_engine(
                c, model, ev, eng.init_carry(c, seed=0, device=dev),
                device=dev)
            bad = oracle_diff(np, eng, carry, outs, o)
            if bad:
                raise AssertionError(f"{label} {shedder} {backend} "
                                     f"partitionable={part}: != oracle in "
                                     f"{bad}")
        fires.append(o.shed_calls)
    return fires, o.matches


def oracle_diff(np, eng, carry, outs, o) -> list:
    """The fields where an engine run differs from the oracle's."""
    bad = []
    if eng.match_sets(outs) != o.matches:
        bad.append("matches")
    for f in ("complex_count", "pms_created"):
        if not np.array_equal(getattr(carry, f).cpu().numpy(),
                              getattr(o, f)):
            bad.append(f)
    for f in ("pms_shed", "shed_calls", "overflow", "ebl_dropped"):
        if float(getattr(carry, f)) != getattr(o, f):
            bad.append(f)
    for f in ("l_e", "n_pm", "shed", "dropped"):
        want = getattr(o, f)
        got = getattr(outs, f).cpu().numpy().astype(want.dtype)
        if not np.array_equal(got, want):
            bad.append(f)
    return bad


def quality_grid(torch) -> dict:
    """run_quality_sweep on cuda_block (W=32) at n_default, held to the
    committed grid; then cuda at the headline level on every dataset,
    held to cuda_block.  Launch counts from 0 before each path."""
    from repro_torch.cep import engine as eng
    from repro_torch.eval import sweep
    from repro_torch.kernels import ops as kops

    committed = committed_quality()
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    eng.host_syncs = 0
    t0 = time.perf_counter()
    bench = sweep.run_quality_sweep(backend="cuda_block",
                                    block_events=W_BLOCK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    if counts["block_step"] <= 0:
        raise AssertionError("the grid never launched the block kernel")
    log("quality", f"grid on cuda_block: {wall:.2f} s, block launches "
        f"{counts['block_step']}, host syncs {eng.host_syncs}; "
        f"threefry_partitionable "
        f"{bench['config']['threefry_partitionable']}; check_headline "
        f"violations {bench['violations']}")
    if bench["violations"] or bench["config"]["threefry_partitionable"]:
        raise AssertionError(f"grid: {bench['violations']}")
    exact, total, rate_diff = 0, 0, []
    for ds, grid in bench["datasets"].items():
        ref = committed["datasets"][ds]
        if grid["n_events"] != ref["n_events"]:
            raise AssertionError(f"{ds}: {grid['n_events']} events, the "
                                 f"committed grid {ref['n_events']}")
        for lv, cells in grid["levels"].items():
            for sh, cell in cells.items():
                want = ref["levels"][lv][sh]
                is_exact = (cell["fn"], cell["shed_calls"]) == \
                    (want["fn"], want["shed_calls"])
                rate_same = cell["max_rate"] == want["max_rate"]
                total += 1
                exact += is_exact
                if not is_exact and not rate_same:
                    rate_diff.append(f"{ds}/{lv}/{sh}")
                log("quality", f"{ds} x{lv} {sh}: fn {cell['fn']!r} "
                    f"(committed {want['fn']!r}, delta "
                    f"{cell['fn'] - want['fn']:+.6f}), fires "
                    f"{cell['shed_calls']:g} ({want['shed_calls']:g}), "
                    f"max_rate {cell['max_rate']!r} ({want['max_rate']!r}"
                    f"{', equal' if rate_same else ', differs'}), "
                    f"lb_compliance {cell['lb_compliance']:.6f}; "
                    f"{'exact' if is_exact else 'not exact'}")
                if ds == "stock" and lv == "1.2" and not is_exact:
                    raise AssertionError(f"stock x1.2 {sh} is not the "
                                         "committed cell")
                if abs(cell["fn"] - want["fn"]) > GRID_TOL:
                    raise AssertionError(f"{ds} x{lv} {sh}: FN beyond "
                                         f"{GRID_TOL} of the committed")
    log("quality", f"{exact} of {total} cells exact (FN and fires); of the "
        f"others, max_rate differs in {len(rate_diff)} {rate_diff} and is "
        f"equal in {total - exact - len(rate_diff)}")
    # The per-event kernels' path at the headline level.
    level = sweep.HEADLINE_LEVEL
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    for ds in sweep.DATASETS:
        t1 = time.perf_counter()
        grid = sweep.run_dataset(ds, levels=(level,), backend="cuda")
        cells = grid["levels"][f"{level:g}"]
        for sh, cell in cells.items():
            blk = bench["datasets"][ds]["levels"][f"{level:g}"][sh]
            keys = ("fn", "fn_count", "shed_calls", "lb_compliance")
            if any(cell[k] != blk[k] for k in keys):
                raise AssertionError(f"{ds} {sh}: cuda "
                                     f"{[cell[k] for k in keys]} != "
                                     f"cuda_block {[blk[k] for k in keys]}")
        log("quality", f"{ds} x{level:g} on cuda: == cuda_block in FN, "
            f"count FN, fires and LB compliance for every shedder "
            f"({time.perf_counter() - t1:.2f} s)")
    torch.cuda.synchronize()
    cuda_counts = kops.launch_counts()
    for k in ("nfa_advance", "utility_lookup", "utility_histogram"):
        if cuda_counts[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on cuda")
    log("quality", f"cuda at the headline level: "
        f"{time.perf_counter() - t0:.2f} s, launches {cuda_counts}")
    return dict(cuda_counts, block_step=counts["block_step"])


def layer_split(torch, np) -> None:
    """The wall of stock's run_experiment (x1.2, cuda_block) by layer:
    its stages composed as run_experiment composes them, with a sync at
    every boundary, checked to give the same FN."""
    import collections
    import dataclasses

    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams
    from repro_torch.eval import quality as Q

    dev = torch.device("cuda")
    sc = streams.get_scenario("stock")
    specs, raw, cost = sc.specs(), sc.raw(), paper_cost()
    kw = dict(max_pms=sc.max_pms, latency_bound=sc.latency_bound,
              backend="cuda_block", block_events=W_BLOCK, **cost)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner.run_experiment(specs, raw, rate_multiplier=1.2,
                                bin_size=sc.bin_size, seed=sc.seed, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    secs = collections.defaultdict(float)

    def timed(layer, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[layer] += time.perf_counter() - t
        return out

    def cut(a, b):
        return dataclasses.replace(raw, n=b - a, type_id=raw.type_id[a:b],
                                   attr=raw.attr[a:b], group=raw.group[a:b])

    t_all = time.perf_counter()
    cp = timed("patterns and config", lambda: pat.compile_patterns(specs))
    cfg = timed("patterns and config", lambda: runner.default_config(
        cp, emit_matches=True, **kw))
    n_warm = int(raw.n * 0.3)
    warm = timed("classification", lambda: streams.classify(
        specs, cut(0, n_warm), rate=1.0, seed=sc.seed, device=dev))
    built = timed("build_model (warm-up run + model)",
                  lambda: runner.build_model(specs, cfg, warm,
                                             bin_size=sc.bin_size,
                                             seed=sc.seed, device=dev))
    rate = built.max_rate * 1.2
    weights = np.array([s.weight for s in specs])
    runs = {}
    for sh in ("none", "pspice", "pmbl", "ebl"):
        run_cfg = dataclasses.replace(cfg, gather_stats=False, shedder=sh)
        ev = timed("classification", lambda: streams.classify(
            specs, cut(n_warm, raw.n), rate=rate, seed=sc.seed, device=dev))
        model = timed("run setup (make_model, init_carry)",
                      lambda: eng.make_model(
                          cp, run_cfg, ut_tables=built.ut_stacked,
                          ut_bins=built.ut_bins, f_model=built.f_model,
                          g_model=built.g_model, ebl_raw_mean=float(
                              ev.ebl_raw.cpu().numpy().mean()), device=dev))
        carry0 = timed("run setup (make_model, init_carry)",
                       lambda: eng.init_carry(run_cfg, seed=sc.seed,
                                              device=dev))
        carry, outs = timed("engine runs", lambda: eng.run_engine(
            run_cfg, model, ev, carry0, device=dev))
        matches = timed("match-set decoding", lambda: eng.match_sets(outs))
        empty = outs._replace(match_open=outs.match_open[..., :0],
                              match_bind=outs.match_bind[..., :0])
        runs[sh] = timed("results to the host",
                         lambda: eng.summarize(carry, empty))
        runs[sh].matches = matches
    for sh in ("pspice", "pmbl", "ebl"):
        rep = timed("match-set comparison", lambda: Q.compare_match_sets(
            runs[sh].matches, runs["none"].matches, weights))
        if rep.fn_ratio != res[sh].fn_match:
            raise AssertionError(f"layer split: {sh} FN {rep.fn_ratio!r} != "
                                 f"run_experiment's {res[sh].fn_match!r}")
    composed = time.perf_counter() - t_all
    warm_cfg = dataclasses.replace(cfg, gather_stats=True,
                                   shedder=eng.SHED_NONE, emit_matches=False)
    warm_model = eng.make_model(cp, warm_cfg, device=dev)
    timed("(warm-up run alone)", lambda: eng.run_engine(
        warm_cfg, warm_model, warm,
        eng.init_carry(warm_cfg, seed=sc.seed, device=dev), device=dev))
    n_engine = n_warm + 4 * (raw.n - n_warm)
    log("quality", f"layer split, stock x1.2 cuda_block ({raw.n} events; "
        f"{n_engine} engine events): run_experiment {wall:.3f} s; the same "
        f"stages composed with a sync at each boundary {composed:.3f} s "
        f"(same FN for every shedder)")
    for layer, t in sorted(secs.items(), key=lambda kv: -kv[1]):
        share = "" if layer.startswith("(") else \
            f" ({t / composed:.1%} of the composed wall)"
        log("quality", f"  {layer}: {t:.3f} s{share}")
    engine_s = secs["engine runs"] + secs["(warm-up run alone)"]
    log("quality", f"  engine (4 runs + the warm-up run) {engine_s:.3f} s = "
        f"{n_engine / engine_s:.1f} events/s; everything else "
        f"{composed - engine_s:.3f} s ({1 - engine_s / composed:.1%})")


# ---------------------------------------------------------------------------
# Where the time goes: one engine run under torch.profiler
# ---------------------------------------------------------------------------

def phase_profile(torch, backend: str, n: int = 6000,
                  device: str = "cuda") -> None:
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams

    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=sc.max_pms,
                                latency_bound=sc.latency_bound,
                                emit_matches=True, backend=backend,
                                block_events=W_BLOCK, **paper_cost())
    raw = sc.raw(n=n + 3000)
    cut = lambda a, b: dataclasses.replace(  # noqa: E731
        raw, n=b - a, type_id=raw.type_id[a:b], attr=raw.attr[a:b],
        group=raw.group[a:b])
    built = runner.build_model(
        specs, cfg, streams.classify(specs, cut(0, 3000), rate=1.0,
                                     seed=sc.seed, device=device),
        bin_size=sc.bin_size, seed=sc.seed, device=device)
    rcfg = dataclasses.replace(cfg, shedder="pspice")
    ev = streams.classify(specs, cut(3000, n + 3000),
                          rate=built.max_rate * 1.2, seed=sc.seed,
                          device=device)
    model = eng.make_model(cp, rcfg, ut_tables=built.ut_stacked,
                           ut_bins=built.ut_bins, f_model=built.f_model,
                           g_model=built.g_model, device=device)

    def run():
        c, o = eng.run_engine(rcfg, model, ev,
                              eng.init_carry(rcfg, seed=sc.seed,
                                             device=device), device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return c

    run()
    t0 = time.perf_counter()
    carry = run()
    wall = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        run()
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log("profile", "device time not measured (the profiler saw no CUDA "
            "activity)")
        return
    log("profile", f"stock pspice N={sc.max_pms} {n} events, backend "
        f"{backend}: "
        f"wall {wall:.3f} s unprofiled ({n / wall:.1f} events/s, "
        f"{wall / n * 1e3:.4f} ms/event), fires "
        f"{float(carry.shed_calls):g}; device busy {busy:.4f} s "
        f"({busy / wall:.4%} of wall; idle {1 - busy / wall:.4%})")
    for dev_us, count, key in rows[:8]:
        log("profile", f"  {dev_us / 1e3:.3f} ms device, {count} calls, "
            f"{dev_us / max(count, 1):.3f} us/call: {key[:90]}")
    if backend == "cuda_block":
        from repro_torch.kernels import block_step as kb
        blocks, nb = eng._pad_event_blocks(ev, n, W_BLOCK)
        scan = kb.BlockScan(rcfg, model, eng.init_carry(
            rcfg, seed=sc.seed, device=device), blocks,
            kb.new_rows(rcfg, nb * W_BLOCK, device))
        host_us = host_us_per_launch(torch, lambda b: scan.launch(
            b, b * W_BLOCK, 0, min(n - b * W_BLOCK, W_BLOCK)), nb)
        log("profile", f"block launch path: host {host_us:.3f} us per "
            f"launch (enqueue alone, {nb} launches of one scan)")
    for dev_us, count, key in rows:
        if "block_step_kernel" in key:
            log("profile", f"block kernel: {dev_us / count:.3f} us per "
                f"launch, {dev_us / n:.3f} us per event ({count} launches "
                f"for {n} events); {dev_us / 1e6 / wall:.4%} of wall")


# ---------------------------------------------------------------------------
# The flash kernel against its plain version
# ---------------------------------------------------------------------------

# (label, B, Sq, Sk, H, KVH, D, Dv, causal, q_offset): the prefill shape of
# the model phase (timed in bf16, held in both types), the shapes of
# tests/test_kernels.py:17-22, ragged S with D in {8, 16, 64, 128} (Sq and
# Sk not multiples of the bf16 kernel's 128-row tiles), Dv != D, a
# decode-style block (Sq < Sk at q_offset = Sk - Sq), and a block at
# q_offset 100 whose rows 0..27 meet a KV tile (keys 128..191) where every
# key is masked.
FLASH_PREFILL = ("prefill", 4, 2048, 2048, 16, 8, 128, 128, True, 0)
FLASH_CASES = (
    ("kernels_test", 1, 128, 128, 2, 2, 32, 32, True, 0),
    ("kernels_test", 1, 128, 128, 2, 2, 32, 32, False, 0),
    ("kernels_test", 2, 256, 256, 4, 2, 64, 64, True, 0),
    ("mqa", 1, 256, 256, 8, 1, 64, 64, True, 0),
    ("mqa", 1, 256, 256, 8, 1, 64, 64, False, 0),
    ("sq_ne_sk", 2, 128, 256, 4, 4, 128, 128, False, 0),
    ("ragged", 1, 2047, 2047, 4, 2, 8, 8, True, 0),
    ("ragged", 2, 48, 48, 4, 2, 16, 16, True, 0),
    ("ragged", 1, 2047, 2047, 2, 1, 64, 64, True, 0),
    ("ragged", 2, 300, 300, 4, 2, 128, 128, True, 0),
    ("ragged", 1, 130, 383, 2, 2, 128, 128, False, 0),
    ("dv_ne_d", 2, 256, 256, 4, 2, 64, 128, True, 0),
    ("decode_style", 2, 200, 328, 4, 2, 128, 128, True, 128),
    ("masked_tile", 2, 64, 192, 4, 2, 32, 32, True, 100),
)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# The bf16 kernel's second bar, scaled to the output: the largest
# ‖kernel − plain‖ / ‖plain‖ over the Dv columns of one (b, i, h) row.
# A causal row that sees i keys of unit-normal K and V has outputs of
# about sqrt(e / i) (0.05 at i = 1 024), so the absolute 3e-2 alone is
# about a late row's size.  A sound kernel differs from the plain version
# by the bf16 rounding of P (taken against another running max) and of
# the output: ~4e-3 of a row (up to ~7e-3 at D = 8, whose rows have 8
# columns).  The faults that flash_faults plants, confined to the rows
# from FLASH_FAULT_ROW0 on, must read above this bar.
FLASH_ROW_TOL = 2e-2
FLASH_FAULT_ROW0 = 1024
# The bf16 kernel is timed in turns with scaled_dot_product_attention in
# this order, each turn FLASH_WINDOWS windows of FLASH_CALLS calls.
FLASH_ORDER = ("kernel", "sdpa", "sdpa", "kernel")
FLASH_WINDOWS, FLASH_CALLS = 5, 20


def flash_work(B, Sq, Sk, H, KVH, D, Dv, causal, q_offset, esize):
    """(bytes, operations) the attention needs: Q, K and V read once and O
    written once; 2·(D + Dv) operations per visible (query, key) pair,
    counted from this case's mask."""
    if causal:
        pairs = sum(min(Sk, q_offset + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Sk
    nbytes = (B * Sq * H * D + B * Sk * KVH * (D + Dv) +
              B * Sq * H * Dv) * esize
    return nbytes, B * H * pairs * 2 * (D + Dv)


def row_rel_err(torch, got, want) -> float:
    """The largest ‖got − want‖ / ‖want‖ over the last dim of one row."""
    diff = (got.float() - want.float()).norm(dim=-1)
    return float((diff / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def flash_faults(torch, kfa, q, k, v, want) -> None:
    """Faults planted through the bf16 kernel's inputs at the prefill
    shape, each held against the plain version on the true inputs over
    the rows from FLASH_FAULT_ROW0 on, where it must exceed FLASH_ROW_TOL:
    the softmax temperature 5 % off; the keys of one 128-key tile read
    from the previous lap of its stage of the 2-stage ring (a stale
    stage); the causal mask one key late."""
    import math
    r0, n = FLASH_FAULT_ROW0, 128
    stale_k, stale_v = k.clone(), v.clone()
    stale_k[:, r0:r0 + n] = k[:, r0 - 2 * n:r0 - n]
    stale_v[:, r0:r0 + n] = v[:, r0 - 2 * n:r0 - n]
    faults = {
        "softmax scale x 1.05": lambda: kfa.flash_attention(
            q, k, v, scale=1.05 / math.sqrt(q.shape[-1])),
        f"keys {r0}..{r0 + n - 1} read from a stale ring stage": lambda:
            kfa.flash_attention(q, stale_k, stale_v),
        "causal mask one key late": lambda: kfa.flash_attention(
            q, k, v, q_offset=1),
    }
    for name, run in faults.items():
        got = run()
        torch.cuda.synchronize()
        row = row_rel_err(torch, got[:, r0:], want[:, r0:])
        err = max_abs_err(torch, got[:, r0:], want[:, r0:])
        log("kernels", f"flash_attention planted fault ({name}), rows >= "
            f"{r0}: row-relative {row:.3e} (bar {FLASH_ROW_TOL}), max "
            f"|kernel - plain| {err:.3e}")
        if not row > FLASH_ROW_TOL:
            raise AssertionError(f"planted fault {name!r} reads {row!r}, "
                                 f"inside the bar {FLASH_ROW_TOL}")


def windows_ms(torch, fns: dict, order, windows: int, calls: int) -> dict:
    """Per name, the per-call device times (CUDA events) of its windows of
    ``calls`` back-to-back calls; the names take turns in ``order``, each
    turn ``windows`` windows, so that both see the same card state."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    out = {name: [] for name in fns}
    for name in order:
        for _ in range(windows):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            out[name].append(start.elapsed_time(end) / calls)
    return out


def ptxas_report(log_text: str, kernel: str) -> list:
    """(mangled name, registers, spill stores, spill loads, static smem
    bytes) of every entry function whose name contains ``kernel``, read
    from the nvcc/ptxas log of the build."""
    import re
    rows = []
    for block in log_text.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if kernel not in name:
            continue

        def num(pattern):
            m = re.search(pattern, block)
            return int(m.group(1)) if m else 0
        rows.append((name, num(r"Used (\d+) registers"),
                     num(r"(\d+) bytes spill stores"),
                     num(r"(\d+) bytes spill loads"),
                     num(r"(\d+) bytes smem")))
    return rows


# The probe's bar: C = A·Bᵀ sums 128 products of N(0, 1) bf16 values
# (|C| up to ~50) and E = bf16(C)·V sums 64 of about 11 (|E| up to
# ~400), both in float32 in another order than torch.matmul, which moves
# an entry by ~1e-5 of its size.  A fault of the descriptors, the swizzle
# or the fragment layout moves entries by their own size.
PROBE_TOL = 1e-2


def phase_probe(torch, np) -> None:
    """The bf16 flash kernel's building blocks (TMA with the 128-byte
    swizzle, wgmma from shared memory and from registers, the transposed
    V operand) against torch.matmul of the same tiles."""
    from repro_torch.kernels import flash_attention as kfa

    rng = np.random.default_rng(14)
    a, b, v = (torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
    c, e = kfa.wgmma_probe(a, b, v)
    want_c = torch.matmul(a.float(), b.float().t())
    want_e = torch.matmul(c.to(torch.bfloat16).float(), v.float())
    torch.cuda.synchronize()
    err_c = max_abs_err(torch, c, want_c)
    err_e = max_abs_err(torch, e, want_e)
    log("kernels", f"wgmma probe: C = A·Bᵀ (8 x m64n64k16, K-major "
        f"operands) max |probe - matmul| {err_c:.3e} of max |C| "
        f"{float(want_c.abs().max()):.3e}; E = bf16(C)·V (4 x m64n128k16, "
        f"A from registers, V transposed) {err_e:.3e} of max |E| "
        f"{float(want_e.abs().max()):.3e} (tol {PROBE_TOL})")
    if not (err_c <= PROBE_TOL and err_e <= PROBE_TOL):
        raise AssertionError(f"wgmma probe beyond {PROBE_TOL}: C {err_c!r}, "
                             f"E {err_e!r}")


def phase_flash_kernel(torch, np) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa

    dev = torch.device("cuda")
    phase_probe(torch, np)
    errs = dict.fromkeys(FLASH_TOL, 0.0)
    row_max = 0.0
    record = {}
    for case in (FLASH_PREFILL,) + FLASH_CASES:
        label, B, Sq, Sk, H, KVH, D, Dv, causal, q_off = case
        rng = np.random.default_rng(B * Sq + H * D + Dv + q_off)
        host = [rng.standard_normal(s).astype(np.float32) for s in
                ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, Dv))]
        for dt in FLASH_TOL:
            q, k, v = (torch.from_numpy(a).to(dev, getattr(torch, dt))
                       for a in host)
            n0 = kfa.flash_attention.launches
            n0_tc = kfa.flash_attention.sm90_launches
            got = kfa.flash_attention(q, k, v, causal=causal, q_offset=q_off)
            want = kfa.flash_attention_plain(q, k, v, causal=causal,
                                             q_offset=q_off)
            torch.cuda.synchronize()
            tc = int(dt == "bfloat16")
            if (kfa.flash_attention.launches != n0 + 1 or
                    kfa.flash_attention.sm90_launches != n0_tc + tc):
                raise AssertionError(f"flash_attention {dt} did not count "
                                     "its launch on its own kernel")
            err = max_abs_err(torch, got, want)
            errs[dt] = max(errs[dt], err)
            row = row_rel_err(torch, got, want) if tc else 0.0
            row_max = max(row_max, row)
            if (not bool(torch.isfinite(got).all()) or err > FLASH_TOL[dt]
                    or row > FLASH_ROW_TOL):
                raise AssertionError(f"flash {label} {case[1:]} {dt}: max "
                                     f"|kernel - plain| {err!r} beyond "
                                     f"{FLASH_TOL[dt]}, or row-relative "
                                     f"{row!r} beyond {FLASH_ROW_TOL}")
            row_txt = (f"; row-relative {row:.3e} (bar {FLASH_ROW_TOL})"
                       if tc else "")
            log("kernels", f"flash_attention {label} B={B} Sq={Sq} Sk={Sk} "
                f"H={H} KVH={KVH} D={D} Dv={Dv} causal={causal} "
                f"q_offset={q_off} {dt} ({'wgmma' if tc else 'SIMT'} "
                f"kernel): max |kernel - plain| {err:.3e} (tol "
                f"{FLASH_TOL[dt]}){row_txt}")
            if label != "prefill" or dt != "bfloat16":
                continue
            flash_faults(torch, kfa, q, k, v, want)
            record = flash_timing(torch, F, kfa, q, k, v, got, case)
    record["max_abs_err"] = max(errs.values())
    log("kernels", f"flash_attention: max |kernel - plain| {errs} over "
        f"every case; bf16 row-relative {row_max:.3e} (bar {FLASH_ROW_TOL})")
    return record


def flash_timing(torch, F, kfa, q, k, v, got, case) -> dict:
    """The bf16 kernel at the prefill shape in turns with
    scaled_dot_product_attention (the yardstick; the port never calls
    it), its device-only time, the plain version's time and the bound."""
    label, B, Sq, Sk, H, KVH, D, Dv, causal, q_off = case
    nbytes, ops = flash_work(B, Sq, Sk, H, KVH, D, Dv, causal, q_off,
                             q.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    bound = max(t_bytes, t_ops)
    by = "operations" if t_ops >= t_bytes else "bytes"
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    kernel = lambda: kfa.flash_attention(  # noqa: E731
        q, k, v, causal=causal, q_offset=q_off)
    lib_err = max_abs_err(torch, sdpa().transpose(1, 2), got)
    times = windows_ms(torch, {"kernel": kernel, "sdpa": sdpa}, FLASH_ORDER,
                       FLASH_WINDOWS, FLASH_CALLS)
    med = {n: statistics.median(t) for n, t in times.items()}
    spread = {n: (min(t), max(t)) for n, t in times.items()}
    d_us = device_us(torch, kernel, "flash_attention_sm90_kernel", iters=20)
    # Host time per call: the wrapper's checks, three tensor-map encodes,
    # the shared-memory opt-in and the launch, with the card still busy
    # with earlier calls (the launch queue does not fill in 20 calls).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FLASH_CALLS):
        kernel()
    host_us = (time.perf_counter() - t0) / FLASH_CALLS * 1e6
    torch.cuda.synchronize()
    p_ms = cuda_ms(torch, lambda: kfa.flash_attention_plain(
        q, k, v, causal=causal, q_offset=q_off), iters=5)
    k_ms, lib_ms = med["kernel"], med["sdpa"]
    d_txt = "not measured" if d_us is None else f"{d_us:.3f} us"
    log("kernels", f"flash_attention prefill shape bfloat16, in turns "
        f"{'/'.join(FLASH_ORDER)} ({FLASH_WINDOWS} windows of "
        f"{FLASH_CALLS} calls per turn): kernel median {k_ms:.6f} ms per "
        f"call (windows {spread['kernel'][0]:.6f}-{spread['kernel'][1]:.6f}"
        f"; device-only {d_txt}), scaled_dot_product_attention (enable_gqa"
        f"; max |sdpa - kernel| {lib_err:.3e}) median {lib_ms:.6f} ms "
        f"(windows {spread['sdpa'][0]:.6f}-{spread['sdpa'][1]:.6f}); "
        f"kernel / sdpa {k_ms / lib_ms:.3f}")
    log("kernels", f"flash_attention prefill shape bfloat16: plain "
        f"{p_ms:.6f} ms; bound {bound:.6f} ms by {by} ({nbytes} B at 3.35 "
        f"TB/s = {t_bytes:.6f} ms; {ops} operations at 989e12/s = "
        f"{t_ops:.6f} ms); kernel {ops / k_ms / 1e9:.1f} TFLOP/s, "
        f"{k_ms / bound:.2f}x its bound ({bound / k_ms:.1%} of it); sdpa "
        f"{ops / lib_ms / 1e9:.1f} TFLOP/s; host time per kernel call "
        f"{host_us:.3f} us (wrapper, tensor-map encodes, launch)")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, device_us=d_us,
                tflops=ops / k_ms / 1e9)


# ---------------------------------------------------------------------------
# The model zoo's serving path at internlm2-1.8b's full width
# ---------------------------------------------------------------------------

MODEL_ARCH = "internlm2-1.8b"
MODEL_B, MODEL_S, MODEL_MAX_LEN, MODEL_DECODE = 4, 2048, 2112, 32
# max|d| / max|logits|.  EXACT_TOL is the float32 logit bound of the
# port's CPU tests, held on a float32 copy of the weights for the kernel
# against its plain version and for decode against the full forward.  In
# bf16 this 24-layer random-weight model's own rounding noise is ~2e-2
# (the plain flash lands ~1.6e-2 from the float32 forward, PERF.md), so
# the bf16 logits are held to NOISE_TOL, against each other and against
# the float32 forward.  A planted fault (the decode step written one slot
# off) must exceed EXACT_TOL in float32 and NOISE_TOL in bf16.
EXACT_TOL = 1e-4
NOISE_TOL = 5e-2


def rel_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-9)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _answer(torch, cfg, params, toks, flash):
    """prefill -> greedy first token -> one decode step, the full forward
    over S + 1 tokens, and the same decode step on a cache one slot off
    (a planted fault); ``flash`` is the attention prefill uses."""
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    kernel_flash = L.flash_attention
    L.flash_attention = flash
    try:
        cache, logits = D.prefill(cfg, params, {"tokens": toks},
                                  MODEL_MAX_LEN)
        tok = logits.argmax(-1).to(torch.int32)
        step, _ = D.decode_step(cfg, params, cache, tok)
        bad, _ = D.decode_step(cfg, params, dict(cache, pos=cache["pos"] + 1),
                               tok)
        del cache
        full = torch.cat([toks, tok[:, None]], dim=1)
        h, _ = T.backbone(cfg, params, T.embed_inputs(cfg, params,
                                                      {"tokens": full}))
        h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
        want = T.lm_head_logits(cfg, params, h[:, -1:, :])[:, 0]
    finally:
        L.flash_attention = kernel_flash
    return logits, step, want, bad


def _profile(torch, fn, label: str) -> None:
    """Device busy share of ``fn`` and its heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = device_rows(prof)
    if not rows:
        log("model", f"{label}: device time not measured (the profiler saw "
            "no CUDA activity)")
        return
    busy = sum(r[0] for r in rows) / 1e6
    log("model", f"{label} under the profiler: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy * 1e3:.2f} ms ({busy / wall:.2%}; idle "
        f"{1 - busy / wall:.2%})")
    for dev_us, count, key in rows[:6]:
        share = dev_us / 1e6 / busy
        log("model", f"  {dev_us / 1e3:.3f} ms device ({share:.1%} of busy),"
            f" {count} calls: {key[:80]}")


def phase_model(torch, np) -> dict:
    """Answer a few requests at full width, check them, then serve() under
    each policy.  Returns the flash kernel's launches of the counted run."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import serve as srv
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T

    import dataclasses

    dev = torch.device("cuda")
    cfg = registry.get_config(MODEL_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _tensors(params))
    log("model", f"{cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV, "
        f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; {n_par} parameters drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MODEL_B, MODEL_S)).astype(np.int32)).to(dev)
    B, S, n_layers = MODEL_B, MODEL_S, cfg.num_layers

    # The path's run: prefill + greedy decode, launch count from 0.
    torch.cuda.synchronize()
    kfa.flash_attention.launches = 0
    kfa.flash_attention.sm90_launches = 0
    t0 = time.perf_counter()
    cache, logits = D.prefill(cfg, params, {"tokens": toks}, MODEL_MAX_LEN)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    n_prefill = kfa.flash_attention.launches
    n_tc = kfa.flash_attention.sm90_launches
    tok = logits.argmax(-1).to(torch.int32)
    step_logits = []
    t0 = time.perf_counter()
    for _ in range(MODEL_DECODE):
        lg, cache = D.decode_step(cfg, params, cache, tok)
        step_logits.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = kfa.flash_attention.launches
    if n_prefill != n_layers or launches != n_layers or n_tc != n_layers:
        raise AssertionError(f"flash launches: {n_prefill} in prefill "
                             f"({n_tc} on the bf16 tensor-core kernel), "
                             f"{launches} after decode; expected {n_layers}")
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(x).all()) for x in step_logits)
    if not finite:
        raise AssertionError("non-finite logits")
    if int(cache["pos"]) != S + MODEL_DECODE:
        raise AssertionError(f"cache pos {int(cache['pos'])}")
    peak = torch.cuda.max_memory_allocated()

    # A second prefill, warm, for the rate (and 24 more launches).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D.prefill(cfg, params, {"tokens": toks}, MODEL_MAX_LEN)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    if kfa.flash_attention.launches != 2 * n_layers:
        raise AssertionError("the second prefill did not launch the flash "
                             "kernel once per layer")
    log("model", f"prefill B={B} S={S} max_len {MODEL_MAX_LEN}: "
        f"{t_pre * 1e3:.2f} ms warm ({B * S / t_pre:.1f} tokens/s; first "
        f"call {t_first * 1e3:.2f} ms), flash launches {n_prefill} per "
        f"prefill, all {n_tc} on the bf16 wgmma kernel; {MODEL_DECODE} greedy decode steps {t_dec * 1e3:.2f} ms "
        f"({t_dec / MODEL_DECODE * 1e3:.3f} ms per step, "
        f"{B * MODEL_DECODE / t_dec:.1f} tokens/s); every logit finite; "
        f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)")
    _profile(torch, lambda: D.prefill(cfg, params, {"tokens": toks},
                                      MODEL_MAX_LEN), "one prefill")

    def steps():
        c, t = cache, tok
        for _ in range(8):
            _, c = D.decode_step(cfg, params, c, t)
    _profile(torch, steps, "8 decode steps")
    del cache

    # Exactness on a float32 copy of the weights (TF32 is off), then the
    # bf16 path against that float32 forward.
    errs, faults = {}, {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")   # a float32 cache
    for label, c, p in (("bf16", cfg, params),
                        ("f32", cfg32, _tree_map(lambda t: t.float(),
                                                 params))):
        k_out = _answer(torch, c, p, toks, kfa.flash_attention)
        p_out = _answer(torch, c, p, toks, kfa.flash_attention_plain)
        errs[label] = dict(kernel_vs_plain=rel_err(torch, k_out[0], p_out[0]),
                           decode_vs_full=rel_err(torch, k_out[1], k_out[2]),
                           plain_decode_vs_full=rel_err(torch, p_out[1],
                                                        p_out[2]))
        faults[label] = rel_err(torch, k_out[3], k_out[2])
        if label == "bf16":
            bf16 = (k_out, p_out)
        else:
            f32 = k_out
            del p
    (kb, pb), ref = bf16, f32
    errs["bf16_vs_f32"] = dict(
        kernel_prefill=rel_err(torch, kb[0], ref[0]),
        plain_prefill=rel_err(torch, pb[0], ref[0]),
        kernel_decode=rel_err(torch, kb[1], ref[1]),
        fault_decode=rel_err(torch, kb[3], ref[1]))
    for label, e in errs.items():
        log("model", f"logits max|d|/max|logits|, {label}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in e.items()))
    log("model", f"planted fault (decode one slot off) vs the full forward: "
        f"f32 {faults['f32']:.3e} (bound {EXACT_TOL}), bf16 "
        f"{faults['bf16']:.3e} (bf16 bound {NOISE_TOL}; against the "
        f"float32 forward {errs['bf16_vs_f32']['fault_decode']:.3e})")
    bad = [f"f32 {k}" for k, v in errs["f32"].items() if v > EXACT_TOL] + \
        [f"bf16 {k}" for k, v in errs["bf16"].items() if v > NOISE_TOL] + \
        [f"bf16 vs f32 {k}" for k, v in errs["bf16_vs_f32"].items()
         if v > NOISE_TOL and k != "fault_decode"]
    for label, tol in (("f32", EXACT_TOL), ("bf16", NOISE_TOL)):
        if not faults[label] > tol:
            bad.append(f"the planted fault passed the {label} bound "
                       f"({faults[label]!r})")
    if bad:
        raise AssertionError(f"model logits beyond bounds: {bad} {errs}")
    log("model", f"float32: kernel == plain and decode == full forward "
        f"within {EXACT_TOL}; bf16 within {NOISE_TOL} of each other and of "
        "the float32 forward; the planted fault beyond both bounds")
    del bf16, f32, kb, pb, ref

    # The port's serve() at full width with the reference CLI's defaults.
    # The first run measures the decode step; the others reuse its cost,
    # so that the three policies schedule the same virtual workload.
    cost = None
    for policy in ("pspice", "random", "admission"):
        t0 = time.perf_counter()
        out = srv.serve(cfg, params, requests=64, rate=50.0, policy=policy,
                        slots=16, slo=1.0, max_len=96, device=dev,
                        step_cost=cost, log=lambda s: log("model", s))
        cost = out["step_cost"]
        m = out["metrics"]
        log("model", f"serve {policy}: decode_step "
            f"{cost * 1e3:.3f} ms at B=16 (measured in the pspice run), "
            f"{out['decode_steps']} real decode steps, metrics {m}, wall "
            f"{time.perf_counter() - t0:.2f} s")
        if out["finished"] != 64 or m["completed"] + m["evicted"] != 64:
            raise AssertionError(f"serve {policy}: {out['finished']} of 64 "
                                 "requests finished")
    return {"flash_attention": launches}


def phase_build_report(_build, build_log: str) -> None:
    """ptxas's registers, spills and static shared memory of the block
    kernel's two instantiations (the store in shared or in device
    memory), of the bf16 flash kernel's instances and of the probe, and
    any ptxas advisory about the flash kernel.  A spill in the flash
    kernel fails the phase."""
    for name, regs, st, ld, smem in ptxas_report(build_log,
                                                 "block_step_kernel"):
        store = "shared" if "ILb1E" in name else "global"
        log("build", f"ptxas block_step_kernel<{store} store> ({name}): "
            f"{regs} registers, spill stores {st} B, spill loads {ld} B, "
            f"static smem {smem} B (dynamic smem per launch: the kernels "
            "phase)")
    for name, regs, st, ld, smem in ptxas_report(
            build_log, "flash_attention_sm90_kernel") + ptxas_report(
            build_log, "wgmma_probe_kernel"):
        log("build", f"ptxas {name}: {regs} registers, spill stores {st} "
            f"B, spill loads {ld} B, static smem {smem} B")
        if "flash_attention_sm90_kernel" in name and (st or ld):
            raise AssertionError(f"{name} spills ({st} B stored, {ld} B "
                                 "loaded)")
    sec = build_log.split("== flash_attention_sm90.cu", 1)[-1]
    for line in sec.splitlines():
        if "C75" in line or "setmaxnreg" in line:
            log("build", f"ptxas advisory: {line.strip()[:200]}")
    if _build.build_seconds is not None:
        log("build", f"nvcc wall time of this build {_build.build_seconds:.2f}"
            " s (every source in parallel)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    phases = ap.parse_args().phases.split(",")

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing next to "
              f"this script ({e})", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{smi}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; devices {torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    _build.load()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.2f}"
        f" s ({_build.build_dir()})")
    build_log = (_build.build().parent / "build.log").read_text()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())
    phase_build_report(_build, build_log)

    record = {}
    timings = {}
    for phase, fn in (("kernels", lambda: phase_kernels(torch, np)),
                      ("parity", lambda: phase_parity(torch, np)),
                      ("main", lambda: phase_main(torch)),
                      ("quality", lambda: phase_quality(torch, np)),
                      ("runtime", lambda: phase_runtime(torch, np)),
                      ("resilience", lambda: phase_resilience(torch, np)),
                      ("recovery", lambda: phase_recovery(torch, np)),
                      ("profile", lambda: [phase_profile(torch, b) for b in
                                           ("cuda", "cuda_block")]),
                      ("model", lambda: phase_model(torch, np))):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        out = fn()
        timings[phase] = time.perf_counter() - t0
        log(phase, f"phase done in {timings[phase]:.2f} s")
        if phase == "kernels":
            record = out
        if phase in ("main", "runtime", "resilience", "model"):
            for name, n in out.items():
                if isinstance(n, dict):
                    record.setdefault(name, {}).update(n)
                else:
                    record.setdefault(name, {})["launches"] = n
        if phase == "quality":
            for name, n in out.items():
                record.setdefault(name, {})["quality_launches"] = n
    log("total", f"{time.perf_counter() - t_all:.2f} s; phases {timings}")

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = record.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=r.get("launches", 0), max_abs_err=r.get("max_abs_err"),
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by", "bytes"),
            library_ms=r.get("library_ms")))
        for extra in ("us_per_event", "call_ms", "host_us_per_launch",
                      "store", "smem_bytes", "lanes", "ms_by_lanes",
                      "bound_ms_by_lanes", "quality_launches", "device_us",
                      "launch_floor_us", "launch_floor_device_us",
                      "lanes_ms", "lanes_plain_ms", "lanes_bound_ms",
                      "lanes_device_us",
                      "trim_ms", "trim_lane_by_lane_ms", "trim_launches",
                      "trim_lane_by_lane_launches"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
