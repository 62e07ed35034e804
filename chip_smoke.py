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
           N=2048, bus ANY/in-windows, soccer ANY/at-open with E-BL);
           times against the memory bound
  parity   the engine on stock specs, N=2048, 3000 events, all four
           shedders with fires: backends "cuda" and "cuda_block" on the
           card == backend "torch" on the card == backend "torch" on the
           CPU, whole carry and every StepOut, bitwise
  main     run_experiment on the stock scenario at its full 30000 events
           and on soccer and bus at 12000, first through the per-event
           kernels (backend "cuda"), then through the block kernel
           (backend "cuda_block"), with the launch counts of each path's
           kernels; the headline FN ordering, the committed headline
           within a tolerance, and FN, fires and compliance equal across
           the two paths
  profile  torch.profiler over one stock pspice run per path: device
           busy time by kernel and the device's idle share
The last lines are the kernels' JSON record, the nvidia-smi line and the
contract line.  The script needs CUDA and the repository around it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PHASES = ("card", "build", "kernels", "parity", "main", "profile")

# The paper's simulated-time costs (src/repro/configs/pspice_paper.py:20).
COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4, c_shed_pm=5e-7,
            c_ebl=6e-5)
# The committed stock headline at 1.2x overload (match-set FN ratio of
# pspice / pmbl / ebl, BENCH_quality.json), and how far the port may sit
# from it: its model builder sums in another order than the reference's.
STOCK_HEADLINE = {"pspice": 0.22988505747126442,
                  "pmbl": 0.4022988505747126, "ebl": 0.3563218390804598}
HEADLINE_TOL = 0.05
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate

KERNEL_META = {
    "nfa_advance": ("src/repro_torch/csrc/nfa_transition.cu",
                    "src/repro/kernels/nfa_transition.py:26"),
    "utility_lookup": ("src/repro_torch/csrc/shed_select.cu",
                       "src/repro/kernels/shed_select.py:38"),
    "utility_histogram": ("src/repro_torch/csrc/shed_select.cu",
                          "src/repro/kernels/shed_select.py:115"),
    "block_step": ("src/repro_torch/csrc/block_step.cu",
                   "src/repro/kernels/block_step.py:87"),
}
# The engine path whose run counts each kernel's launches.
KERNEL_PATH = {"nfa_advance": "cuda", "utility_lookup": "cuda",
               "utility_histogram": "cuda", "block_step": "cuda_block"}
W_BLOCK = 32                       # block_events on the block path


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
    errs = dict.fromkeys(KERNEL_META, 0.0)
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
                                            bound_ms=bound)
    for name, err in errs.items():
        if name == "block_step":
            continue
        record[name]["max_abs_err"] = err
        log("kernels", f"{name}: max |kernel - plain| {err!r} over every "
            "case and N")
    record["block_step"] = phase_block_kernel(torch, np)
    return record


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


def phase_block_kernel(torch, np) -> dict:
    from repro_torch.cep import block_cases, convert
    from repro_torch.kernels import block_step as kb

    dev = torch.device("cuda")
    record, err = {}, 0.0
    for name, N, shedder in block_cases.CASES:
        cfg, model, carry, blk, i0 = block_cases.firing_block(
            name, N, shedder, dev, W=W_BLOCK, **COST)
        saved = convert.tree_to_numpy(carry)
        work = {}
        for label, fn in (("kernel", kb.block_step),
                          ("plain", kb.block_step_plain)):
            c = convert.carry_from_numpy(saved, dev)
            rows = kb.new_rows(cfg, W_BLOCK, dev)
            c, rows, status = fn(cfg, model, c, blk, i0, 0, W_BLOCK, rows)
            torch.cuda.synchronize()
            work[label] = (c, rows, status)
        (ck, rk, sk), (cp_, rp, sp) = work["kernel"], work["plain"]
        pairs = list(zip(carry_leaves(ck), carry_leaves(cp_))) + \
            [(rk[k], rp[k]) for k in rk] + [(sk, sp)]
        if not all(same(torch, a, b) for a, b in pairs):
            raise AssertionError(f"block_step != plain on {name} N={N} "
                                 f"{shedder}")
        err = max([err] + [max_abs_err(torch, a, b) for a, b in pairs])
        fires = int(sp[0])
        if shedder in ("pspice", "pmbl") and fires < 1:
            raise AssertionError(f"block {name} N={N} {shedder}: no fire")
        # Times: each launch starts from the same carry, restored by
        # copies that are timed alone and subtracted.
        base = convert.carry_from_numpy(saved, dev)
        c = convert.carry_from_numpy(saved, dev)
        rows = kb.new_rows(cfg, W_BLOCK, dev)

        def restore():
            for dst, src in zip(carry_leaves(c), carry_leaves(base)):
                dst.copy_(src)

        def launch():
            restore()
            kb.block_step(cfg, model, c, blk, i0, 0, W_BLOCK, rows)

        def plain():
            restore()
            kb.block_step_plain(cfg, model, c, blk, i0, 0, W_BLOCK, rows)

        # The kernel's own time is its device time in the profiler (the
        # host-clocked restore + launch pairs are host-bound); the plain
        # version's is host-clocked, less the restore.
        t_restore = cuda_ms(torch, restore, iters=100)
        d_us = device_us(torch, launch, "block_step_kernel", iters=20)
        k_ms = d_us / 1e3 if d_us is not None else \
            cuda_ms(torch, launch, iters=100) - t_restore
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
            f"{fires} fires in the block): bitwise ok; kernel "
            f"{k_ms:.6f} ms per launch ({k_ms / W_BLOCK * 1e3:.3f} us per "
            f"event; {src}), plain {p_ms:.6f} ms, library none, bound "
            f"{bound:.6f} ms ({nbytes} B at 3.35 TB/s)")
        if (name, N, shedder) == block_cases.CASES[0]:
            record = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                          us_per_event=k_ms / W_BLOCK * 1e3)
    record["max_abs_err"] = err
    log("kernels", f"block_step: max |kernel - plain| {err!r} over every "
        "case")
    return record


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
                                **COST)
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
        block_events=W_BLOCK, device=device, **COST)
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
            for sh, want in STOCK_HEADLINE.items():
                got = runs["cuda_block"][sh].fn_match
                if abs(got - want) > HEADLINE_TOL:
                    raise AssertionError(f"stock {sh} FN {got:.4f} vs "
                                         f"committed {want:.4f} beyond "
                                         f"{HEADLINE_TOL}")
            log("main", f"stock FN within {HEADLINE_TOL} of the committed "
                f"headline {STOCK_HEADLINE}")
    return launches


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
                                block_events=W_BLOCK, **COST)
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
    rows = []
    for k in prof.key_averages():
        dev_us = getattr(k, "self_device_time_total",
                         getattr(k, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, k.count, k.key))
    rows.sort(reverse=True)
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
    for dev_us, count, key in rows:
        if "block_step_kernel" in key:
            log("profile", f"block kernel: {dev_us / count:.3f} us per "
                f"launch, {dev_us / n:.3f} us per event ({count} launches "
                f"for {n} events); {dev_us / 1e6 / wall:.4%} of wall")


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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    record = {}
    timings = {}
    for phase, fn in (("kernels", lambda: phase_kernels(torch, np)),
                      ("parity", lambda: phase_parity(torch, np)),
                      ("main", lambda: phase_main(torch)),
                      ("profile", lambda: [phase_profile(torch, b) for b in
                                           ("cuda", "cuda_block")])):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        out = fn()
        timings[phase] = time.perf_counter() - t0
        log(phase, f"phase done in {timings[phase]:.2f} s")
        if phase == "kernels":
            record = out
        if phase == "main":
            for name in record:
                record[name]["launches"] = out[name]
    log("total", f"{time.perf_counter() - t_all:.2f} s; phases {timings}")

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = record.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=r.get("launches", 0), max_abs_err=r.get("max_abs_err"),
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by="bytes", library_ms=None))
        if "us_per_event" in r:
            kernels[-1]["us_per_event"] = r["us_per_event"]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
