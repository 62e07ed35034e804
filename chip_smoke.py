#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as on the H100
    python3 chip_smoke.py --phases card,build,kernels

Phases (one line each; any failure raises and exits non-zero):
  card     the GPU's name and power limit, torch/CUDA versions; TF32 off
  build    compiles repro_torch/csrc with nvcc (sm_90a) and loads it
  kernels  each CUDA kernel against its plain PyTorch version, bitwise,
           at the stock shapes (P=3, N=256), at N=2048 and at a ragged
           N=1000, plus an all-inactive and a NaN-laden case; times
           against the memory bound
  parity   the engine on stock specs, N=2048, 3000 events, all four
           shedders with fires: backend "cuda" on the card == backend
           "torch" on the card == backend "torch" on the CPU, whole carry
           and every StepOut, bitwise
  main     run_experiment on the stock scenario at its full 30000 events
           (backend "cuda"), launch counts of every kernel, the headline
           FN ordering and the committed headline within a tolerance;
           then soccer and bus at 12000 events
  profile  torch.profiler over one stock pspice run (backend "cuda"):
           device busy time by kernel and the device's idle share
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
}


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
                        ) & (state >= 0) & (state < M) & (cls >= 0) &         (cls < C1)
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
        record[name]["max_abs_err"] = err
        log("kernels", f"{name}: max |kernel - plain| {err!r} over every "
            "case and N")
    return record


# ---------------------------------------------------------------------------
# Engine parity: cuda on the card == torch on the card == torch on the CPU
# ---------------------------------------------------------------------------

def phase_parity(torch, np, runs=(("cuda@gpu", "cuda", "cuda"),
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

def run_scenario(torch, name: str, n: int, device: str = "cuda"
                 ) -> tuple[dict, dict, float, int]:
    from repro_torch.cep import engine as eng, runner
    from repro_torch.data import streams
    from repro_torch.kernels import ops as kops

    sc = streams.get_scenario(name)
    raw = sc.raw(n=n)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    kops.reset_launch_counts()
    eng.host_syncs = 0
    sync()
    t0 = time.perf_counter()
    res = runner.run_experiment(
        sc.specs(), raw, shedders=("pspice", "pmbl", "ebl"),
        rate_multiplier=1.2, max_pms=sc.max_pms, bin_size=sc.bin_size,
        latency_bound=sc.latency_bound, seed=sc.seed, backend="cuda",
        device=device, **COST)
    sync()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    syncs = eng.host_syncs
    n_run = raw.n - int(raw.n * 0.3)
    for sh, er in res.items():
        log("main", f"{name} n={n} {sh}: fn {er.fn:.6f} fn_match "
            f"{er.fn_match:.6f} lb_compliance {er.lb_compliance:.6f} "
            f"shed_calls {er.result.shed_calls:g} run {er.seconds:.2f} s "
            f"({n_run / er.seconds:.1f} events/s)")
    fn = {sh: er.fn_match for sh, er in res.items()}
    if not (fn["pspice"] <= fn["pmbl"] + 1e-9 and
            fn["pspice"] <= fn["ebl"] + 1e-9):
        raise AssertionError(f"{name}: headline ordering violated: {fn}")
    events = n_run * 4 + int(raw.n * 0.3)
    log("main", f"{name}: wall {wall:.2f} s for {events} engine events "
        f"({events / wall:.1f} events/s); launches {counts}; host syncs "
        f"{syncs} ({syncs / events:.3f} per event); ordering ok {fn}")
    return res, counts, wall, events


def phase_main(torch) -> dict:
    res, counts, _, _ = run_scenario(torch, "stock", 30000)
    for name, k in counts.items():
        if k <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    for sh, want in STOCK_HEADLINE.items():
        got = res[sh].fn_match
        if abs(got - want) > HEADLINE_TOL:
            raise AssertionError(f"stock {sh} FN {got:.4f} vs committed "
                                 f"{want:.4f} beyond {HEADLINE_TOL}")
    log("main", f"stock FN within {HEADLINE_TOL} of the committed headline "
        f"{STOCK_HEADLINE}")
    for name in ("soccer", "bus"):
        run_scenario(torch, name, 12000)
    return counts


# ---------------------------------------------------------------------------
# Where the time goes: one engine run under torch.profiler
# ---------------------------------------------------------------------------

def phase_profile(torch, n: int = 6000, device: str = "cuda") -> None:
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cep import engine as eng, patterns as pat, runner
    from repro_torch.data import streams

    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=sc.max_pms,
                                latency_bound=sc.latency_bound,
                                emit_matches=True, backend="cuda", **COST)
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
    log("profile", f"stock pspice N={sc.max_pms} {n} events, backend cuda: "
        f"wall {wall:.3f} s unprofiled ({n / wall:.1f} events/s, "
        f"{wall / n * 1e3:.4f} ms/event), fires "
        f"{float(carry.shed_calls):g}; device busy {busy:.4f} s "
        f"({busy / wall:.4%} of wall; idle {1 - busy / wall:.4%})")
    for dev_us, count, key in rows[:8]:
        log("profile", f"  {dev_us / 1e3:.3f} ms device, {count} calls, "
            f"{dev_us / max(count, 1):.3f} us/call: {key[:90]}")


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
                      ("profile", lambda: phase_profile(torch))):
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
