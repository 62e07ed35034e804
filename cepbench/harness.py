"""One run of one cell: set-up, warm-up, the measured window, the traced
reductions and the check of ``correct``.

The system under test is the port's streaming runtime,
``repro_torch.runtime.MultiTenantRuntime``: L tenant lanes in lockstep,
one launch of the block kernel's lane instance per W-event block.  The
harness drives it in a closed loop, one push a chunk: the next push is
issued when the last returns, which is when its telemetry is on the
host.  Each lane runs sessions of ``session_events`` events, each session
on a fresh runtime (its construction is in the window); the session
sets are made from the seed at set-up and used in turn.

Everything the harness reads of a cell sits in files found by name:
``configs/<config>.json``, ``cells/<cell>.json`` (the traffic),
``metrics/<metric>.py`` (a per-layer metric's reader).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import importlib.util
import json
import multiprocessing
import pathlib
import sys
import time

import numpy as np

from cepbench import check as CK, traffic

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


# Every key of a cell file, and of a configuration file, that the
# harness runs by.  A file with another key is refused: a cell that
# asks for what the harness does not do (an open loop, another runtime,
# drifting traffic) needs the harness to do it first.
CELL_KEYS = {"lanes", "push_events", "session_events", "session_sets",
             "rate_lo", "rate_hi", "check_lanes"}
CONFIG_KEYS = {"generator", "patterns", "max_pms", "block_events",
               "chunk_events", "bin_size", "latency_bound", "warm_frac",
               "warm_seed", "shedder", "block_shed", "shed_plan",
               "backend", "cost", "limits"}
CONFIG_NOTES = {"name", "source", "paper", "precision", "guarantees",
                "assumed", "reduced"}     # read by people, not the harness


def _keys_run(what: str, got: dict, run: set, notes: set = frozenset()):
    missing, extra = run - set(got), set(got) - run - notes
    if missing or extra:
        raise ValueError(f"{what}: the harness runs the keys "
                         f"{sorted(run)}; missing {sorted(missing)}, "
                         f"not run {sorted(extra)}")


def load_cell(name: str, root: pathlib.Path = ROOT) -> tuple:
    """(workload entry, configuration, traffic, end-to-end metrics,
    per-layer metrics) of cell ``name``, each metric list holding the
    metrics this cell reports."""
    man = manifest(root)
    wl = next((w for w in man["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in man["configs"] if c["name"] == wl["config"])
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    cell = json.loads((HERE / "cells" / f"{name}.json").read_text())
    _keys_run(cfg_entry["file"], cfg, CONFIG_KEYS, CONFIG_NOTES)
    _keys_run(f"cells/{name}.json", cell, CELL_KEYS)
    mine = lambda ms: [m for m in ms  # noqa: E731
                       if name in m.get("workloads", [name])]
    return wl, cfg, cell, mine(man["end_to_end"]), mine(man["per_layer"])


def metric_reader(name: str):
    """``read(trace)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cepbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or
    the JAX package's (whole names compared)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _leaves(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for x in tree:
            yield from _leaves(x)


class Program:
    """The system under test, built from a configuration: the pSPICE
    model (``runner.build_model``), the lane-stacked model, and a fresh
    ``MultiTenantRuntime`` per session."""

    def __init__(self, cfg: dict, cell: dict, device: str):
        import torch

        from repro_torch import runtime as RT
        from repro_torch.cep import engine as eng, patterns as pat, runner
        self.torch, self.RT, self.eng = torch, RT, eng
        self.dev = torch.device(device)
        self.L = cell["lanes"]
        specs = [getattr(pat, "make_" + p["query"].lower())(
            **{k: v for k, v in p.items() if k != "query"})
            for p in cfg["patterns"]]
        self.specs, cp = specs, pat.compile_patterns(specs)
        self.cp = cp
        self.cfg = runner.default_config(
            cp, max_pms=cfg["max_pms"], latency_bound=cfg["latency_bound"],
            shedder=cfg["shedder"], backend=cfg["backend"],
            block_events=cfg["block_events"], block_shed=cfg["block_shed"],
            shed_plan=cfg["shed_plan"], **cfg["cost"])
        self.rtc = RT.RuntimeConfig(chunk_size=cfg["chunk_events"])
        self.bin_size = cfg["bin_size"]

    def batch(self, ev: dict):
        t = self.torch
        return self.eng.EventBatch(*(
            t.from_numpy(np.ascontiguousarray(ev[k])).to(self.dev)
            for k in traffic.FIELDS))

    def build(self, warm: dict, ebl_mean: float):
        from repro_torch.cep import runner
        self.built = runner.build_model(self.specs, self.cfg,
                                        self.batch(warm),
                                        bin_size=self.bin_size, seed=0,
                                        device=self.dev)
        b = self.built
        model = self.eng.make_model(
            self.cp, self.cfg, ut_tables=b.ut_stacked, ut_bins=b.ut_bins,
            f_model=b.f_model, g_model=b.g_model, ebl_raw_mean=ebl_mean,
            device=self.dev)
        self.model = self.RT.broadcast_model(model, self.L)
        return b.max_rate

    def runtime(self):
        return self.RT.MultiTenantRuntime(self.cfg, self.model, self.L,
                                          rt=self.rtc, device=self.dev)

    def built_host(self) -> dict:
        b = self.built
        lat = lambda m: (float(m.a), float(m.b), int(m.kind))  # noqa: E731
        return dict(T=[t.cpu().numpy() for t in b.T],
                    R=[r.cpu().numpy() for r in b.R],
                    ut_tables=b.ut_stacked.cpu().numpy(),
                    ut_bins=b.ut_bins.cpu().numpy(), f=lat(b.f_model),
                    g=lat(b.g_model), steady_n_pm=b.steady_n_pm,
                    max_rate=b.max_rate)

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()


class Loop:
    """The closed loop over sessions.  ``check_push`` is the push whose
    start state is kept (copied on the device into a buffer made at
    set-up) in every session, for the check."""

    def __init__(self, prog: Program, cell: dict, sets_dev: list,
                 check_push: int):
        self.prog, self.cell, self.sets = prog, cell, sets_dev
        n, push = cell["session_events"], cell["push_events"]
        self.bounds = [(a, min(a + push, n)) for a in range(0, n, push)]
        self.check_push = check_push
        self.snap = None
        self.reset()

    def reset(self):
        self.push_ms, self.events, self.sessions = [], 0, []
        self.live = []          # PMs over every lane at each push's end
        self.ends = []          # each push's return (host clock)
        self.checked = None

    def _snapshot(self, rt):
        if self.snap is None:
            self.snap = [x.clone() for x in _leaves(rt.carry)]
        for d, s in zip(self.snap, _leaves(rt.carry)):
            d.copy_(s)

    def session(self, k: int, span, deadline: float | None) -> bool:
        """Session k on set k mod sets; False once the deadline passed."""
        s = k % len(self.sets)
        ev = self.sets[s]
        L = self.prog.L
        with span("session.start"):
            rt = self.prog.runtime()
        pushed = 0
        for q, (a, b) in enumerate(self.bounds):
            with span("harness"):
                piece = self.prog.eng.EventBatch(*(x[:, a:b] for x in ev))
                if q == self.check_push:
                    self._snapshot(rt)
            with span("push"):
                t1 = time.perf_counter()
                stats = rt.push(piece, flush=b == self.bounds[-1][1])
                t2 = time.perf_counter()
            self.push_ms.append((t2 - t1) * 1e3)
            self.ends.append(t2)
            if stats:
                self.live.append(stats[-1].n_pm_end)
            self.events += L * (b - a)
            pushed += L * (b - a)
            if q == self.check_push:
                self.checked = dict(set=s, start=a, stop=b,
                                    stats=[c.to_row() for c in stats],
                                    carry=[x for x in self.snap])
            # The window closes at the first push past the deadline once
            # a checked push has completed (within the first session on
            # the card).
            if deadline is not None and t2 >= deadline and \
                    self.checked is not None:
                self.sessions.append((pushed, rt.events_processed, False))
                return False
        self.sessions.append((pushed, rt.events_processed, True))
        return True


def draw_checked(seed: int, cell: dict) -> tuple:
    """The push (any but a session's first) and the lanes the check
    replays, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    n_push = len(range(0, cell["session_events"], cell["push_events"]))
    push = int(rng.integers(1, n_push))
    lanes = np.sort(rng.choice(cell["lanes"], cell["check_lanes"],
                               replace=False))
    return push, lanes


def _percentile(x: list, q: float) -> float:
    return float(np.percentile(np.asarray(x, np.float64), q))


def _span_fn(trace: bool):
    if not trace:
        return lambda name: contextlib.nullcontext()
    import torch
    return torch.profiler.record_function


def run(name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", root: pathlib.Path = ROOT,
        log=print, loaded: tuple | None = None) -> dict:
    """One run of cell ``name`` (``loaded``: its ``load_cell`` tuple, if
    given); returns the result line's object (its ``check`` key last).
    ``log`` takes the lines for standard error."""
    wl, cfg, cell, e2e, per_layer = loaded or load_cell(name, root)
    prog = Program(cfg, cell, device)
    torch = prog.torch
    if prog.dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.load()
    check_push, check_lanes = draw_checked(seed, cell)
    t_data = time.perf_counter()
    sets = traffic.session_sets(cfg, cell, seed)
    warm = traffic.warm_stream(cfg, cell["session_events"])
    t_build = time.perf_counter()
    capacity = prog.build(warm, float(warm["ebl"].mean()))
    prog.sync()
    t_warm = time.perf_counter()
    rates = traffic.lane_rates(cell, capacity)
    arr = np.stack([traffic.arrivals(cell["session_events"], r)
                    for r in rates])
    for s in sets:
        s["arrival"] = arr
    sets_dev = [prog.batch(s) for s in sets]
    loop = Loop(prog, cell, sets_dev, check_push)
    nul = _span_fn(False)
    loop.session(0, nul, None)          # warm-up: every shape, one session
    prog.sync()
    loop.reset()
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    span = _span_fn(trace)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: imports and the kernel library "
        f"{t_data - t_start:.3f} s, data {t_build - t_data:.3f} s, model "
        f"build {t_warm - t_build:.3f} s, warm-up session "
        f"{time.perf_counter() - t_warm:.3f} s; capacity {capacity!r} "
        f"events/s a lane; lanes at {rates[0]:.3f}..{rates[-1]:.3f} "
        f"events/s")
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if prog.dev.type == "cuda" else []))
    # The collector would stop the loop at moments of its own choosing.
    gc.collect()
    gc.disable()
    with prof:
        t0 = time.perf_counter()
        k = 0
        while loop.session(k, span, t0 + seconds):
            k += 1
        prog.sync()
        t1 = time.perf_counter()
    gc.enable()
    window = t1 - t0
    launches = sum(kops.launch_counts().values())
    peak = torch.cuda.max_memory_allocated(prog.dev) \
        if prog.dev.type == "cuda" else 0
    log(f"window {window:.3f} s: {len(loop.push_ms)} pushes, "
        f"{len([s for s in loop.sessions if s[2]])} whole sessions, "
        f"{loop.events} events, {launches} launches; push ms p50 "
        f"{_percentile(loop.push_ms, 50):.4f} p95 "
        f"{_percentile(loop.push_ms, 95):.4f} over {len(loop.push_ms)} "
        f"pushes")
    by_s = np.bincount((np.asarray(loop.ends) - t0).astype(int))
    log("pushes in each second of the window: " +
        " ".join(str(int(x)) for x in by_s) + "; push ms min, p5, p25, "
        "p50, p75, p95, max: " + " ".join(
            f"{_percentile(loop.push_ms, q):.4f}"
            for q in (0, 5, 25, 50, 75, 95, 100)))
    values = {"events_per_s": loop.events / window,
              "push_ms_p95": _percentile(loop.push_ms, 95),
              "setup_s": setup_s}
    metrics, breakdown, busy = {}, None, None
    if trace:
        from cepbench import tracing
        counts = {"pushes": len(loop.push_ms), "launches": launches,
                  "events": loop.events,
                  "mean_live_pms": float(np.mean(loop.live))}
        tr = tracing.from_profiler(prof, counts, cfg, cell)
        for m in per_layer:
            v = metric_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = tracing.breakdown(tr)
        busy = (tracing.busy_ns(tr) * 1e-9, tr.window_s)
        del prof, tr
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    # -- the check, once the window has closed and the state is freed -----
    ck = loop.checked
    ck["carry"] = dict(zip(_carry_names(), [x.cpu().numpy()
                                           for x in ck["carry"]]))
    built = prog.built_host()
    unprocessed = sum(p - d for p, d, whole in loop.sessions if whole)
    n_pushes = len(loop.push_ms)
    del loop, sets_dev, prog
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = compare(cfg, cell, sets, warm, built, ck, check_lanes)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    readings["events_unprocessed"] = (float(unprocessed), None)
    limits = cfg["limits"]
    numbers = {k: [v[0], limits[k]] for k, v in readings.items()
               if k in limits}
    ok = all(v <= lim for v, lim in numbers.values())
    for k, v in readings.items():
        if v[1]:
            log(v[1])
    out = {"correct": ok, "attempted": n_pushes, "failed": 0,
           "metrics": metrics,
           "device": device_info(device, peak, busy)}
    if breakdown is not None:
        out["breakdown"] = breakdown
    for k, (v, lim) in numbers.items():
        log(f"check {k} {v!r} limit {lim!r}")
    out["check"] = numbers
    return out


def _carry_names() -> list[str]:
    from repro_torch.cep import engine as eng
    names = []
    for f in eng.Carry._fields:
        names += list(eng.PMStore._fields) if f == "pms" else [f]
    return names


PUSH_SHARES = 4        # workers the all-lane replay of the push takes


def compare(cfg: dict, cell: dict, sets: list, warm: dict, built: dict,
            ck: dict, lanes, precision: str = "float32") -> dict:
    """The comparisons in worker processes; name → (reading, note).  The
    reference builds its model first; both replays run on that build,
    each sampled lane and each share of the push in a worker of its
    own."""
    ev = sets[ck["set"]]
    a, b = ck["start"], ck["stop"]
    cut = lambda rows, lo, hi: {k: ev[k][rows, lo:hi]  # noqa: E731
                                for k in ("cls", "bind", "open", "id",
                                          "arrival")}
    ctx = multiprocessing.get_context("spawn")
    shares = np.array_split(np.arange(cell["lanes"]),
                            min(PUSH_SHARES, cell["lanes"]))
    with concurrent.futures.ProcessPoolExecutor(
            len(lanes) + len(shares), mp_context=ctx) as pool:
        res_model = pool.submit(CK.model, dict(
            config=cfg, warm=warm, built=built,
            precision=precision)).result()
        model = res_model.pop("built")
        whole = [pool.submit(CK.lanes, dict(
                     config=cfg, events=cut([ln], 0, a), lanes=[ln],
                     start=a, carry=ck["carry"], model=model,
                     precision=precision)) for ln in lanes]
        parts = [pool.submit(CK.push_part, dict(
                     config=cfg, events=cut(sh, a, b), lanes=sh, start=a,
                     carry=ck["carry"], model=model, precision=precision))
                 for sh in shares]
        results = [res_model, CK.merge_lanes([f.result() for f in whole]),
                   CK.push_compare(
                       [f.result() for f in parts], ck["stats"],
                       f"events [{a}, {b}) of {cell['lanes']} lanes",
                       precision)]
    out = {}
    for res in results:
        note = res.pop("note")
        for k, v in res.items():
            out[k] = (float(v), note)
            note = None
    return out


def device_info(device: str, peak: int, busy) -> dict:
    import torch
    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if busy is not None:
        info["busy_s"], info["window_s"] = busy
    return info

