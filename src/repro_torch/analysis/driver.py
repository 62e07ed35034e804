"""check_all: sweep the config cells, evaluate every contract, emit the
findings (DESIGN.md §11).

Port of ``repro.analysis.driver`` with the port's backend names
("torch", "cuda", "cuda_block" for "xla", "pallas", "pallas_block") and
the reference's cell labels.  One cell = one contracted entry point
EXECUTED at one {backend x shedder x chunking} configuration: eager
PyTorch has no compiled artifact, so every rule reads what the run did.

A census only sees the code that runs: on the reference's quiet
workload (``_workload``) the per-event path spawns nothing, so the cells
run on the spawn-heavy overloaded one (``_workload_fired``), and each
cell's ``coverage`` finding proves it spawned, completed and shed.  The
cells are SMALL (96 events, N = 48) and run on the CPU as on the card;
on the card (``device="cuda"``, not ``quick``) the sweep adds the stock
main path's configuration at full width on "cuda_block" for each
shedder, one donated chunk of the runtime cell's 128 stock lanes, and
the build's kernel rules.

The retrace guard calls each entry again with fresh same-shape data
after warm-up and counts builds, library loads and plan-cache misses
against a budget of 0.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import tempfile

import torch

from repro_torch.analysis import contracts as C
from repro_torch.analysis import kernel_rules as KR
from repro_torch.analysis import rules as R
from repro_torch.analysis import tracing as T
from repro_torch.cep import engine as eng
from repro_torch.cep import patterns as pat
from repro_torch.cep import runner
from repro_torch.data import streams
from repro_torch.dist import sharding as DS
from repro_torch.runtime import lanes as LN
from repro_torch.runtime import persist as PS
from repro_torch.runtime import service as RTS

BACKENDS = eng.BACKENDS
SHEDDERS = (eng.SHED_NONE, eng.SHED_PSPICE, eng.SHED_PMBL, eng.SHED_EBL)

_COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4,
             c_shed_pm=1.5e-6, c_ebl=6e-5)
# The chunk cells run events [WARM, n) of the fired workload from the
# carry of events [0, WARM): the piece where every shedder fires.
WARM = 32
LANES = 2
# The full-width cells (PERF.md §4): the stock main path (3 x Q1,
# N = 256, W = 32, LB 0.05 s) at 1.2 x max_rate, and one donated chunk of
# the runtime cell's 128 lanes at 1.2..1.4 x max_rate.
STOCK_EVENTS, STOCK_RATE = 30000, 1.2
RT_LANES, RT_CHUNK, RT_WARM_CHUNKS = 128, 1024, 8


def _workload(n: int = 96, max_pms: int = 48, seed: int = 0, device=None,
              p_class: float = 0.05, latency_bound: float = 0.005):
    """The reference's q1 fixture (cfg varies per cell)."""
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=max_pms,
                                latency_bound=latency_bound,
                                gather_stats=True,
                                shedder=eng.SHED_PSPICE, **_COST)
    model = eng.make_model(cp, cfg, device=device)
    rate = 3.0 / (cfg.c_base + cfg.c_match * 0.3 * max_pms)
    raw = streams.gen_stock(n, num_symbols=50, pattern_symbols=4,
                            p_class=p_class, seed=100 + seed)
    ev = streams.classify(specs, raw, rate=rate, seed=seed, device=device)
    return cfg, model, ev


def _workload_fired(n: int = 96, max_pms: int = 48, seed: int = 0,
                    device=None):
    """Spawn-heavy overloaded fixture (tight bound, p_class=0.5): the
    Algorithm-1 check fires many times per block, so every branch of
    the per-event step and the block kernel's fused shed run."""
    return _workload(n, max_pms, seed, device, p_class=0.5,
                     latency_bound=0.001)


def _cells(quick: bool):
    """(backend, shedder) grid for run_engine; quick keeps one row and
    one column so tests touch every backend and every shedder once."""
    if not quick:
        return [(b, s) for b in BACKENDS for s in SHEDDERS]
    cells = [(b, eng.SHED_PSPICE) for b in BACKENDS]
    cells += [(eng.BACKEND_TORCH, s) for s in SHEDDERS
              if s != eng.SHED_PSPICE]
    return cells


def _cut(ev, a: int, b: int, axis: int = 0):
    return eng.EventBatch(*(x.narrow(axis, a, b - a).clone() for x in ev))


class _Sweep:
    """The findings of one sweep; on the card with the build's log for
    the kernels' static shared memory."""

    def __init__(self, device: torch.device, log_text: str | None):
        self.device, self.log_text = device, log_text
        self.findings: list = []
        self.arts: dict = {}

    def cell(self, entry: str, *args, name: str, n_events: int,
             owned: bool = False) -> None:
        fn, ctr = C.registry()[entry]
        art = R.run_artifact(fn, *args, name=name, n_events=n_events,
                             owned=owned)
        self.findings += R.run_rules(art, ctr) + \
            KR.check_kernel_launches(art, self.log_text)
        self.arts[name] = (art, ctr)


def check_all(quick: bool = False, device="cuda",
              out: str | None = None) -> dict:
    """Evaluate every registered contract across the config sweep.

    Returns {"ok", "n_fail", "cells", "rows", "device"}; with ``out``
    also writes the same structure as JSON.  ``quick=True`` runs the
    reduced grid the tests use.  The default device is the card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("check_all runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu'")
    log_text = sass = None
    if dev.type == "cuda":
        log_text, sass = KR.read_build()
    sw = _Sweep(dev, log_text)
    cfg0, model, ev = _workload_fired(device=dev)
    n = ev.ev_class.shape[0]

    # ---- run_engine over the {backend x shedder} grid -------------------
    for backend, shedder in _cells(quick):
        cfg = dataclasses.replace(cfg0, backend=backend, shedder=shedder)
        sw.cell("cep.run_engine", cfg, model, ev,
                eng.init_carry(cfg, device=dev), dev,
                name=f"run_engine[{backend}/{shedder}]", n_events=n)

    # ---- fired-heavy cells: the block kernel in the overload regime -----
    fired = [(eng.SHED_PSPICE, "fused")]
    if not quick:
        fired += [(eng.SHED_PMBL, "fused"), (eng.SHED_PSPICE, "replay")]
    for shedder, mode in fired:
        cfg = dataclasses.replace(cfg0, backend=eng.BACKEND_CUDA_BLOCK,
                                  shedder=shedder, block_shed=mode)
        sw.cell("cep.run_engine", cfg, model, ev,
                eng.init_carry(cfg, device=dev), dev,
                name=f"run_engine[fired-heavy/{mode}/{shedder}]",
                n_events=n)

    # ---- run_engine_chunk -----------------------------------------------
    piece, m = _cut(ev, WARM, n), n - WARM
    for backend in (BACKENDS if not quick else BACKENDS[:1]):
        cfg = dataclasses.replace(cfg0, backend=backend)
        sw.cell("cep.run_engine_chunk", cfg, model, piece,
                _warm_carry(cfg, model, ev, dev), WARM, dev,
                name=f"run_engine_chunk[{backend}/{cfg.shedder}]",
                n_events=m)

    # ---- lane-batched chunk entries -------------------------------------
    lmodel = LN.broadcast_model(model, LANES)
    lev = LN.stack([piece] * LANES)
    for entry, owned in (("runtime.run_chunk_lanes", False),
                         ("runtime.run_chunk_lanes_donated", True)):
        carry = LN.stack([_warm_carry(cfg0, model, ev, dev)] * LANES)
        sw.cell(entry, cfg0, lmodel, lev, carry, WARM, dev,
                name=f"{entry.split('.')[1]}[{cfg0.backend}/{cfg0.shedder}]",
                n_events=m, owned=owned)

    # ---- retrace guard: warm up, call again, count builds ---------------
    sw.findings += _retrace_sweep(cfg0, model, ev, quick, dev)

    # ---- durable recovery: zero builds + clean restored carry -----------
    _persist_sweep(sw, cfg0, model, ev)

    # ---- the card: full width and the build -----------------------------
    if dev.type == "cuda" and not quick:
        _full_width(sw, dev)
    if dev.type == "cuda":
        sw.findings += KR.build_findings(log_text, sass)

    rows = [f.row() for f in sw.findings]
    n_fail = sum(not f.ok for f in sw.findings)
    result = {"ok": n_fail == 0, "n_fail": n_fail, "device": dev.type,
              "cells": len({f.cell for f in sw.findings}), "rows": rows,
              "summary": _summary(sw)}
    if out:
        pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


def _warm_carry(cfg, model, ev, dev):
    """The carry after events [0, WARM)."""
    return eng.run_engine_chunk(cfg, model, _cut(ev, 0, WARM),
                                eng.init_carry(cfg, device=dev), 0, dev)[0]


def _summary(sw: _Sweep) -> dict:
    """Per cell: host reads per event, block launches per block, temp
    and gather bytes against their budgets (what chip_smoke logs)."""
    out = {}
    for name, (art, ctr) in sw.arts.items():
        n = max(art.n_events, 1)
        blocks = -(-art.n_events // art.cfg.block_events)
        launches = sum(art.launches.get(k, 0) for k in (
            "block_step", "block_step_lanes"))
        out[name] = dict(
            events=art.n_events, syncs_per_event=art.syncs / n,
            block_launches_per_block=launches / blocks,
            launches=dict(art.launches), temp_bytes=art.temp_bytes,
            temp_budget=ctr.budget("max_temp_bytes", art.cfg, n),
            gather_bytes=art.gather[0],
            gather_budget=ctr.budget("max_gather_bytes", art.cfg, n))
    return out


def _retrace_sweep(cfg0, model, ev, quick: bool, dev) -> list:
    """Warm each entry up, then run it twice per cell with fresh same-
    shape data: any kernel build, library load or plan-cache miss inside
    the counted block is a rebuild."""
    backends = BACKENDS if dev.type == "cuda" or not quick else \
        BACKENDS[:1]
    sources = T.build_sources()
    lmodel = LN.broadcast_model(model, LANES)

    def calls(cfg, k):
        fresh = _cut(ev, 0, ev.ev_class.shape[0])
        eng.run_engine(cfg, model, fresh, eng.init_carry(cfg, device=dev),
                       dev)
        eng.run_engine_chunk(cfg, model, _cut(ev, k * WARM,
                                              (k + 1) * WARM),
                             eng.init_carry(cfg, device=dev), k * WARM,
                             dev)
        lev = LN.stack([_cut(ev, k * WARM, (k + 1) * WARM)] * LANES)
        DS.run_chunk_lanes_sharded(cfg, lmodel, lev,
                                   LN.init_lane_carries(cfg, LANES,
                                                        device=dev),
                                   0, device=dev)

    for backend in backends:
        calls(dataclasses.replace(cfg0, backend=backend), 0)
    with T.CompileCounter(*sources.values()) as cc:
        for backend in backends:
            for k in (1, 2):
                calls(dataclasses.replace(cfg0, backend=backend), k)
        measured = {name: cc.compiles(src) for name, src in sources.items()}
    budget = C.get_contract("cep.run_engine").max_compiles
    return T.retrace_findings(measured, {k: budget for k in measured},
                              cell="retrace-sweep")


def _persist_sweep(sw: _Sweep, cfg0, model, ev) -> None:
    """Durable-recovery contract (DESIGN.md §13): a runtime rebuilt from
    a snapshot + WAL replay makes no build and no plan during recovery
    and the stream after it, and the restored carry runs clean through
    the chunk contract."""
    dev = sw.device
    n = ev.ev_class.shape[0]

    def rt_cfg(d):
        # group_chunks=1 pins the chunk path; snapshot on every push.
        return RTS.RuntimeConfig(chunk_size=WARM, group_chunks=1,
                                 persist=PS.PersistConfig(
                                     dir=d, snapshot_every_chunks=1))

    with tempfile.TemporaryDirectory() as d:
        warm = RTS.StreamRuntime(cfg0, model, rt_cfg(d), device=dev)
        warm.push(_cut(ev, 0, WARM))
        warm.persist.wal.close()
        sources = T.build_sources()
        with T.CompileCounter(*sources.values()) as cc:
            rec = RTS.StreamRuntime(cfg0, model, rt_cfg(d), device=dev)
            rec.recover_from_disk()
            carry = eng.tree_map(torch.clone, rec.carry)
            rec.push(_cut(ev, WARM, 2 * WARM))
            measured = {f"{k}[post-recovery]": cc.compiles(s)
                        for k, s in sources.items()}
        rec.persist.wal.close()
    sw.findings += T.retrace_findings(measured, {k: 0 for k in measured},
                                      cell="persist-sweep")
    sw.cell("cep.run_engine_chunk", cfg0, model, _cut(ev, WARM, n), carry,
            WARM, dev, n_events=n - WARM,
            name=f"run_engine_chunk[{cfg0.backend}/{cfg0.shedder}/"
                 "persist-restored]")


def _stock(dev):
    """The stock main path's configuration (with match tiles, as
    ``run_experiment`` runs it) and its model, built on lane 0's warm-up
    (30 % of its stream), the runtime phase's recipe."""
    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(
        cp, max_pms=sc.max_pms, latency_bound=sc.latency_bound,
        shedder="pspice", backend="cuda_block", block_events=32,
        emit_matches=True, **_paper_cost())
    raw = sc.raw(n=STOCK_EVENTS)
    warm = streams.classify(specs, _raw_cut(raw, int(STOCK_EVENTS * 0.3)),
                            rate=1.0, seed=sc.seed, device=dev)
    built = runner.build_model(specs, cfg, warm, bin_size=sc.bin_size,
                               seed=sc.seed, device=dev)
    ev = streams.classify(specs, raw, rate=built.max_rate * STOCK_RATE,
                          seed=sc.seed, device=dev)
    model = eng.make_model(
        cp, cfg, ut_tables=built.ut_stacked, ut_bins=built.ut_bins,
        f_model=built.f_model, g_model=built.g_model,
        ebl_raw_mean=float(ev.ebl_raw.mean()), device=dev)
    lanes = [ev if k == 0 else streams.classify(
        specs, sc.raw(n=STOCK_EVENTS, seed=sc.seed + k),
        rate=built.max_rate * (STOCK_RATE + 0.2 * k / (RT_LANES - 1)),
        seed=sc.seed + k, device=dev) for k in range(RT_LANES)]
    return cfg, model, ev, lanes


def _raw_cut(raw, b: int):
    """The first ``b`` events of a RawStream."""
    return dataclasses.replace(raw, n=b, type_id=raw.type_id[:b],
                               attr=raw.attr[:b], group=raw.group[:b])


def _paper_cost() -> dict:
    from repro_torch.configs.pspice_paper import COST
    return COST


def _full_width(sw: _Sweep, dev) -> None:
    """Stock's main path on "cuda_block" for each shedder at full width,
    and one donated chunk of 128 stock lanes (the lane grid)."""
    cfg1, model, ev, lanes = _stock(dev)
    n = ev.ev_class.shape[0]
    for shedder in SHEDDERS:
        cfg = dataclasses.replace(cfg1, shedder=shedder)
        sw.cell("cep.run_engine", cfg, model, ev,
                eng.init_carry(cfg, device=dev), dev,
                name=f"run_engine[stock/cuda_block/{shedder}]", n_events=n)
    # The lanes' ninth chunk, after eight that build their queues up (the
    # first chunks of a stream rarely shed).
    cfg = dataclasses.replace(cfg1, emit_matches=False)
    lmodel = LN.broadcast_model(model, RT_LANES)
    a = RT_WARM_CHUNKS * RT_CHUNK
    carry = LN.run_chunk_lanes_donated(
        cfg, lmodel, LN.stack([_cut(x, 0, a) for x in lanes]),
        LN.init_lane_carries(cfg, RT_LANES, device=dev), 0, dev)[0]
    lev = LN.stack([_cut(x, a, a + RT_CHUNK) for x in lanes])
    sw.cell("runtime.run_chunk_lanes_donated", cfg, lmodel, lev, carry, a,
            dev, name=f"run_chunk_lanes_donated[stock-{RT_LANES}/cuda_block/"
                      "pspice]", n_events=RT_CHUNK, owned=True)
