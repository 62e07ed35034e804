"""The paper-figure quality sweep (§IV-B, Figs. 5–6 shape).

Port of ``repro.eval.sweep``.  Runs the full experiment grid

    {stock, soccer, bus} × {pspice, PM-BL, E-BL} × overload levels

over the seeded scenario registry (``repro_torch.data.streams``) and
reports, per cell, the match-set false-negative ratio against the
no-shed ground truth of the identical stream, plus latency-bound
compliance and drop fractions.  The gate is the paper's headline
ordering: pSPICE FN ≤ PM-BL FN and ≤ E-BL FN on every dataset at the
paper overload level (DESIGN.md §9).

The grid runs through the port's ``run_experiment``; ``backend``,
``block_events`` and ``device`` pass on to it and default as it does
(so on the card).  PM-BL's draws follow ``repro_torch.prng.PARTITIONABLE``,
which the payload records.  The command line is the counterpart of
``benchmarks/bench_quality.py``:

    PYTHONPATH=src python -m repro_torch.eval.sweep [--quick] [--check]
        [--out build/quality_port.json] [--results-dir DIR]
        [--device cpu] [--backend cuda_block]

``--backend cuda|cuda_block`` is how the command line reaches the
kernels; without it the grid runs ``run_experiment``'s default backend.

It writes the port's own JSON (under ``build/`` by default), never the
reference's committed results.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Sequence

from repro_torch import prng
from repro_torch.cep import engine as eng
from repro_torch.cep import runner
from repro_torch.configs import pspice_paper as pp
from repro_torch.data import streams
from repro_torch.eval import quality as Q

# The paper's Fig. 6 x-axis is 120%..200% of max operator throughput; the
# headline comparisons (Fig. 5) run at the default 120% overload.
OVERLOAD_LEVELS: tuple[float, ...] = (1.2, 1.4, 1.6)
HEADLINE_LEVEL: float = pp.RATE_MULTIPLIER

DATASETS: tuple[str, ...] = ("stock", "soccer", "bus")
SHEDDERS: tuple[str, ...] = (eng.SHED_PSPICE, eng.SHED_PMBL, eng.SHED_EBL)

DEFAULT_OUT = "build/quality_port.json"


def _cell(er: runner.ExperimentResult) -> dict:
    """One (dataset, level, shedder) cell of the grid."""
    return {
        "fn": er.fn_match,                     # match-set FN ratio
        "recall": er.recall,
        "fn_count": er.fn,                     # legacy count-based FN
        "n_gt": er.n_gt_matches,
        "n_found": er.n_found_matches,
        "lb_compliance": er.lb_compliance,
        "drop_fraction": Q.drop_fraction(er.result),
        "pms_shed": er.result.pms_shed,
        "shed_calls": er.result.shed_calls,
        "ebl_dropped": er.result.ebl_dropped,
        "overflow": er.result.overflow,
        "max_rate": er.max_rate,
    }


def _engine_kw(backend, block_events, device) -> dict:
    """The keywords given, for ``run_experiment`` (the others default as
    it does)."""
    kw = dict(backend=backend, block_events=block_events, device=device)
    return {k: v for k, v in kw.items() if v is not None}


def run_dataset(name: str, levels: Sequence[float] = OVERLOAD_LEVELS,
                shedders: Sequence[str] = SHEDDERS,
                quick: bool = False, seed: int | None = None,
                backend: str | None = None, block_events: int | None = None,
                device=None) -> dict:
    """The overload grid for one scenario: per level, one ground-truth
    run + one run per shedder on the identical stream."""
    sc = streams.get_scenario(name)
    n = sc.n_quick if quick else sc.n_default
    raw = sc.raw(n=n, seed=seed)
    specs = sc.specs()
    by_level: dict[str, dict] = {}
    for level in levels:
        res = runner.run_experiment(
            specs, raw, shedders=tuple(shedders), rate_multiplier=level,
            max_pms=sc.max_pms, bin_size=sc.bin_size,
            latency_bound=sc.latency_bound,
            seed=sc.seed if seed is None else seed, **pp.COST,
            **_engine_kw(backend, block_events, device))
        by_level[f"{level:g}"] = {sh: _cell(er) for sh, er in res.items()}
    curves = {
        sh: Q.degradation_curve(
            [(float(lv), dict(cells[sh], fn_ratio=cells[sh]["fn"]))
             for lv, cells in by_level.items()])
        for sh in shedders
    }
    return {
        "scenario": name,
        "n_events": n,
        "seed": sc.seed if seed is None else seed,
        "patterns": [s.name for s in specs],
        "num_patterns": len(specs),
        "max_pms": sc.max_pms,
        "latency_bound": sc.latency_bound,
        "levels": by_level,
        "curves": curves,
    }


def run_quality_sweep(datasets: Sequence[str] = DATASETS,
                      levels: Sequence[float] = OVERLOAD_LEVELS,
                      shedders: Sequence[str] = SHEDDERS,
                      quick: bool = False,
                      results_dir: str | pathlib.Path | None = None,
                      backend: str | None = None,
                      block_events: int | None = None,
                      device=None) -> dict:
    """The full grid.  With ``results_dir``, each dataset's grid is also
    written to ``quality_<dataset>.json`` there (the per-figure files);
    the returned dict is the sweep's payload."""
    per_dataset = {}
    for name in datasets:
        grid = run_dataset(name, levels=levels, shedders=shedders,
                           quick=quick, backend=backend,
                           block_events=block_events, device=device)
        per_dataset[name] = grid
        if results_dir is not None:
            p = pathlib.Path(results_dir)
            p.mkdir(parents=True, exist_ok=True)
            (p / f"quality_{name}.json").write_text(
                json.dumps(grid, indent=2, sort_keys=True) + "\n")
    headline_key = f"{HEADLINE_LEVEL:g}"
    headline = {
        name: {sh: grid["levels"][headline_key][sh]["fn"]
               for sh in shedders}
        for name, grid in per_dataset.items()
        if headline_key in grid["levels"]
    }
    bench = {
        "config": {
            "datasets": list(datasets),
            "levels": [float(l) for l in levels],
            "shedders": list(shedders),
            "headline_level": HEADLINE_LEVEL,
            "quick": quick,
            "threefry_partitionable": prng.PARTITIONABLE,
        },
        "headline": headline,
        "datasets": per_dataset,
    }
    bench["violations"] = check_headline(bench)
    bench["ordering_ok"] = not bench["violations"]
    return bench


def check_headline(bench: dict) -> list[str]:
    """The paper's headline ordering, as a gate: pSPICE's FN ratio must
    be ≤ every baseline's on every dataset at the headline overload
    level.  Returns human-readable violations (empty == pass).  A
    dataset (or the whole headline level) missing from the grid is a
    violation, never a silent pass — a gate that checked nothing must
    not report success."""
    violations = []
    headline = bench.get("headline", {})
    expected = bench.get("config", {}).get("datasets", list(headline))
    if not headline:
        violations.append("headline table is empty (is the headline "
                          "overload level in the swept levels?)")
    for name in expected:
        if name not in headline:
            violations.append(f"{name}: missing from the headline table")
    for name, cells in headline.items():
        if eng.SHED_PSPICE not in cells:
            violations.append(f"{name}: no pspice cell in headline")
            continue
        fn_p = cells[eng.SHED_PSPICE]
        for sh, fn_b in cells.items():
            if sh == eng.SHED_PSPICE:
                continue
            if fn_p is None or fn_b is None:
                violations.append(f"{name}: missing FN metric "
                                  f"(pspice={fn_p}, {sh}={fn_b})")
            elif fn_p > fn_b + 1e-9:
                violations.append(
                    f"{name}: pspice FN {fn_p:.4f} > {sh} FN {fn_b:.4f}")
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The port's quality sweep and its headline gate.")
    ap.add_argument("--quick", action="store_true",
                    help="short streams (each scenario's n_quick)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless the headline ordering holds")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--results-dir", default=None,
                    help="also write per-dataset quality_<ds>.json here")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None,
                    choices=eng.BACKENDS,
                    help="engine backend: cuda or cuda_block reach the "
                         "kernels (default: run_experiment's)")
    args = ap.parse_args(argv)

    bench = run_quality_sweep(quick=args.quick,
                              results_dir=args.results_dir,
                              backend=args.backend,
                              device=args.device)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(bench, indent=2, sort_keys=True) + "\n")

    print(f"headline (overload x{bench['config']['headline_level']:g}, "
          f"match-set FN ratio vs no-shed ground truth):")
    for ds, cells in bench["headline"].items():
        cols = "  ".join(f"{sh}={fn:.4f}" for sh, fn in cells.items())
        print(f"  {ds:8s} {cols}")
    for v in bench["violations"]:
        print(f"VIOLATION: {v}")
    print(f"ordering_ok={bench['ordering_ok']}  -> {args.out}")
    if args.check and not bench["ordering_ok"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
