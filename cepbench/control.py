"""The control of ``correct``: the plain reference put in the program's
place, computed in bfloat16 (the precision below the configuration's
float32), and judged by the same comparisons as a run.  It has to come
out not correct.

    python3 cepbench/control.py --workload soccer-q3.lanes128 --seed 7

prints, for the cell at its own size, each number compared with its
limit and ``correct``.  The benchmark's runs do not run it; it needs no
card.  What stands in for the program's outputs: the bfloat16 build of
the model from the warm-up; the lanes' arrivals at that build's
capacity; the state of every lane at the checked push's start and the
telemetry of that push, both from the bfloat16 engine.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def low_outputs(cfg: dict, cell: dict, seed: int, precision: str):
    """What the reference at ``precision`` gives in the program's place:
    (sets, warm, built, checked, lanes)."""
    from cepbench import check as CK, harness, traffic
    from cepbench.reference import engine as E, model as RM, patterns as RP
    from cepbench.reference.arith import Arith
    ar = Arith(precision)
    push, lanes = harness.draw_checked(seed, cell)
    sets = traffic.session_sets(cfg, cell, seed)
    warm = traffic.warm_stream(cfg, cell["session_events"])
    pats = RP.compile_specs(cfg["patterns"])
    prm = CK.params(cfg, pats)
    b = RM.build(prm, pats, warm, cfg["bin_size"], ar)
    built = dict(T=b.T, R=b.R, ut_tables=b.tables, ut_bins=b.bins,
                 f=tuple(float(x) for x in b.f[:2]) + (b.f[2],),
                 g=tuple(float(x) for x in b.g[:2]) + (b.g[2],),
                 steady_n_pm=b.steady_n_pm, max_rate=b.max_rate)
    arr = np.stack([traffic.arrivals(cell["session_events"], r)
                    for r in traffic.lane_rates(cell, b.max_rate)])
    ev = sets[0]
    ev["arrival"] = arr
    a = push * cell["push_events"]
    stop = min(a + cell["push_events"], cell["session_events"])
    model = CK.ref_model(built)
    st = E.State.fresh(cell["lanes"], *pats["trans"].shape[:2], prm)
    cut = lambda lo, hi: {k: ev[k][:, lo:hi]  # noqa: E731
                          for k in ("cls", "bind", "open", "id", "arrival")}
    E.run(prm, pats, model, st, cut(0, a), 0, ar)
    carry = {k: np.array(getattr(st, v)) for k, v in CK.STATE_LEAVES.items()}
    for k in CK.ZERO_LEAVES:
        carry[k] = np.zeros(cell["lanes"], np.float32)
    stats = []
    cs = cfg["chunk_events"]
    for c0 in range(a, stop, cs):
        c1 = min(c0 + cs, stop)
        before = CK.counters(st)
        out = E.run(prm, pats, model, st, cut(c0, c1), c0, ar)
        stats.append(CK.chunk_stats(out, before, CK.counters(st), ar))
    checked = dict(set=0, start=a, stop=stop, stats=stats, carry=carry)
    return sets, warm, built, checked, lanes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--precision", default="bfloat16")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from cepbench import harness
    _, cfg, cell, _, _ = harness.load_cell(args.workload, ROOT)
    sets, warm, built, checked, lanes = low_outputs(cfg, cell, args.seed,
                                                    args.precision)
    readings = harness.compare(cfg, cell, sets, warm, built, checked, lanes)
    limits = cfg["limits"]
    numbers = {k: [v[0], limits[k]] for k, v in readings.items()
               if k in limits}
    for k, v in readings.items():
        if v[1]:
            print(v[1], file=sys.stderr)
    ok = all(v <= lim for v, lim in numbers.values())
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "precision": args.precision, "correct": ok,
                      "check": numbers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
