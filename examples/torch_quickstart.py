"""Quickstart on the PyTorch/CUDA port: pSPICE end-to-end on a stock
stream (paper Q1).

The counterpart of ``examples/quickstart.py``: builds the Markov utility
model from a warm-up phase, then runs the same overloaded stream through
pSPICE / random PM drop (PM-BL) / event shedding (E-BL) and prints the
false-negative comparison — the paper's core result.  Runs on the GPU
(the block kernel, ``backend="cuda_block"``) unless given ``--device
cpu``, where the kernels' plain versions run.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --events 6000
"""
import argparse
import sys

from repro_torch.cep import patterns as pat
from repro_torch.cep import runner
from repro_torch.data import streams

COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4, c_shed_pm=1.5e-6,
            c_ebl=6e-5)
SHEDDERS = ("pspice", "pmbl", "ebl")


def experiment(events: int = 50_000, max_pms: int = 128,
               backend: str = "cuda_block", block_events: int = 32,
               device=None) -> dict:
    """``run_experiment`` on the reference example's stream and settings,
    ``events`` long: {shedder: ExperimentResult}."""
    spec = pat.make_q1(window_size=4000, num_symbols=10)
    raw = streams.gen_stock(events, num_symbols=500, pattern_symbols=10,
                            hot_fraction=0.9, p_class=0.03, seed=1)
    return runner.run_experiment(
        [spec], raw, shedders=SHEDDERS, rate_multiplier=1.2,
        latency_bound=1.0, max_pms=max_pms, bin_size=64, backend=backend,
        block_events=block_events, device=device, **COST)


def table(res: dict) -> list[str]:
    """The reference example's table rows, one a shedder."""
    rows = [f"{'shedder':10s} {'FN%':>7s} {'PMs shed':>9s} "
            f"{'events dropped':>15s} {'max latency':>12s}"]
    for name, r in res.items():
        rows.append(f"{name:10s} {100 * r.fn:6.1f}% "
                    f"{float(r.result.pms_shed):9.0f} "
                    f"{float(r.result.ebl_dropped):15.0f} "
                    f"{float(r.result.l_e.max()):11.3f}s")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--events", type=int, default=50_000)
    ap.add_argument("--max-pms", type=int, default=128)
    ap.add_argument("--backend", default="cuda_block",
                    choices=("torch", "cuda", "cuda_block"))
    ap.add_argument("--block-events", type=int, default=32)
    args = ap.parse_args(argv)
    print("=== pSPICE quickstart (repro_torch): Q1 (seq of 10 stock "
          "symbols) ===")
    res = experiment(args.events, args.max_pms, args.backend,
                     args.block_events, args.device)
    any_r = next(iter(res.values()))
    print(f"\nmatch probability: {any_r.match_probability:.2%}   "
          f"max operator throughput: {any_r.max_rate:.0f} ev/s   "
          f"overload: 120%\n")
    print("\n".join(table(res)))
    print("\nLatency bound (1.0s) is maintained by pSPICE while shedding "
          "the least useful partial matches.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
