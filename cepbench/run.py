"""Run one cell of the port's benchmark once, on the card:

    python3 cepbench/run.py --workload stock-q1.lanes128 --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout.  Prints, as its last line on standard
output, one JSON object: ``correct``, ``attempted`` (pushes), ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number compared with its limit, also the last lines on
standard error.  Exits non-zero, printing no result, without the card
the cell asks for, or if JAX or the JAX package (``repro``) was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from cepbench import harness
    wl = harness.load_cell(args.workload, ROOT)[0]
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START,
                      log=lambda s: print(s, file=sys.stderr, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
