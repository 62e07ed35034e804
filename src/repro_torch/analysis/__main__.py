"""CLI: ``python -m repro_torch.analysis [--quick] [--device cuda|cpu]
[--out build/analysis_port.json]``.

Runs on the card unless ``--device cpu``.  Exit code 1 on any contract
violation.  It never writes the root ANALYSIS.json (the reference's).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--quick", action="store_true",
                    help="reduced cell grid (the tests' subset)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the cells run (default: the card)")
    ap.add_argument("--out", default="build/analysis_port.json",
                    help="JSON path (default build/analysis_port.json)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.driver import check_all
    result = check_all(quick=args.quick, device=args.device, out=args.out)
    for row in result["rows"]:
        mark = "ok  " if row["status"] == "pass" else "FAIL"
        print(f"{mark} {row['rule']:<14} {row['cell']:<48} "
              f"{row['evidence']}")
    print(f"\n{result['cells']} cells, {len(result['rows'])} findings, "
          f"{result['n_fail']} failures -> {args.out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
