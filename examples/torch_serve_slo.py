"""pSPICE as an LLM-serving eviction policy, on the PyTorch/CUDA port.

The counterpart of ``examples/serve_slo.py``: runs the SLO-bounded
continuous-batching scheduler (``repro_torch.serving.scheduler``) under
the three policies and shows pSPICE's goodput advantage.  The scheduler
is a host simulation in virtual time; its model builder (Markov chain,
utility table, latency fit) runs on the GPU unless given ``--device
cpu``.

  PYTHONPATH=src python examples/torch_serve_slo.py
  PYTHONPATH=src python examples/torch_serve_slo.py --device cpu --requests 200
"""
import argparse
import sys

from repro_torch.serving.scheduler import (SchedulerConfig, run_simulation,
                                           synth_workload)

POLICIES = ("pspice", "random", "admission")


def simulate(requests: int = 800, device=None) -> dict:
    """{policy: run_simulation's metrics} at the reference example's
    settings (48 slots, SLO 1.5 s, 120 requests/s, seed 3)."""
    out = {}
    for pol in POLICIES:
        cfg = SchedulerConfig(policy=pol, max_slots=48, slo=1.5)
        reqs = synth_workload(requests, rate=120.0, cfg=cfg, seed=3)
        out[pol] = run_simulation(cfg, reqs, device=device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--requests", type=int, default=800)
    args = ap.parse_args(argv)
    print("=== pSPICE-on-serving (repro_torch): SLO-bounded decode "
          "scheduling ===\n")
    print(f"{'policy':12s} {'goodput':>8s} {'completed':>10s} "
          f"{'evictions':>10s}")
    for pol, m in simulate(args.requests, args.device).items():
        print(f"{pol:12s} {m['goodput']:8.3f} {m['completed']:10d} "
              f"{m['evictions']:10d}")
    print("\npSPICE evicts the in-flight sequences least likely to finish "
          "inside the SLO\nper unit of remaining decode cost — the paper's "
          "utility (Eq. 1) on KV slots.")
    print("\nFor real model compute through the same scheduler:")
    print("  PYTHONPATH=src python -m repro_torch.launch.serve "
          "--arch internlm2-1.8b --policy pspice")
    return 0


if __name__ == "__main__":
    sys.exit(main())
