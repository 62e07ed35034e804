"""Multi-tenant streaming runtime on the PyTorch/CUDA port: L tenants,
drifting streams, online model refresh.

The counterpart of ``examples/runtime_multitenant.py``.  Each tenant is an
independent Q1 stock query over its own stream — its own arrival rate
(all drifting upward) and its own drifting match statistics.  The runtime
ingests lane-stacked micro-batches, runs all lanes through one
lane-batched chunk scan (on the GPU one launch of the block kernel's lane
instance, one CTA per lane, per 32-event block), and between chunks
re-estimates every lane's Markov/utility model from its accumulated
observations, so each tenant's shedder tracks its own drift.  Runs on the
GPU unless given ``--device cpu``.

  PYTHONPATH=src python examples/torch_runtime_multitenant.py
  PYTHONPATH=src python examples/torch_runtime_multitenant.py --device cpu \\
      --lanes 2 --events 4096
"""
import argparse
import sys

from repro_torch.cep import engine as eng
from repro_torch.cep import patterns as pat
from repro_torch.cep import runner
from repro_torch.data import streams
from repro_torch import runtime as RT

COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4, c_shed_pm=1.5e-6,
            c_ebl=6e-5)


def run(lanes: int = 4, events: int = 16_384, chunk: int = 1024,
        push: int = 3000, backend: str = "cuda_block", device=None,
        log=print) -> RT.MultiTenantRuntime:
    """The reference example's tenants, ``events`` each, through
    ``MultiTenantRuntime`` in pushes of ``push``; logs a row a chunk and
    returns the runtime."""
    L, n = lanes, events
    log(f"=== repro_torch.runtime: {L} tenants x {n} events, "
        f"chunk={chunk}, refresh every 4 chunks ===")
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=128, latency_bound=0.02,
                                gather_stats=True, shedder="pspice",
                                backend=backend, block_events=32, **COST)
    model = eng.make_model(cp, cfg, device=device)

    # Start near capacity and drift well past it: the back half of every
    # stream overloads the operator, so the shedder has to work.
    rate = 1.0 / (cfg.c_base + cfg.c_match * 0.3 * cfg.max_pms)
    evs = []
    for lane in range(L):
        raw = streams.gen_stock_drift(n, num_symbols=50, pattern_symbols=4,
                                      p_class=0.03, p_class_end=0.10,
                                      seed=100 + lane)
        evs.append(streams.classify(specs, raw, rate=rate * (1 + 0.2 * lane),
                                    rate_end=4.0 * rate, seed=lane,
                                    device=device))

    mt = RT.MultiTenantRuntime(
        cfg, RT.broadcast_model(model, L), num_lanes=L, specs=specs,
        rt=RT.RuntimeConfig(
            chunk_size=chunk,
            refresh=RT.RefreshConfig(every_chunks=4, min_observations=256,
                                     decay=0.5)),
        device=device)

    log(f"\n{'chunk':>5s} {'events/s':>10s} {'p99 l_e':>9s} "
        f"{'PMs shed':>9s} {'completions':>12s} {'refresh':>8s}")
    # Stream in pushes of an odd size — the buffer re-chunks; flush drains
    # the tail.
    evL = RT.stack(evs)
    for s in range(0, n, push):
        batch = RT.slice_events(evL, s, min(s + push, n), axis=1)
        for st in mt.push(batch, flush=(s + push >= n)):
            log(f"{st.chunk_index:5d} {st.events_per_s:10.0f} "
                f"{st.l_e_p99:9.4f} {st.pms_shed:9.0f} "
                f"{st.completions:12.0f} "
                f"{'yes' if st.refreshed else '':>8s}")

    agg = mt.telemetry.aggregate()
    merged = mt.merged_carry()
    log(f"\naggregate: {agg['events_per_s']:.0f} events/s over "
        f"{agg['n_events']} events in {agg['n_chunks']} chunks; "
        f"{agg['refreshes']} refresh rounds")
    log("per-tenant completions: "
        f"{[int(c) for c in merged.complex_count.tolist()]}")
    log("per-tenant refreshes:   "
        f"{[s.refresh_count for s in mt.refresh_state]}")
    return mt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--events", type=int, default=16_384)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--push", type=int, default=3000)
    ap.add_argument("--backend", default="cuda_block",
                    choices=("torch", "cuda", "cuda_block"))
    args = ap.parse_args(argv)
    run(args.lanes, args.events, args.chunk, args.push, args.backend,
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
