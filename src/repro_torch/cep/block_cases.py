"""Seeded event blocks on which the block kernel fires Algorithm 2.

The card tests and ``chip_smoke.py`` hold ``kernels.block_step`` (and,
lane-stacked, ``block_step_lanes``) against ``block_step_plain`` on these
blocks: an overloaded run of a registered
scenario, its carry just before the run's first shed decision, and the
next W events.  The carry comes from the per-event engine (backend
"torch"), so the block kernel starts from a state it did not make.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.cep import engine, patterns as pat, runner
from repro_torch.core import overload as ovl
from repro_torch.data import streams

# (scenario, N, shedder): SEQ/at-open at the stock main path's shape and
# at N=2048, ANY/in-windows (bus) and ANY/at-open with E-BL (soccer) —
# all with the store in shared memory — and soccer's 8 ANY patterns at
# N=2048 under PM-BL, whose store (about 1 MB) takes the kernel's
# device-memory instantiation.
CASES = (("stock", 256, "pspice"), ("stock", 256, "pmbl"),
         ("stock", 2048, "pspice"), ("bus", 128, "pmbl"),
         ("soccer", 256, "ebl"), ("soccer", 2048, "pmbl"))


def case_config(name: str, N: int, shedder: str, *, W: int = 32, **costs):
    """``(compiled patterns, cfg)`` of a case: scenario ``name`` with an
    N-slot store, matches and stats on, the block backend at W events per
    launch and a latency bound of 2 ms."""
    cp = pat.compile_patterns(streams.get_scenario(name).specs())
    return cp, runner.default_config(
        cp, max_pms=N, latency_bound=0.002, shedder=shedder,
        emit_matches=True, gather_stats=True, backend="cuda_block",
        block_events=W, **costs)


def firing_block(name: str, N: int, shedder: str, device, *, W: int = 32,
                 n: int = 600, **costs):
    """``(cfg, model, carry, blk, i0)`` for scenario ``name`` with an
    N-slot store: the carry after the first ``i0`` events of a run at ten
    times the rate the costs allow, and the W-event block that follows,
    placed so that it holds the run's first shed decision (the last W
    events when the run never sheds).  ``costs`` are the
    ``default_config`` cost keywords."""
    sc = streams.get_scenario(name)
    specs = sc.specs()
    cp, cfg = case_config(name, N, shedder, W=W, **costs)
    rate = 10.0 / (cfg.c_base + cfg.c_match * 30)
    ev = streams.classify(specs, sc.raw(n=n), rate=rate, seed=1,
                          device=device)
    model = engine.make_model(cp, cfg, device=device)
    ref = dataclasses.replace(cfg, backend="torch")
    carry = engine.init_carry(cfg, seed=1, device=device)
    _, outs = engine.run_engine(ref, model, ev, carry, device=device)
    fires = outs.shed.nonzero().flatten().tolist()
    warm = max(fires[0] - W // 2, 0) if fires else n - W
    if warm:
        carry, _ = engine.run_engine(
            ref, model, engine.EventBatch(*(x[:warm] for x in ev)), carry,
            device=device)
    blk = engine.EventBatch(*(x[warm:warm + W].contiguous() for x in ev))
    return cfg, model, carry, blk, warm


def firing_lanes(name: str, N: int, shedder: str, device, *, lanes: int = 3,
                 W: int = 32, n: int = 600, **costs):
    """``(cfg, model, carry, blk, i0)`` lane-stacked for the kernel's lane
    instance: lane k runs scenario ``name``'s stream under seed 1 + k at
    ten times the rate the costs allow, with its own model (utility
    tables drawn from seed k, an f slope of 1 + k/4 times c_match, its own
    E-BL mean), and its carry is that lane's state after the first ``i0``
    events, where ``i0`` is the first index whose W-event block ``blk``
    holds a shed decision of as many lanes as any block does (the last W
    events when no lane sheds)."""
    sc = streams.get_scenario(name)
    specs = sc.specs()
    cp, cfg = case_config(name, N, shedder, W=W, **costs)
    rate = 10.0 / (cfg.c_base + cfg.c_match * 30)
    ref = dataclasses.replace(cfg, backend="torch")
    models, evs = [], []
    for k in range(lanes):
        ev = streams.classify(specs, sc.raw(n=n, seed=sc.seed + k),
                              rate=rate * (1 + 0.1 * k), seed=1 + k,
                              device=device)
        gen = torch.Generator().manual_seed(k)
        tables = torch.rand((cp.num_patterns, 8, cp.max_states),
                            generator=gen) + 0.05
        models.append(engine.make_model(
            cp, cfg, ut_tables=tables,
            ut_bins=torch.full((cp.num_patterns,), 64, dtype=torch.int32),
            f_model=ovl.latency_model(cfg.c_match * (1 + 0.25 * k),
                                      cfg.c_base, ovl.LINEAR, device),
            ebl_raw_mean=0.4 + 0.1 * k, device=device))
        evs.append(ev)
    shed = torch.stack([engine.run_engine(
        ref, models[k], evs[k],
        engine.init_carry(cfg, seed=1 + k, device=device),
        device=device)[1].shed.cpu() for k in range(lanes)])
    # Lanes with a shed decision in the block starting at each index.
    hits = (shed.int().cumsum(1)[:, W - 1:] -
            torch.nn.functional.pad(shed.int().cumsum(1), (1, 0))[:, :-W]
            > 0).sum(0)
    warm = int(hits.argmax()) if int(hits.max()) else n - W
    carries = []
    for k in range(lanes):
        carry = engine.init_carry(cfg, seed=1 + k, device=device)
        if warm:
            carry, _ = engine.run_engine(
                ref, models[k],
                engine.EventBatch(*(x[:warm] for x in evs[k])), carry,
                device=device)
        carries.append(carry)
    stack = lambda *xs: torch.stack(xs).contiguous()  # noqa: E731
    blk = engine.EventBatch(*(torch.stack([x[warm:warm + W] for x in xs])
                              for xs in zip(*evs)))
    return (cfg, engine.tree_map(stack, *models),
            engine.tree_map(stack, *carries), blk, warm)
