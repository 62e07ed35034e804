"""The reference's side of the port's dist tests: inputs and ground truth.

``engine_cases`` and ``lanes_cases`` build the reference's inputs from
seeds (the same arrays in any process).  Run as a script, this file
computes the reference's ``run_engine_sharded`` on 1, 2 and 4 host
devices and its ``run_chunk_lanes_sharded`` chunk by chunk on meshes of
four, and writes every result's leaves to an .npz:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_dist_reference.py \\
        engine|lanes OUT.npz

The device count is forced (``XLA_FLAGS``) before jax starts, so only
when the file runs as a script.  Each sharded call is wrapped in
``jax.jit``: under jax 0.9.0 the reference's eager multi-device
``run_engine_sharded`` fails on a sharding assertion, and the jitted one
runs.  The reference's ``MultiTenantRuntime(mesh=...)`` stops in its
telemetry's quantile with a ``ShardingTypeError``; the port's mesh
runtime is held to the reference's ``run_chunk_lanes_sharded`` over the
runtime's chunks instead.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.cep import engine as eng  # noqa: E402
from repro.cep import patterns as pat  # noqa: E402
from repro.cep import runner  # noqa: E402
from repro.core import overload as rovl  # noqa: E402
from repro.data import streams  # noqa: E402

from _dist_worlds import result  # noqa: E402
from _torch_bridge import COST, SHEDDERS  # noqa: E402

WORLDS = (1, 2, 4)
N_EV = 300                   # events of the P = 8 overload stream
LANES, LANE_EV, CHUNK = 4, 288, 96
# (mesh shape, dim names, shedders) of the lane cases.
LANE_MESHES = (((4,), ("data",), ("pspice",)),
               ((2, 2), ("data", "model"), SHEDDERS),
               ((4,), ("model",), ("pspice",)))


def _mixed(p: int):
    """p patterns alternating Q1 (SEQ, at-open) and Q4 (ANY, in-windows),
    windows growing, so every pattern shard holds both kinds."""
    out = []
    for k in range(p // 2):
        out += [pat.make_q1(window_size=300 + 100 * k, num_symbols=4),
                pat.make_q4(any_n=3, window_size=100 + 20 * k, slide=40)]
    return out


def _model(cp, cfg, rng, scale: float = 1.0):
    P = cfg.num_patterns
    return eng.make_model(
        cp, cfg,
        ut_tables=jnp.asarray(rng.uniform(0.1, 1.0, (P, 4, cfg.max_states)),
                              jnp.float32),
        ut_bins=jnp.full((P,), 64, jnp.int32),
        f_model=rovl.LatencyModel(a=jnp.float32(cfg.c_match * scale),
                                  b=jnp.float32(cfg.c_base),
                                  kind=jnp.int32(rovl.LINEAR)))


def _planted():
    """One Q1 completion planted in every pattern (tests/test_pm_sharding
    .py's fixture)."""
    spec = pat.make_q1(window_size=50, num_symbols=3)
    cp = pat.compile_patterns([spec] * 4)
    cfg = runner.default_config(cp, max_pms=16, emit_matches=True)
    n = 60
    cls = np.zeros((n, 4), np.int32)
    cls[5, :], cls[10, :], cls[15, :] = 1, 2, 3
    ev = eng.EventBatch(
        ev_class=jnp.asarray(cls),
        ev_bind=jnp.full((n, 4), -1, jnp.int32),
        ev_open=jnp.asarray(cls == 1),
        ev_id=jnp.zeros((n,), jnp.int32),
        ev_rand=jnp.zeros((n,), jnp.float32),
        ebl_raw=jnp.zeros((n,), jnp.float32),
        arrival=jnp.arange(n, dtype=jnp.float32))
    return cfg, eng.make_model(cp, cfg), ev, eng.init_carry(cfg)


def _overloaded(specs, shedder: str, model_seed: int = 11):
    """``specs`` at N = 32, overloaded so that every shard of two
    patterns still sheds and completes (LB 5 ms)."""
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=32, latency_bound=0.005,
                                gather_stats=True, emit_matches=True,
                                shedder=shedder, block_events=16, **COST)
    model = _model(cp, cfg, np.random.default_rng(model_seed))
    rate = 1.0 / (cfg.c_base + cfg.c_match * 8)
    raw = streams.gen_stock(N_EV, num_symbols=50, pattern_symbols=4,
                            p_class=0.25, seed=21)
    ev = streams.classify(specs, raw, rate=rate, seed=4)
    return cfg, model, ev, eng.init_carry(cfg, seed=9)


def engine_cases() -> dict:
    """{name: (cfg, model, events, carry)} of the engine tests: the
    planted fixture (P = 4), eight mixed patterns under every shedder,
    and three patterns (which shard over no even mesh dim)."""
    cases = {"planted": _planted(),
             "p3": _overloaded(_mixed(4)[:3], "pspice", model_seed=12)}
    for sh in SHEDDERS:
        cases[f"p8-{sh}"] = _overloaded(_mixed(8), sh)
    return cases


def lanes_inputs(shedder: str):
    """(cfg, lane-stacked model, lane-stacked events): lane i on stream
    seed 100 + i at 1 + 0.4·i times the base rate, with its own tables
    and latency fit; four mixed patterns, N = 32."""
    from repro import runtime as RT
    specs = _mixed(4)
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=32, latency_bound=0.005,
                                gather_stats=True, emit_matches=True,
                                shedder=shedder, block_events=16, **COST)
    rate = 1.0 / (cfg.c_base + cfg.c_match * 8)
    rng = np.random.default_rng(7)
    models, evs = [], []
    for i in range(LANES):
        models.append(_model(cp, cfg, rng, 1.0 + 0.25 * i))
        raw = streams.gen_stock(LANE_EV, num_symbols=50, pattern_symbols=4,
                                p_class=0.25, seed=100 + i)
        evs.append(streams.classify(specs, raw, rate=rate * (1 + 0.4 * i),
                                    seed=i))
    return cfg, RT.stack(models), RT.stack(evs)


def mesh_tag(shape, names) -> str:
    return "x".join(map(str, shape)) + "-" + "-".join(names)


def lane_case_names() -> list:
    return [f"{mesh_tag(shape, names)}/{sh}"
            for shape, names, shedders in LANE_MESHES for sh in shedders]


def lanes_cases() -> dict:
    """{name: (mesh shape, names, cfg, model, events, carry)}."""
    from repro import runtime as RT
    out = {}
    for shape, names, shedders in LANE_MESHES:
        for sh in shedders:
            cfg, mL, evL = lanes_inputs(sh)
            out[f"{mesh_tag(shape, names)}/{sh}"] = (
                shape, names, cfg, mL, evL,
                RT.init_lane_carries(cfg, LANES, seed=5))
    return out


def _mesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, devices=np.array(jax.devices()[:n]))


def engine_truth() -> dict:
    from repro.dist import sharding as SH
    out = {}
    for name, (cfg, model, ev, carry) in engine_cases().items():
        for n in WORLDS:
            mesh = _mesh((n,), ("data",))
            fn = jax.jit(lambda m, e, c, cfg=cfg, mesh=mesh:
                         SH.run_engine_sharded(cfg, m, e, c, mesh=mesh))
            for k, v in result(*fn(model, ev, carry)).items():
                out[f"{name}/{n}/{k}"] = v
    return out


def lanes_truth() -> dict:
    from repro.dist import sharding as SH
    out = {}
    for name, (shape, names, cfg, mL, evL, carry) in lanes_cases().items():
        mesh = _mesh(shape, names)
        for k, s in enumerate(range(0, LANE_EV, CHUNK)):
            piece = jax.tree.map(lambda x: x[:, s:s + CHUNK], evL)
            carry, o = SH.run_chunk_lanes_sharded(cfg, mL, piece, carry, s,
                                                  mesh=mesh)
            for key, v in result(carry, o).items():
                out[f"{name}/chunk{k}/{key}"] = v
    return out


if __name__ == "__main__":
    part, path = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 4, jax.devices()
    truth = {"engine": engine_truth, "lanes": lanes_truth}[part]()
    np.savez(path, **truth)
