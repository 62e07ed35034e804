"""The port's pattern-parallel scale-out against the reference's, BITWISE.

``repro_torch.dist`` runs the operator SPMD over ``torch.distributed``:
each rank scans the stream against its pattern shard, then the shards
merge with collectives.  Here the ranks are gloo processes on the CPU
(``dist.spawn``, a ``file://`` store, each world with its own timeout).

* ``pm_specs`` and ``lane_specs`` equal the reference's on abstract
  meshes, the fallbacks included.
* ``run_engine_sharded`` at 1, 2 and 4 ranks equals the reference's
  jitted ``run_engine_sharded`` on 1, 2 and 4 forced host devices (run
  once per module in a subprocess, ``tests/_dist_reference.py``) in every
  carry and StepOut leaf, on the planted fixture and on eight mixed
  patterns (N = 32, 300 events, overloaded) under every shedder, through
  the port's "torch", "cuda" and "cuda_block" backends (the kernels'
  plain versions on the CPU).  One leaf is pinned to the port's own
  plain merge (and, at one rank, to the plain engine) instead: where a
  shard runs eight or four patterns (one and two ranks), the reference's
  shard-mapped latency ring (``lat_samples_l``) rounds the pattern cost
  sum otherwise than its own clock and its own plain engine do (1 ulp
  on a few percent of events; at two patterns a shard they agree) — the
  reference's bits at a local P are a property of its compile.  The
  clock, ``l_e`` and every other leaf stay held to the reference.
* Every collective result equals ``merge_shards_plain`` over the port's
  per-slice runs in one process, every leaf; every rank holds the same
  global result.
* Three patterns on two ranks fall back to the plain engine; one rank
  equals the plain engine; a rank that raises fails its world, and a
  world that hangs fails at its timeout.
"""
import dataclasses

import numpy as np
import pytest

from repro.dist import sharding as RSH
from repro_torch import dist as D
from repro_torch.cep import convert
from repro_torch.cep import engine as teng
from repro_torch.cep import runner as trunner

import _dist_reference as R
import _dist_worlds as W
from _torch_bridge import port_config, to_port

BACKENDS = ("torch", "cuda", "cuda_block")
WORLD_TIMEOUT = W.WORLD_TIMEOUT
CASES = ("planted", "p3") + tuple(f"p8-{s}" for s in R.SHEDDERS)
# (world, case prefix, leaf) held to merge_shards_plain, not the reference.
PINNED = {(1, "p8", "carry.lat_samples_l"), (2, "p8", "carry.lat_samples_l")}


def _port_cases():
    n = convert.tree_to_numpy
    return [(f"{name}/{b}", port_config(cfg, b), "data", n(m), n(e), n(c))
            for name, (cfg, m, e, c) in R.engine_cases().items()
            for b in BACKENDS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's leaves, 1/2/4: each rank's results}: the
    reference's subprocess runs while the port's worlds do."""
    out = tmp_path_factory.mktemp("dist") / "engine.npz"
    proc = W.reference_process("engine", out)
    try:
        cases = _port_cases()
        # One rank: no process group, the default mesh.
        got = {1: [{name: W.result(*D.run_engine_sharded(
            cfg, *W.port_inputs(m, e, c), axis=axis, device="cpu"))
            for name, cfg, axis, m, e, c in cases}]}
        for n in (2, 4):
            got[n] = D.spawn(W.world, n, args=(
                [("engine", (n,), ("data",), cases)],), timeout=WORLD_TIMEOUT)
        got["ref"] = W.reference_result(proc, out)
    finally:
        proc.kill()
    return got


def _pinned(n, case, leaf) -> bool:
    return (n, case.split("-")[0], leaf) in PINNED


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _ref_cfg(p: int):
    from repro.cep import engine as eng
    return eng.EngineConfig(num_patterns=p, max_states=4, max_classes=4,
                            max_pms=32)


def _port_cfg(p: int):
    return teng.EngineConfig(num_patterns=p, max_states=4, max_classes=4,
                             max_pms=32)


def _spec_leaves(tree, path=""):
    """{path: spec as a tuple} of a reference (PartitionSpec) or port
    (tuple) spec tree."""
    from jax.sharding import PartitionSpec
    if isinstance(tree, (PartitionSpec, tuple)) and not hasattr(
            tree, "_fields"):
        return {path: tuple(tree)}
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    else:
        items = list(zip(tree._fields, tree))
    out = {}
    for k, v in items:
        out.update(_spec_leaves(v, f"{path}.{k}"))
    return out


def _same_specs(ref: dict, port: dict, keys):
    for k in ("carry", "model", "events", "out"):
        assert _spec_leaves(ref[k]) == _spec_leaves(port[k]), k
    for k in keys:
        assert ref[k] == port[k], k


MESHES = [((4,), ("data",)), ((2, 2), ("data", "model")),
          ((4,), ("model",)), ((2, 2), ("x", "y"))]


@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("p", [3, 4, 8])
@pytest.mark.parametrize("shape,names", MESHES)
def test_pm_specs_equal_reference(shape, names, p, axis):
    ref = RSH.pm_specs(RSH.abstract_mesh(shape, names), _ref_cfg(p),
                       axis=axis)
    port = D.pm_specs(D.abstract_mesh(shape, names), _port_cfg(p),
                      axis=axis)
    _same_specs(ref, port, ["pattern_axis"])


@pytest.mark.parametrize("pattern_axis", ["model", "data", None])
@pytest.mark.parametrize("lanes", [4, 3])
@pytest.mark.parametrize("shape,names", MESHES[:3])
def test_lane_specs_equal_reference(shape, names, lanes, pattern_axis):
    """Lanes over "data", patterns over ``pattern_axis``; a pattern axis
    equal to the lane axis drops out, as in the reference."""
    ref = RSH.lane_specs(RSH.abstract_mesh(shape, names), _ref_cfg(4),
                         lanes, pattern_axis=pattern_axis)
    port = D.lane_specs(D.abstract_mesh(shape, names), _port_cfg(4), lanes,
                        pattern_axis=pattern_axis)
    _same_specs(ref, port, ["lane_axis", "pattern_axis"])


def test_specs_fall_back_where_the_reference_does():
    mesh = D.abstract_mesh((4,), ("data",))
    assert D.pm_specs(mesh, _port_cfg(3))["pattern_axis"] is None
    assert D.pm_specs(mesh, _port_cfg(8), axis="model")["pattern_axis"] \
        is None
    sp = D.lane_specs(mesh, _port_cfg(4), 4, pattern_axis="data")
    assert (sp["lane_axis"], sp["pattern_axis"]) == ("data", None)
    assert sp["carry"].pms.active == ("data", None, None)


# ---------------------------------------------------------------------------
# run_engine_sharded at 1, 2 and 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_run_engine_sharded_equals_reference(runs, n, case, backend):
    """Bar: bit for bit in every leaf of rank 0's global carry and
    StepOut, but the pinned leaf (module docstring)."""
    got, ref = runs[n][0][f"{case}/{backend}"], runs["ref"]
    bad = [k for k, v in got.items() if not _pinned(n, case, k)
           and not np.array_equal(ref[f"{case}/{n}/{k}"], v)]
    assert not bad, f"{case}/{backend} at {n} ranks differs in {bad}"
    assert len(got) == sum(k.startswith(f"{case}/{n}/") for k in ref)


def test_fixture_sheds_and_completes_at_every_world(runs):
    ref = runs["ref"]
    for n in (1, 2, 4):
        key = f"p8-%s/{n}/carry.%s"
        for sh in ("pspice", "pmbl"):
            assert ref[key % (sh, "pms_shed")] > 0, (sh, n)
            assert ref[key % (sh, "complex_count")].sum() > 0, (sh, n)
        assert ref[key % ("ebl", "ebl_dropped")] > 0, n
        # The shards are genuinely parallel operators: the clocks differ.
    assert len({float(ref[f"p8-none/{n}/carry.sim_time"])
                for n in (1, 2, 4)}) == 3


@pytest.mark.parametrize("n", [1, 2])
def test_pinned_leaf_differs_only_by_the_reference_rounding(runs, n):
    """The pinned leaf: the reference's shard at P = 8 or 4 rounds its
    latency-ring cost 1 ulp apart on a few events; the port's equals the
    plain merge (``test_sharded_equals_merge_shards_plain``) and, at one
    rank, the plain engine (``test_one_rank_equals_the_plain_engine``),
    which equals the reference's plain engine (tests/test_torch_engine.py
    and the block tests hold P = 8 there)."""
    for sh in R.SHEDDERS:
        a = runs["ref"][f"p8-{sh}/{n}/carry.lat_samples_l"]
        b = runs[n][0][f"p8-{sh}/torch"]["carry.lat_samples_l"]
        ulps = np.abs(a.view(np.int32).astype(np.int64) -
                      b.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1 and (ulps > 0).mean() < 0.1, sh


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_equals_merge_shards_plain(runs, n, case, backend):
    """Bar: the collective path equals every shard's run in this process
    merged by ``merge_shards_plain`` (or, where the patterns do not
    shard, the plain engine), bit for bit in every leaf."""
    cfg, m, e, c = R.engine_cases()[case]
    want = W.result(*D.run_engine_shards_plain(
        port_config(cfg, backend), *to_port(m, e, c),
        mesh=D.abstract_mesh((n,), ("data",)), device="cpu"))
    got = runs[n][0][f"{case}/{backend}"]
    assert want.keys() == got.keys()
    bad = [k for k in want if not np.array_equal(want[k], got[k])]
    assert not bad, f"{case}/{backend} at {n} ranks differs in {bad}"


@pytest.mark.parametrize("n", [2, 4])
def test_every_rank_holds_the_global_result(runs, n):
    for r in range(1, n):
        for name, res in runs[n][r].items():
            bad = [k for k, v in res.items()
                   if not np.array_equal(runs[n][0][name][k], v)]
            assert not bad, (r, name, bad)


def test_three_patterns_on_two_ranks_fall_back_to_the_plain_engine(runs):
    cfg, m, e, c = R.engine_cases()["p3"]
    assert D.pm_specs(D.abstract_mesh((2,), ("data",)),
                      port_config(cfg, "torch"))["pattern_axis"] is None
    want = W.result(*teng.run_engine(port_config(cfg, "torch"),
                                     *to_port(m, e, c), device="cpu"))
    got = runs[2][0]["p3/torch"]
    assert all(np.array_equal(want[k], got[k]) for k in want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_rank_equals_the_plain_engine(backend):
    """No process group: the world is one rank and the sharded engine is
    the plain one, bit for bit (the reference's one-device mesh)."""
    cfg, m, e, c = R.engine_cases()["p8-pspice"]
    tcfg = port_config(cfg, backend)
    want = W.result(*teng.run_engine(tcfg, *to_port(m, e, c),
                                     device="cpu"))
    got = W.result(*D.run_engine_sharded(tcfg, *to_port(m, e, c),
                                         device="cpu"))
    assert all(np.array_equal(want[k], got[k]) for k in want)


def test_run_experiment_pattern_parallel_on_one_rank_equals_serial():
    """The runner's pattern-parallel path through the block kernel's plain
    version on a one-rank mesh: FN, fires and compliance exactly the
    serial run's."""
    from repro_torch.data import streams as tstreams
    sc = tstreams.get_scenario("stock")
    kw = dict(shedders=("pspice",), max_pms=32, backend="cuda_block",
              block_events=16, device="cpu", latency_bound=0.05)
    raw = sc.raw(n=450)
    serial = trunner.run_experiment(sc.specs(), raw, **kw)
    par = trunner.run_experiment(sc.specs(), raw, pattern_parallel=True,
                                 mesh=D.abstract_mesh((1,), ("data",)), **kw)
    a, b = serial["pspice"], par["pspice"]
    assert (a.fn, a.fn_match, a.lb_compliance, a.n_found_matches) == \
        (b.fn, b.fn_match, b.lb_compliance, b.n_found_matches)
    assert (a.result.l_e == b.result.l_e).all()


def test_merges_count_their_collectives():
    """Four collectives per merge (sum, max, int max, gather), the same
    count and bytes on every rank."""
    name, cfg, axis, m, e, c = _port_cases()[-1]
    stats = D.spawn(W.stats_world, 2, args=((2,), ("data",), cfg, m, e, c),
                    timeout=WORLD_TIMEOUT)
    assert stats[0]["calls"] == 4 and stats[0]["bytes_out"] > 0
    assert stats[0] == {**stats[1], "seconds": stats[0]["seconds"]}


# ---------------------------------------------------------------------------
# Worlds that fail
# ---------------------------------------------------------------------------

def test_a_rank_that_raises_fails_the_world():
    with pytest.raises(D.RankError, match="fails on purpose"):
        D.spawn(W.failing_world, 3, args=(1, 0.2), timeout=60.0)


def test_a_world_that_hangs_fails_at_its_timeout():
    with pytest.raises(TimeoutError, match="did not finish"):
        D.spawn(W.hanging_world, 2, args=(60.0,), timeout=5.0)


def test_a_world_of_one_rank():
    assert D.spawn(W.world, 1, args=([("engine", (1,), ("data",), [])],),
                   timeout=WORLD_TIMEOUT) == [{}]
