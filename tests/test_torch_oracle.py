"""The port's NumPy oracle (``repro_torch.eval.oracle``) against the
reference's, and the port's engines against the port's oracle.

1. ORACLE PARITY: on the fixtures of tests/test_oracle.py (generated
   no-shed scenarios, the shedder fixtures, the overload fixtures) the
   port's ``run_oracle`` equals the reference's bit for bit — match
   sets, every counter, ``l_e``, ``n_pm``, ``shed`` and ``dropped`` —
   for every shedder in both threefry layouts.  PM-BL's draws come from
   ``repro_torch.prng`` in the port and from ``jax.random`` in the
   reference, so each case sets ``prng.PARTITIONABLE`` and jax's
   ``jax_threefry_partitionable`` together and restores both.
2. ENGINES vs ORACLE: the port's ``torch`` and ``cuda_block`` engines
   (the block kernel's plain version here) equal the port's oracle under
   ``shed_plan="sort"``, the literal Algorithm 2 the oracle implements.
"""
import dataclasses

import jax
import numpy as np
import pytest

import test_oracle as ref_fixtures
from repro.cep import engine as eng
from repro.eval import oracle as orc
from repro_torch import prng
from repro_torch.cep import engine as teng
from repro_torch.eval import oracle as torc
from repro_torch.eval import oracle_cases

from _torch_bridge import SHEDDERS, assert_trees_equal, port_config, to_port

LAYOUTS = {"partitionable": True, "original": False}


@pytest.fixture(params=list(LAYOUTS))
def layout(request):
    """Both generators in one threefry layout for the test's duration."""
    part = LAYOUTS[request.param]
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", part)
    try:
        with prng.layout(part):
            yield part
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _port(cfg, model, ev, backend="torch"):
    t_model, t_ev, _ = to_port(model, ev, eng.init_carry(cfg))
    return port_config(cfg, backend), t_model, t_ev


def assert_oracles_equal(ref: orc.OracleResult, got: torc.OracleResult,
                         what: str):
    assert got.matches == ref.matches, what
    for f in ("complex_count", "pms_created", "l_e", "n_pm", "shed",
              "dropped"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(b, a, f"{what} {f}")
    for f in ("pms_shed", "shed_calls", "overflow", "ebl_dropped"):
        assert getattr(got, f) == getattr(ref, f), (what, f)


def _oracle_pair(cfg, model, ev, what):
    ref = orc.run_oracle(cfg, model, ev, seed=0)
    got = torc.run_oracle(*_port(cfg, model, ev), seed=0)
    assert_oracles_equal(ref, got, what)
    return got


@pytest.mark.parametrize("seed", range(6))
def test_oracle_equals_reference_no_shed(layout, seed):
    cfg, model, ev = ref_fixtures._scenario(seed)
    o = _oracle_pair(cfg, model, ev, f"seed={seed}")
    assert o.pms_created.sum() > 0


@pytest.mark.parametrize("name", ["q1", "q4"])
@pytest.mark.parametrize("shedder", SHEDDERS)
def test_oracle_equals_reference_shedders(layout, name, shedder):
    cfg, model, ev = ref_fixtures.TestDifferentialShedders._fixture(
        name, shedder)
    o = _oracle_pair(cfg, model, ev, f"{name}/{shedder}")
    if shedder in ("pspice", "pmbl"):
        assert o.pms_shed > 0
    if shedder == "ebl":
        assert o.ebl_dropped > 0


@pytest.mark.parametrize("mult", (1.2, 1.4, 1.6))
@pytest.mark.parametrize("shedder", SHEDDERS)
def test_oracle_equals_reference_overload(layout, shedder, mult):
    cfg, model, ev = ref_fixtures.TestDifferentialSheddersOverload._fixture(
        shedder, mult)
    o = _oracle_pair(cfg, model, ev, f"{shedder}/x{mult}")
    if shedder in ("pspice", "pmbl"):
        assert o.shed_calls >= 8


def test_overload_case_is_the_reference_fixture():
    """``oracle_cases.overload_case`` (what the card runs) builds the
    reference's overload fixture from the port's modules."""
    for shedder in ("pspice", "pmbl"):
        for mult in oracle_cases.OVERLOAD_LEVELS:
            cfg, model, ev = ref_fixtures.TestDifferentialSheddersOverload.\
                _fixture(shedder, mult)
            t_cfg, t_model, t_ev = oracle_cases.overload_case(shedder, mult,
                                                              "cpu")
            assert t_cfg == port_config(cfg, "torch")
            assert_trees_equal(model, t_model, f"{shedder}/x{mult} model")
            assert_trees_equal(ev, t_ev, f"{shedder}/x{mult} events")


def test_pmbl_draws_depend_on_the_layout():
    """The layout reaches the oracle's PM-BL draws: on ``layout_case``
    the two layouts complete different matches (the overload fixture
    cannot show it: it drops every live PM at each fire)."""
    args = oracle_cases.layout_case("pmbl", "cpu")
    runs = []
    for part in (True, False):
        with prng.layout(part):
            runs.append(torc.run_oracle(*args, seed=0))
    assert runs[0].shed_calls > 0
    assert runs[0].matches != runs[1].matches


def assert_engine_equals_oracle(cfg, model, ev, o, what):
    carry, outs = teng.run_engine(
        cfg, model, ev, teng.init_carry(cfg, seed=0, device="cpu"),
        device="cpu")
    assert teng.match_sets(outs) == o.matches, what
    np.testing.assert_array_equal(carry.complex_count.numpy(),
                                  o.complex_count, what)
    np.testing.assert_array_equal(carry.pms_created.numpy(),
                                  o.pms_created, what)
    for f in ("pms_shed", "shed_calls", "overflow", "ebl_dropped"):
        assert float(getattr(carry, f)) == getattr(o, f), (what, f)
    np.testing.assert_array_equal(outs.l_e.numpy(), o.l_e, f"{what} l_e")
    np.testing.assert_array_equal(outs.n_pm.numpy(),
                                  o.n_pm.astype(np.float32), f"{what} n_pm")
    np.testing.assert_array_equal(outs.shed.numpy(), o.shed, what)
    np.testing.assert_array_equal(outs.dropped.numpy(), o.dropped, what)


@pytest.mark.parametrize("backend", ["torch", "cuda_block"])
@pytest.mark.parametrize("shedder", SHEDDERS)
def test_port_engines_equal_port_oracle_overload(layout, backend, shedder):
    """The overload fixture at 1.2/1.4/1.6: Algorithm 2 fires many times
    (the block path replays each fire, forced by the sort plan)."""
    for mult in (1.2, 1.4, 1.6):
        cfg, model, ev = ref_fixtures.TestDifferentialSheddersOverload.\
            _fixture(shedder, mult)
        assert cfg.shed_plan == "sort"
        t_cfg, t_model, t_ev = _port(cfg, model, ev, backend)
        o = torc.run_oracle(t_cfg, t_model, t_ev, seed=0)
        assert_engine_equals_oracle(t_cfg, t_model, t_ev, o,
                                    f"{backend}/{shedder}/x{mult}")


@pytest.mark.parametrize("backend", ["torch", "cuda_block"])
@pytest.mark.parametrize("shedder", ("pspice", "pmbl"))
def test_port_engines_equal_port_oracle_layout_case(layout, backend,
                                                    shedder):
    """Fires that drop a strict subset of the live PMs, in both
    layouts."""
    cfg, model, ev = oracle_cases.layout_case(shedder, "cpu")
    cfg = dataclasses.replace(cfg, backend=backend)
    o = torc.run_oracle(cfg, model, ev, seed=0)
    assert o.shed_calls > 0
    assert_engine_equals_oracle(cfg, model, ev, o, f"stock/{shedder}")


@pytest.mark.parametrize("backend", ["torch", "cuda_block"])
@pytest.mark.parametrize("shedder", SHEDDERS)
def test_port_engines_equal_port_oracle_q4(backend, shedder):
    """ANY / in-windows patterns (Q4) under each shedder."""
    cfg, model, ev = ref_fixtures.TestDifferentialShedders._fixture(
        "q4", shedder)
    t_cfg, t_model, t_ev = _port(cfg, model, ev, backend)
    o = torc.run_oracle(t_cfg, t_model, t_ev, seed=0)
    assert_engine_equals_oracle(t_cfg, t_model, t_ev, o, f"q4/{shedder}")


@pytest.mark.parametrize("backend", ["torch", "cuda_block"])
@pytest.mark.parametrize("seed", range(3))
def test_port_engines_equal_port_oracle_no_shed(backend, seed):
    cfg, model, ev = ref_fixtures._scenario(seed)
    t_cfg, t_model, t_ev = _port(cfg, model, ev, backend)
    o = torc.run_oracle(t_cfg, t_model, t_ev)
    assert_engine_equals_oracle(t_cfg, t_model, t_ev, o, f"seed={seed}")
