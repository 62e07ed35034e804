"""The port's fault injector (repro_torch.runtime.faults) against the
reference's (repro.runtime.faults).

Bars: BITWISE — for the same seed and call sequence the injector's
faulted events (one stream and lane-stacked), carries and models (whole
and per lane) and its log equal the reference's, NaN for NaN; the kill
plan and the kill switch's env spec likewise.  One SIGKILL test runs a
child process that arms the switch from ``PSPICE_KILL`` and dies at the
planned hit.
"""
import os
import signal
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.cep import engine as eng
from repro.runtime import faults as RFT
from repro.runtime import lanes as RLN
from repro_torch.cep import convert
from repro_torch.runtime import faults as TFT
from repro_torch.runtime import lanes as TLN

from _torch_bridge import assert_trees_equal, port_config, to_port
from test_torch_ingest import _batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup():
    from repro.cep import patterns as pat
    from repro.cep import runner
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=32, gather_stats=True)
    rng = np.random.default_rng(0)
    model = eng.make_model(cp, cfg, ut_tables=jax.numpy.asarray(
        rng.random((1, 6, cfg.max_states)).astype(np.float32)))
    return cfg, model


def _trees_nan_equal(ref, port, what):
    """assert_trees_equal with NaN payloads compared as NaN."""
    a = jax.tree.map(lambda x: np.nan_to_num(np.asarray(x), nan=7.25)
                     if np.issubdtype(np.asarray(x).dtype, np.floating)
                     else np.asarray(x), ref)
    b = convert.tree_to_numpy(port)
    b = jax.tree.map(lambda x: np.nan_to_num(x, nan=7.25)
                     if np.issubdtype(np.asarray(x).dtype, np.floating)
                     else x, b)
    assert_trees_equal(a, b, what)


@pytest.mark.parametrize("lanes", [None, 3])
def test_stream_faults_equal_reference(lanes):
    kw = dict(kinds=RFT.STREAM_FAULTS, seed=4, p_fault=0.6)
    ref, port = RFT.FaultInjector(RFT.FaultConfig(**kw)), \
        TFT.FaultInjector(TFT.FaultConfig(**kw))
    rng = np.random.default_rng(2)
    axis = 0 if lanes is None else 1
    for k in range(6):
        b = _batch(rng, 300 + 37 * k, lanes=lanes)
        got = port.corrupt_events(
            convert.events_from_numpy(convert.tree_to_numpy(b), "cpu"),
            axis=axis)
        want = ref.corrupt_events(jax.tree.map(jax.numpy.asarray, b),
                                  axis=axis)
        assert_trees_equal(want, got, f"stream call {k}")
        assert np.all(np.diff(got.arrival.numpy(), axis=-1) >= 0)
    assert port.log == ref.log
    assert {e["kind"] for e in port.log} == set(RFT.STREAM_FAULTS)


@pytest.mark.parametrize("lane", [None, 1])
def test_state_faults_equal_reference(lane):
    cfg, model = _setup()
    L = None if lane is None else 3
    carry = eng.init_carry(cfg) if L is None else \
        RLN.init_lane_carries(cfg, L)
    rmodel = model if L is None else RLN.broadcast_model(model, L)
    kw = dict(kinds=RFT.STATE_FAULTS, seed=9, p_fault=0.7)
    ref, port = RFT.FaultInjector(RFT.FaultConfig(**kw)), \
        TFT.FaultInjector(TFT.FaultConfig(**kw))
    tm, _, tc = to_port(rmodel, _batch(np.random.default_rng(0), 4),
                        carry)
    for k in range(5):
        carry = ref.corrupt_carry(carry, lane=lane)
        rmodel = ref.corrupt_model(rmodel, lane=lane)
        tc = port.corrupt_carry(tc, lane=lane)
        tm = port.corrupt_model(tm, lane=lane)
        _trees_nan_equal(carry, tc, f"carry after call {k}")
        _trees_nan_equal(rmodel, tm, f"model after call {k}")
    assert port.log == ref.log
    assert {e["kind"] for e in port.log} == set(RFT.STATE_FAULTS)
    if lane is not None:      # the other lanes are untouched
        base = TLN.init_lane_carries(port_config(cfg, "torch"), 3,
                                     device="cpu")
        assert_trees_equal(TLN.unstack_lane(base, 0),
                           TLN.unstack_lane(tc, 0), "lane 0")


def test_kill_plan_and_switch_equal_reference():
    for seed in (0, 3, 100):
        a = RFT.FaultInjector(RFT.FaultConfig(kinds=RFT.PROCESS_FAULTS,
                                              seed=seed))
        b = TFT.FaultInjector(TFT.FaultConfig(kinds=TFT.PROCESS_FAULTS,
                                              seed=seed))
        assert a.plan_kill("chunk", 2, 10).spec() == \
            b.plan_kill("chunk", 2, 10).spec()
        assert a.log == b.log
    ks = TFT.KillSwitch.from_spec("snapshot:2")
    assert [ks.pending("chunk"), ks.pending("snapshot"),
            ks.pending("snapshot")] == [False, False, True]
    assert TFT.install_kill_from_env({}) is None
    with pytest.raises(ValueError, match="unknown kill site"):
        TFT.KillSwitch("nowhere", 1)
    with pytest.raises(ValueError, match="process_kill"):
        TFT.FaultInjector(TFT.FaultConfig(kinds=("burst",))).plan_kill(
            "chunk")
    with pytest.raises(ValueError) as want:
        RFT.FaultConfig(kinds=("meteor",))
    with pytest.raises(ValueError) as got:
        TFT.FaultConfig(kinds=("meteor",))
    assert str(got.value) == str(want.value)


def test_kill_point_sigkills_the_process_from_the_env_spec():
    """A child armed by ``PSPICE_KILL=chunk:3`` survives two hits of the
    chunk site and dies by SIGKILL at the third (no handlers run)."""
    code = textwrap.dedent("""
        import sys
        from repro_torch.runtime import faults as FT
        FT.install_kill_from_env()
        for k in range(5):
            FT.kill_point("refresh")
            FT.kill_point("chunk")
            print(k, flush=True)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PSPICE_KILL="chunk:3")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert proc.stdout.split() == ["0", "1"]
