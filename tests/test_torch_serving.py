"""The port's pSPICE scheduler and serve driver on the CPU against the
reference's: the same config and workload make the same admissions,
evictions and completions, in the same order, step for step, and the
same ``metrics()``, under every policy."""
import dataclasses

import numpy as np
import pytest

from repro.serving import scheduler as RS
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serving import scheduler as TS

POLICIES = ("pspice", "random", "admission")


def _state(s):
    return (round(s.time, 12), [r.req_id for r in s.active],
            [r.req_id for r in s.queue],
            [(r.req_id, r.done, r.evicted, r.finish_time, r.decoded)
             for r in s.finished], s.evictions)


def _lockstep(cfg_kw, n, rate, seed, warmup_frac=0.3):
    """Drive both schedulers through run_simulation's loop side by side;
    compare their whole state after every step."""
    scheds, reqs = [], []
    for mod, kw in ((RS, {}), (TS, {"device": "cpu"})):
        cfg = mod.SchedulerConfig(**cfg_kw)
        scheds.append(mod.PSpiceScheduler(cfg, **kw))
        reqs.append(sorted(mod.synth_workload(n, rate=rate, cfg=cfg,
                                              seed=seed),
                           key=lambda r: r.arrival))
    i = 0
    n_warm = int(n * warmup_frac)
    built = []
    steps = 0
    while len(scheds[0].finished) < n:
        while i < n and reqs[0][i].arrival <= scheds[0].time:
            for s, rq in zip(scheds, reqs):
                s.submit(rq[i])
            i += 1
        if i == n_warm and scheds[0].ut is None:
            for s in scheds:
                s.build_model()
            built.append(steps)
        if not scheds[0].active and not scheds[0].queue and i < n:
            for s, rq in zip(scheds, reqs):
                s.time = max(s.time, rq[i].arrival)
            continue
        for s in scheds:
            s.run_step()
        steps += 1
        if scheds[0].ut is None and len(scheds[0].finished) >= n_warm:
            for s in scheds:
                s.build_model()
            built.append(steps)
        assert _state(scheds[1]) == _state(scheds[0]), f"step {steps}"
    assert len(scheds[1].finished) == n and built
    return scheds


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", ["runtime_test", "serve_defaults"])
def test_scheduler_decisions_equal_reference(policy, case):
    if case == "runtime_test":      # tests/test_runtime.py:499's workload
        cfg_kw = dict(max_slots=8, slo=0.5, policy=policy, seed=0)
        n, rate, seed = 200, 60.0, 1
    else:                           # serve's defaults, a 6 ms decode step
        c = 6e-3
        cfg_kw = dict(max_slots=16, slo=1.0, policy=policy,
                      step_cost_base=c * 0.5, step_cost_per_seq=c * 0.5 / 16)
        n, rate, seed = 64, 50.0, 0
    ref, port = _lockstep(cfg_kw, n, rate, seed)
    assert port.metrics() == ref.metrics()
    if policy != "admission":
        assert ref.evictions > 0        # the shedder really chose victims
    # The learned utility tables agree to float32 rounding.
    assert np.abs(port._ut_np - np.asarray(ref.ut.table)).max() <= \
        1e-5 * np.abs(port._ut_np).max()


@pytest.mark.parametrize("policy", POLICIES)
def test_run_simulation_equals_reference(policy):
    kw = dict(max_slots=8, slo=0.5, policy=policy, seed=0)
    rcfg, tcfg = RS.SchedulerConfig(**kw), TS.SchedulerConfig(**kw)
    rm = RS.run_simulation(rcfg, RS.synth_workload(150, 60.0, rcfg, seed=2))
    tm = TS.run_simulation(tcfg, TS.synth_workload(150, 60.0, tcfg, seed=2),
                           device="cpu")
    assert tm == rm


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synth_workload_equals_reference(seed):
    rcfg, tcfg = RS.SchedulerConfig(slo=0.7), TS.SchedulerConfig(slo=0.7)
    a = RS.synth_workload(300, 40.0, rcfg, seed=seed)
    b = TS.synth_workload(300, 40.0, tcfg, seed=seed)
    assert [dataclasses.astuple(r) for r in a] == \
        [dataclasses.astuple(r) for r in b]


def test_serve_finishes_every_request_on_the_cpu():
    cfg = TR.get_smoke_config("internlm2-1.8b")
    params = TT.init_params(cfg, seed=0, device="cpu")
    lines = []
    for policy in POLICIES:
        out = tserve.serve(cfg, params, requests=32, policy=policy,
                           device="cpu", log=lines.append)
        m = out["metrics"]
        assert out["finished"] == 32
        assert m["completed"] + m["evicted"] == 32
        # The measured step cost sets the virtual clock, so how many real
        # steps run depends on the host's load; never more than max_len - 1.
        assert out["decode_steps"] <= 95 and out["step_cost"] > 0
    assert any("utility model built" in s for s in lines)


def test_serve_with_a_given_step_cost_is_reproducible():
    """A given step cost replaces the measurement: the virtual clock then
    depends on nothing of the host, so the metrics repeat exactly."""
    cfg = TR.get_smoke_config("internlm2-1.8b")
    params = TT.init_params(cfg, seed=0, device="cpu")
    for policy in POLICIES:
        lines = []
        runs = [tserve.serve(cfg, params, requests=24, policy=policy,
                             step_cost=0.03, device="cpu",
                             log=lines.append) for _ in range(2)]
        assert runs[0]["metrics"] == runs[1]["metrics"]
        assert runs[0]["step_cost"] == 0.03 and runs[0]["finished"] == 24
        assert not any("measured" in s for s in lines)


def test_serve_main_runs_the_smoke_config_on_the_cpu(capsys):
    assert tserve.main(["--device", "cpu", "--requests", "16",
                        "--policy", "random"]) == 0
    out = capsys.readouterr().out
    assert "measured decode_step cost" in out and "policy=random" in out


def test_scheduler_needs_a_card_unless_told_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.PSpiceScheduler(TS.SchedulerConfig())
