"""The port's examples (``examples/torch_*.py``) on the CPU, held to the
reference examples' computations at small sizes.

* ``torch_quickstart``: ``run_experiment`` on the quickstart's stream (Q1
  over 10 symbols, window 4 000, N = 128, ×1.2) at 20 000 events, where
  every shedder sheds: FN, PMs shed, events dropped and the printed table
  equal the reference's ``runner.run_experiment`` with the same
  arguments;
* ``torch_runtime_multitenant``: 2 tenants × 4 096 drifting events, refresh
  every 4 chunks: the final carry bitwise the reference's meshless
  ``MultiTenantRuntime`` at the same size, and the example's default
  backend (the block kernel's plain version here) equal to ``torch``;
* ``torch_serve_slo``: goodput, completions and evictions of each policy
  equal the reference scheduler's;
* ``torch_train_lm``: finite losses, the NaN step restores the last
  checkpoint, and the second run resumes from the first's last step.

Each example runs on the GPU unless given ``--device cpu``: without CUDA
its default raises.
"""
import importlib
import math
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

from _torch_bridge import assert_trees_equal  # noqa: E402

EXAMPLES = ("torch_quickstart", "torch_runtime_multitenant",
            "torch_serve_slo", "torch_train_lm")
QS_EVENTS = 20_000
RT_LANES, RT_EVENTS, RT_CHUNK, RT_PUSH = 2, 4096, 1024, 3000


def _example(name):
    return importlib.import_module(name)


def test_quickstart_table_equals_reference():
    from repro.cep import patterns as pat
    from repro.cep import runner
    from repro.data import streams
    ex = _example("torch_quickstart")
    got = ex.experiment(QS_EVENTS, backend="torch", device="cpu")
    spec = pat.make_q1(window_size=4000, num_symbols=10)
    raw = streams.gen_stock(QS_EVENTS, num_symbols=500, pattern_symbols=10,
                            hot_fraction=0.9, p_class=0.03, seed=1)
    want = runner.run_experiment(
        [spec], raw, shedders=ex.SHEDDERS, rate_multiplier=1.2,
        latency_bound=1.0, max_pms=128, bin_size=64, **ex.COST)
    assert list(got) == list(want) == list(ex.SHEDDERS)
    for sh in ex.SHEDDERS:
        g, w = got[sh], want[sh]
        assert (g.fn, g.max_rate, g.match_probability) == \
            (w.fn, w.max_rate, w.match_probability), sh
        assert float(g.result.pms_shed) == float(w.result.pms_shed), sh
        assert float(g.result.ebl_dropped) == float(w.result.ebl_dropped)
    assert ex.table(got) == ex.table(want)
    assert float(got["pspice"].result.pms_shed) > 0
    assert float(got["ebl"].result.ebl_dropped) > 0


def test_quickstart_main_prints_its_table(capsys):
    ex = _example("torch_quickstart")
    assert ex.main(["--device", "cpu", "--events", "2000", "--backend",
                    "torch"]) == 0
    out = capsys.readouterr().out
    rows = [ln.split()[0] for ln in out.splitlines()
            if re.match(r"^(pspice|pmbl|ebl) ", ln)]
    assert rows == list(ex.SHEDDERS)
    assert "max operator throughput" in out


def _reference_runtime():
    from repro import runtime as RT
    from repro.cep import engine as eng
    from repro.cep import patterns as pat
    from repro.cep import runner
    from repro.data import streams
    ex = _example("torch_runtime_multitenant")
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=128, latency_bound=0.02,
                                gather_stats=True, shedder="pspice",
                                **ex.COST)
    model = eng.make_model(cp, cfg)
    rate = 1.0 / (cfg.c_base + cfg.c_match * 0.3 * cfg.max_pms)
    evs = []
    for lane in range(RT_LANES):
        raw = streams.gen_stock_drift(RT_EVENTS, num_symbols=50,
                                      pattern_symbols=4, p_class=0.03,
                                      p_class_end=0.10, seed=100 + lane)
        evs.append(streams.classify(specs, raw, rate=rate * (1 + 0.2 * lane),
                                    rate_end=4.0 * rate, seed=lane))
    mt = RT.MultiTenantRuntime(
        cfg, RT.broadcast_model(model, RT_LANES), num_lanes=RT_LANES,
        specs=specs, rt=RT.RuntimeConfig(
            chunk_size=RT_CHUNK, refresh=RT.RefreshConfig(
                every_chunks=4, min_observations=256, decay=0.5)))
    evL = RT.stack(evs)
    for s in range(0, RT_EVENTS, RT_PUSH):
        mt.push(RT.slice_events(evL, s, min(s + RT_PUSH, RT_EVENTS), axis=1),
                flush=s + RT_PUSH >= RT_EVENTS)
    return mt


def test_runtime_example_equals_reference_runtime():
    """Bar: bit for bit in every carry leaf, refresh included, and the
    same telemetry counts and refresh rounds."""
    ex = _example("torch_runtime_multitenant")
    lines = []
    got = ex.run(RT_LANES, RT_EVENTS, RT_CHUNK, RT_PUSH, backend="torch",
                 device="cpu", log=lines.append)
    want = _reference_runtime()
    assert_trees_equal(want.carry, got.carry, "runtime example carry")
    assert [s.refresh_count for s in got.refresh_state] == \
        [s.refresh_count for s in want.refresh_state]
    assert min(s.refresh_count for s in got.refresh_state) >= 1
    ga, wa = got.telemetry.aggregate(), want.telemetry.aggregate()
    for k in ("n_chunks", "n_events", "pms_shed", "completions",
              "refreshes"):
        assert ga[k] == wa[k], k
    assert ga["pms_shed"] > 0
    assert any(ln.startswith("per-tenant completions") for ln in lines)


def test_runtime_example_default_backend_equals_torch(capsys):
    """The example's default backend (the block kernel; on the CPU its
    plain version) through ``main`` ends where ``torch`` does."""
    ex = _example("torch_runtime_multitenant")
    args = dict(lanes=2, events=1024, chunk=256, push=700)
    want = ex.run(**args, backend="torch", device="cpu",
                  log=lambda *a: None)
    got = ex.run(**args, device="cpu", log=lambda *a: None)
    assert got.cfg.backend == "cuda_block"
    assert_trees_equal(want.carry, got.carry, "cuda_block vs torch")
    assert ex.main(["--device", "cpu", "--lanes", "2", "--events", "1024",
                    "--chunk", "256", "--push", "700"]) == 0
    assert "aggregate:" in capsys.readouterr().out


def test_serve_example_equals_reference_scheduler(capsys):
    from repro.serving import scheduler as RS
    ex = _example("torch_serve_slo")
    got = ex.simulate(300, device="cpu")
    for pol in ex.POLICIES:
        cfg = RS.SchedulerConfig(policy=pol, max_slots=48, slo=1.5)
        want = RS.run_simulation(cfg, RS.synth_workload(300, rate=120.0,
                                                        cfg=cfg, seed=3))
        for k in ("goodput", "completed", "evictions"):
            assert got[pol][k] == want[k], (pol, k)
    assert got["pspice"]["goodput"] >= got["admission"]["goodput"]
    assert ex.main(["--device", "cpu", "--requests", "300"]) == 0
    out = capsys.readouterr().out
    assert all(re.search(rf"^{p} ", out, re.M) for p in ex.POLICIES)


def test_train_example_restores_and_resumes(capsys):
    ex = _example("torch_train_lm")
    assert ex.main(["--device", "cpu", "--steps", "6", "--resume-steps", "8",
                    "--ckpt-every", "2", "--inject-nan-at", "3"]) == 0
    out = capsys.readouterr().out
    phase1, phase2 = out.split("=== phase 2")
    steps = [(int(s), float(x)) for s, x in re.findall(
        r"\[train\] step +(\d+) loss ([-0-9.naif]+)", out)]
    assert steps and all(math.isfinite(x) for _, x in steps)
    assert [s for s, _ in steps] == [0, 1, 2, 4, 5, 6, 7]
    assert "NON-FINITE loss" in phase1 and "restored step 2" in phase1
    assert "resuming from checkpoint step 6" in phase2
    first = re.search(r"\[train\] step +(\d+) loss", phase2)
    assert int(first.group(1)) == 6


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_card_by_default(name, monkeypatch):
    """No silent CPU fallback: without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("the no-card behaviour needs a machine without CUDA")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = {"torch_quickstart": ["--events", "500"],
             "torch_runtime_multitenant": ["--lanes", "1", "--events", "64"],
             "torch_serve_slo": ["--requests", "20"],
             "torch_train_lm": ["--steps", "1", "--resume-steps", "1"]}
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main(small[name])


def test_examples_mirror_the_reference_examples():
    """Every reference example has its port counterpart."""
    ref = sorted(p.stem for p in (ROOT / "examples").glob("*.py")
                 if not p.stem.startswith("torch_"))
    assert [f"torch_{n}" for n in ref] == sorted(EXAMPLES)
    assert np.all([(ROOT / "examples" / f"{n}.py").exists()
                   for n in EXAMPLES])
