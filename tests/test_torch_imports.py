"""Import hygiene and device rules of the port.

* Importing every ``repro_torch`` module leaves no ``jax*`` and no
  ``repro`` module in ``sys.modules`` (checked in a fresh interpreter),
  and no port source nor ``chip_smoke.py`` imports jax, triton or the
  reference package (AST scan).
* Without CUDA the entry points raise unless ``device="cpu"`` is passed:
  there is no silent CPU fallback.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "triton", "repro")


# The quality evaluation's modules (the oracle, the sweep and the paper's
# settings) are held to the same rules as the rest of the port.
QUALITY_MODULES = ("repro_torch.configs.pspice_paper",
                   "repro_torch.eval.oracle", "repro_torch.eval.oracle_cases",
                   "repro_torch.eval.sweep")


def _modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'repro'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 20 and res["bad"] == [], res


# The streaming runtime's modules, likewise (its resilience layer and
# durable persistence among them).
RUNTIME_MODULES = ("repro_torch.runtime", "repro_torch.runtime.chunker",
                   "repro_torch.runtime.lanes", "repro_torch.runtime.refresh",
                   "repro_torch.runtime.service",
                   "repro_torch.runtime.telemetry",
                   "repro_torch.runtime.faults", "repro_torch.runtime.guard",
                   "repro_torch.runtime.ingest",
                   "repro_torch.runtime.persist",
                   "repro_torch.runtime.supervisor")


def test_quality_modules_are_scanned():
    assert set(QUALITY_MODULES) <= set(_modules())


def test_runtime_modules_are_scanned():
    assert set(RUNTIME_MODULES) <= set(_modules())
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    for m in RUNTIME_MODULES:
        rel = m.replace(".", "/")
        assert f"src/{rel}.py" in scanned or \
            f"src/{rel}/__init__.py" in scanned, m


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _stock():
    from repro_torch.cep import patterns as pat
    from repro_torch.cep import runner
    from repro_torch.data import streams
    sc = streams.get_scenario("stock")
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=16)
    return sc, specs, cp, cfg


def test_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.cep import engine, runner
    from repro_torch.data import streams
    from repro_torch.eval import sweep
    sc, specs, cp, cfg = _stock()
    raw = sc.raw(n=60)
    calls = {
        "classify": lambda: streams.classify(specs, raw, rate=10.0),
        "make_model": lambda: engine.make_model(cp, cfg),
        "init_carry": lambda: engine.init_carry(cfg),
        "run_experiment": lambda: runner.run_experiment(specs, raw,
                                                        max_pms=16),
        "run_dataset": lambda: sweep.run_dataset("stock", levels=(1.2,),
                                                 quick=True),
    }
    ev = streams.classify(specs, raw, rate=10.0, device="cpu")
    model = engine.make_model(cp, cfg, device="cpu")
    carry = engine.init_carry(cfg, device="cpu")
    calls["run_engine"] = lambda: engine.run_engine(cfg, model, ev, carry)
    calls["build_model"] = lambda: runner.build_model(specs, cfg, ev)
    calls["run_with_shedder"] = lambda: runner.run_with_shedder(
        specs, cfg, None, raw, rate=10.0, shedder="none")
    from repro_torch import runtime
    calls["StreamRuntime"] = lambda: runtime.StreamRuntime(cfg, model)
    calls["MultiTenantRuntime"] = lambda: runtime.MultiTenantRuntime(
        cfg, runtime.broadcast_model(model, 2), 2)
    calls["init_lane_carries"] = lambda: runtime.init_lane_carries(cfg, 2)
    calls["run_chunk_lanes"] = lambda: runtime.run_chunk_lanes(
        cfg, runtime.broadcast_model(model, 1), runtime.stack([ev]),
        runtime.stack([carry]), 0)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # With device="cpu" the same entry points run.
    carry2, outs = engine.run_engine(cfg, model, ev, carry, device="cpu")
    assert outs.l_e.shape == (60,) and outs.l_e.device.type == "cpu"


def test_inputs_on_another_device_are_refused():
    from repro_torch.cep import engine
    sc, specs, cp, cfg = _stock()
    model = engine.make_model(cp, cfg, device="cpu")
    carry = engine.init_carry(cfg, device="cpu")
    from repro_torch.data import streams
    ev = streams.classify(specs, sc.raw(n=10), rate=10.0, device="cpu")
    meta_ev = engine.EventBatch(*(x.to("meta") for x in ev))
    with pytest.raises(ValueError, match="expected cpu"):
        engine.run_engine(cfg, model, meta_ev, carry, device="cpu")


def test_pattern_parallel_is_a_later_slice():
    from repro_torch.cep import runner
    sc, specs, cp, cfg = _stock()
    with pytest.raises(NotImplementedError, match="dist"):
        runner.run_experiment(specs, sc.raw(n=60), pattern_parallel=True,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="dist"):
        runner.run_with_shedder(specs, cfg, None, sc.raw(n=60), rate=1.0,
                                shedder="none", pattern_parallel=True,
                                device="cpu")
