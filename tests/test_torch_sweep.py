"""The port's quality sweep (``repro_torch.eval.sweep``) against the
reference's ``repro.eval.sweep``.

* ``check_headline`` returns the reference's violations, text included,
  on hand-made payloads.
* ``run_dataset`` / ``run_quality_sweep`` on a tiny stock-shaped scenario
  (the stock patterns and generator at 2 000 events, registered in both
  packages' registries for the test and removed afterwards), at levels
  1.2 and 1.6: the same payload structure as the reference's; with the
  port's own model builder (whose reductions run in another order) every
  cell's FN within FN_TOL of the reference's and the same ordering; with
  the reference's model handed across (as ``_torch_bridge`` does) every
  cell EXACTLY the reference's.
* The command line writes the port's own JSON under ``build/`` by
  default.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.cep import engine as eng
from repro.cep import runner
from repro.data import streams
from repro.eval import sweep
from repro_torch import prng
from repro_torch.cep import convert
from repro_torch.cep import runner as trunner
from repro_torch.data import streams as tstreams
from repro_torch.eval import sweep as tsweep

FN_TOL = 0.02      # absolute, on the FN ratio (test_torch_experiment.py)
TINY = "stock_tiny"
LEVELS = (1.2, 1.6)


@pytest.fixture(scope="module")
def tiny():
    """The stock scenario's patterns and generator at 2 000 events,
    registered in both registries for this module's tests."""
    for mod in (streams, tstreams):
        sc = mod.get_scenario("stock")
        mod.register_scenario(dataclasses.replace(
            sc, name=TINY, n_default=2000, n_quick=1500))
    try:
        yield TINY
    finally:
        for mod in (streams, tstreams):
            del mod.SCENARIOS[TINY]


@pytest.fixture(scope="module")
def reference_sweep(tiny):
    return sweep.run_quality_sweep(datasets=(tiny,), levels=LEVELS)


def _shape(x):
    """The structure of a payload: dict keys and leaf types."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    return type(x).__name__


def _cells(bench):
    for ds, grid in bench["datasets"].items():
        for lv, cells in grid["levels"].items():
            for sh, cell in cells.items():
                yield (ds, lv, sh), cell


def _order(cells):
    return sorted(cells, key=lambda sh: (cells[sh]["fn"], sh))


def test_sweep_close_to_reference_own_model(tiny, reference_sweep):
    ref = reference_sweep
    got = tsweep.run_quality_sweep(datasets=(tiny,), levels=LEVELS,
                                   device="cpu")
    cfg = dict(got["config"])
    assert cfg.pop("threefry_partitionable") is prng.PARTITIONABLE
    assert cfg == ref["config"]
    assert _shape(dict(got, config=cfg)) == _shape(ref)
    got_cells, ref_cells = dict(_cells(got)), dict(_cells(ref))
    assert got_cells.keys() == ref_cells.keys()
    for key, want in ref_cells.items():
        assert abs(got_cells[key]["fn"] - want["fn"]) <= FN_TOL, key
        np.testing.assert_allclose(got_cells[key]["max_rate"],
                                   want["max_rate"], rtol=1e-5)
    for lv in ref["datasets"][tiny]["levels"]:
        assert _order(got["datasets"][tiny]["levels"][lv]) == \
            _order(ref["datasets"][tiny]["levels"][lv]), lv
    assert got["violations"] == ref["violations"]
    assert got["ordering_ok"] == ref["ordering_ok"]


def _reference_builder(monkeypatch):
    """The port's runner builds the reference's model: its build_model
    hands the warm-up events to the reference's and carries the
    BuiltModel across as NumPy."""
    def build_model(specs, cfg, warm_events, bin_size=64,
                    use_remaining_time=True, seed=0, device=None):
        ref_cfg = runner.default_config(
            runner.pat.compile_patterns(specs), **{
                f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg)
                if f.name not in ("backend", "block_events")})
        ev = eng.EventBatch(*(jnp.asarray(x.numpy())
                              for x in warm_events))
        built = runner.build_model(specs, ref_cfg, ev, bin_size=bin_size,
                                   use_remaining_time=use_remaining_time,
                                   seed=seed)
        return convert.built_from_numpy(convert.tree_to_numpy(built),
                                        device)
    monkeypatch.setattr(trunner, "build_model", build_model)


def test_sweep_exact_given_reference_model(tiny, reference_sweep,
                                           monkeypatch):
    _reference_builder(monkeypatch)
    got = tsweep.run_dataset(tiny, levels=LEVELS, backend="cuda",
                             device="cpu")
    want = reference_sweep["datasets"][tiny]
    assert got == want
    cells = want["levels"]["1.2"]
    assert cells["pspice"]["shed_calls"] > 0
    assert cells["pmbl"]["shed_calls"] > 0
    assert cells["ebl"]["ebl_dropped"] > 0


def test_headline_gate_equals_reference_on_payloads():
    payloads = [
        {},
        {"headline": {}},
        {"config": {"datasets": ["stock", "bus"]},
         "headline": {"stock": {"pspice": 0.2, "pmbl": 0.4, "ebl": 0.3}}},
        {"headline": {"stock": {"pmbl": 0.4, "ebl": 0.3}}},
        {"headline": {"stock": {"pspice": 0.5, "pmbl": 0.4, "ebl": 0.3},
                      "bus": {"pspice": 0.1, "pmbl": 0.1 - 1e-10,
                              "ebl": None}}},
        {"headline": {"soccer": {"pspice": None, "pmbl": 0.1}}},
        {"config": {"datasets": ["stock"]},
         "headline": {"stock": {"pspice": 0.2299, "pmbl": 0.4023,
                                "ebl": 0.3563}}},
    ]
    for p in payloads:
        assert tsweep.check_headline(p) == sweep.check_headline(p), p
    assert tsweep.check_headline(payloads[-1]) == []
    assert len(tsweep.check_headline(payloads[4])) == 3


def test_constants_equal_reference():
    for name in ("OVERLOAD_LEVELS", "HEADLINE_LEVEL", "DATASETS",
                 "SHEDDERS"):
        assert getattr(tsweep, name) == getattr(sweep, name), name


def test_command_line_writes_its_own_json(tiny, tmp_path, monkeypatch):
    """``main`` runs the grid and writes the payload (under ``build/`` by
    default, relative to the working directory), never the reference's
    committed file; ``--check`` gates on the ordering."""
    calls = {}

    def fake(**kw):
        calls.update(kw)
        bench = {"config": {"datasets": [tiny], "headline_level": 1.2},
                 "headline": {tiny: {"pspice": 0.5, "pmbl": 0.4}}}
        bench["violations"] = tsweep.check_headline(bench)
        bench["ordering_ok"] = not bench["violations"]
        return bench

    monkeypatch.setattr(tsweep, "run_quality_sweep", fake)
    monkeypatch.chdir(tmp_path)
    assert tsweep.main(["--quick", "--device", "cpu"]) == 0
    assert calls == dict(quick=True, results_dir=None, backend=None,
                         device="cpu")
    out = tmp_path / tsweep.DEFAULT_OUT
    assert out.parent.name == "build"
    assert json.loads(out.read_text())["ordering_ok"] is False
    assert tsweep.main(["--check", "--out", str(tmp_path / "q.json"),
                        "--backend", "cuda_block"]) == 1
    assert calls["backend"] == "cuda_block"
