"""The port's runner against the reference's.

Given the reference's BuiltModel (carried across as NumPy), the port's
``run_with_shedder`` reproduces the reference's RunResult EXACTLY on
every scenario and shedder: counters, per-event latency and PM count,
match sets.  (The port's own model builder is held to the reference in
test_torch_experiment.py.)
"""
import numpy as np
import pytest

from repro.cep import runner
from repro.configs import pspice_paper as pp
from repro.data import streams
from repro_torch.cep import convert
from repro_torch.cep import patterns as tpat
from repro_torch.cep import runner as trunner
from repro_torch.data import streams as tstreams

from _torch_bridge import reference_built

SHEDDERS = ("none", "pspice", "pmbl", "ebl")


@pytest.mark.parametrize("name", ["stock", "soccer", "bus"])
@pytest.mark.parametrize("shedder", SHEDDERS)
def test_run_with_shedder_exact_given_reference_model(name, shedder):
    sc, cfg, built, raw_run = reference_built(name)
    rate = built.max_rate * 1.6
    ref = runner.run_with_shedder(sc.specs(), cfg, built, raw_run, rate=rate,
                                  shedder=shedder, seed=sc.seed)
    tsc = tstreams.get_scenario(name)
    tcfg = trunner.default_config(
        tpat.compile_patterns(tsc.specs()),
        latency_bound=sc.latency_bound, max_pms=sc.max_pms,
        emit_matches=True, backend="cuda", **pp.COST)
    tbuilt = convert.built_from_numpy(convert.tree_to_numpy(built), "cpu")
    got = trunner.run_with_shedder(tsc.specs(), tcfg, tbuilt, raw_run,
                                   rate=rate, shedder=shedder, seed=sc.seed,
                                   device="cpu")
    for f in ("complex_count", "pms_created", "l_e", "n_pm"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    for f in ("pms_shed", "shed_calls", "overflow", "ebl_dropped"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.matches == ref.matches
    if shedder in ("pspice", "pmbl") and name != "stock":
        assert ref.shed_calls > 0, "fixture must fire Algorithm 2"
