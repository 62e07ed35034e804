"""The port's block backend on the quality sweep's scenarios, BITWISE.

Given the reference's BuiltModel of stock, soccer and bus (3 SEQ, 8 bound
ANY and 1 in-window ANY patterns; P = 3, 8, 1), ``run_with_shedder`` on
the port's ``cuda_block`` backend (on the CPU: the block kernel's plain
version) reproduces the reference's ``xla`` RunResult exactly: counters,
per-event latency and PM count, match sets.  (A file of its own: the
reference's model builds take most of its time.)
"""
import numpy as np
import pytest

from repro.cep import runner
from repro.configs import pspice_paper as pp
from repro_torch.cep import convert
from repro_torch.cep import patterns as tpat
from repro_torch.cep import runner as trunner
from repro_torch.data import streams as tstreams

from _torch_bridge import reference_built


@pytest.mark.parametrize("name", ["stock", "soccer", "bus"])
def test_scenarios_through_runner_exact(name):
    """Both PM shedders at 1.6x the fitted max rate, W = 32."""
    sc, cfg, built, raw_run = reference_built(name, n=600)
    rate = built.max_rate * 1.6
    tsc = tstreams.get_scenario(name)
    tcfg = trunner.default_config(
        tpat.compile_patterns(tsc.specs()),
        latency_bound=sc.latency_bound, max_pms=sc.max_pms,
        emit_matches=True, backend="cuda_block", block_events=32, **pp.COST)
    tbuilt = convert.built_from_numpy(convert.tree_to_numpy(built), "cpu")
    for shedder in ("pspice", "pmbl"):
        ref = runner.run_with_shedder(sc.specs(), cfg, built, raw_run,
                                      rate=rate, shedder=shedder,
                                      seed=sc.seed)
        got = trunner.run_with_shedder(tsc.specs(), tcfg, tbuilt, raw_run,
                                       rate=rate, shedder=shedder,
                                       seed=sc.seed, device="cpu")
        for f in ("complex_count", "pms_created", "l_e", "n_pm"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                          err_msg=f"{shedder} {f}")
        for f in ("pms_shed", "shed_calls", "overflow", "ebl_dropped"):
            assert getattr(got, f) == getattr(ref, f), (shedder, f)
        assert got.matches == ref.matches
        if name != "stock":
            assert ref.shed_calls > 0, "fixture must fire Algorithm 2"
