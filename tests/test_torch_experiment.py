"""The port's own model builder and experiment against the reference's.

With the port's own ``build_model`` (whose reductions run in another
order), ``run_experiment``'s per-shedder FN is within FN_TOL of the
reference's and the headline ordering is the same; the built matrices
and tables are within rtol=1e-5, atol=1e-7.  The latency fit, and with it
the max rate that sets every overload run's arrivals, is the reference's
bit for bit: its sums follow the reference's reduction order.
"""
import numpy as np
import pytest

from repro.configs import pspice_paper as pp
from repro.cep import runner
from repro.data import streams
from repro_torch.cep import patterns as tpat
from repro_torch.cep import runner as trunner
from repro_torch.data import streams as tstreams

from _torch_bridge import cut, reference_built

FN_TOL = 0.02      # absolute, on the FN ratio


def test_run_experiment_own_model_close_to_reference():
    """The bus scenario at 3000 events: the port builds its own model."""
    sc = streams.get_scenario("bus")
    kw = dict(rate_multiplier=1.2, max_pms=sc.max_pms, bin_size=sc.bin_size,
              latency_bound=sc.latency_bound, seed=sc.seed, **pp.COST)
    ref = runner.run_experiment(sc.specs(), sc.raw(n=3000), **kw)
    tsc = tstreams.get_scenario("bus")
    got = trunner.run_experiment(tsc.specs(), tsc.raw(n=3000),
                                 backend="cuda", device="cpu", **kw)
    assert got.keys() == ref.keys()
    for sh in ref:
        assert abs(got[sh].fn - ref[sh].fn) <= FN_TOL, sh
        assert abs(got[sh].fn_match - ref[sh].fn_match) <= FN_TOL, sh
        np.testing.assert_allclose(got[sh].max_rate, ref[sh].max_rate,
                                   rtol=1e-5)
        assert got[sh].lb_compliance == pytest.approx(
            ref[sh].lb_compliance, abs=FN_TOL)
    order = lambda r: sorted(r, key=lambda s: r[s].fn_match)  # noqa: E731
    assert order(got) == order(ref)
    assert got["pspice"].fn_match <= min(got["pmbl"].fn_match,
                                         got["ebl"].fn_match) + 1e-9


def test_build_model_close_to_reference():
    sc, cfg, built, _ = reference_built("stock")
    tsc = tstreams.get_scenario("stock")
    raw = tsc.raw(n=1500)
    tcfg = trunner.default_config(
        tpat.compile_patterns(tsc.specs()),
        latency_bound=sc.latency_bound, max_pms=sc.max_pms, **pp.COST)
    warm = tstreams.classify(tsc.specs(), cut(raw, 0, 500), rate=1.0,
                             seed=sc.seed, device="cpu")
    tb = trunner.build_model(tsc.specs(), tcfg, warm, bin_size=sc.bin_size,
                             seed=sc.seed, device="cpu")
    for a, b in zip(tb.T + tb.R, built.T + built.R):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), 1e-5, 1e-7)
    np.testing.assert_allclose(tb.ut_stacked.numpy(),
                               np.asarray(built.ut_stacked), 1e-5, 1e-7)
    assert int(tb.f_model.kind) == int(built.f_model.kind)
    np.testing.assert_allclose(float(tb.f_model.a), float(built.f_model.a),
                               rtol=1e-5)
    assert tb.steady_n_pm == built.steady_n_pm
    np.testing.assert_allclose(tb.max_rate, built.max_rate, rtol=1e-5)


def test_max_rate_exact_at_the_paper_grid_warm_up():
    """Stock's warm-up as run_experiment makes it at the grid's 30 000
    events (the first 9 000): the port's f fit and max rate equal the
    reference's exactly, so an overload level puts every event at the
    reference's arrival time."""
    sc = streams.get_scenario("stock")
    raw = sc.raw()
    n_warm = int(raw.n * 0.3)
    cp = runner.pat.compile_patterns(sc.specs())
    cfg = runner.default_config(cp, latency_bound=sc.latency_bound,
                                max_pms=sc.max_pms, **pp.COST)
    warm = streams.classify(sc.specs(), cut(raw, 0, n_warm), rate=1.0,
                            seed=sc.seed)
    built = runner.build_model(sc.specs(), cfg, warm, bin_size=sc.bin_size,
                               seed=sc.seed)
    tsc = tstreams.get_scenario("stock")
    tcfg = trunner.default_config(
        tpat.compile_patterns(tsc.specs()),
        latency_bound=sc.latency_bound, max_pms=sc.max_pms, **pp.COST)
    twarm = tstreams.classify(tsc.specs(), cut(tsc.raw(), 0, n_warm),
                              rate=1.0, seed=sc.seed, device="cpu")
    tb = trunner.build_model(tsc.specs(), tcfg, twarm, bin_size=sc.bin_size,
                             seed=sc.seed, device="cpu")
    assert int(tb.f_model.kind) == int(built.f_model.kind)
    for f in ("a", "b"):
        assert getattr(tb.f_model, f).numpy().tobytes() == \
            np.asarray(getattr(built.f_model, f)).tobytes(), f
    assert tb.steady_n_pm == built.steady_n_pm
    assert tb.max_rate == built.max_rate
