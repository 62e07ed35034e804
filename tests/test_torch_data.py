"""The port's data layer against the reference: compiled-pattern arrays
and every EventBatch field array-equal (exact), for all three scenarios
and the paper's query families."""
import numpy as np
import pytest
import torch

from repro.cep import patterns as pat
from repro.data import streams
from repro_torch.cep import patterns as tpat
from repro_torch.data import streams as tstreams

SCENARIOS = ("stock", "soccer", "bus")


@pytest.mark.parametrize("make", [
    lambda p: [p.make_q1(window_size=500, num_symbols=6)],
    lambda p: [p.make_q2(window_size=900)],
    lambda p: [p.make_q3(any_n=a, window_size=150) for a in range(2, 6)],
    lambda p: [p.make_q4(any_n=3, window_size=600, slide=200)],
    lambda p: [p.make_q1(window_size=300), p.make_q3(any_n=3,
                                                     window_size=120),
               p.make_q4(any_n=2, window_size=200, slide=50)],
])
def test_compiled_patterns_equal(make):
    a = pat.compile_patterns(make(pat))
    b = tpat.compile_patterns(make(tpat))
    for f in ("trans", "kind", "spawn_mode", "window_size", "slide",
              "final_state", "weight", "uses_binding", "proc_cost",
              "spawn_counts"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_registry_equal(name):
    a, b = streams.get_scenario(name), tstreams.get_scenario(name)
    for f in ("name", "dataset", "n_default", "n_quick", "seed", "max_pms",
              "bin_size", "latency_bound"):
        assert getattr(a, f) == getattr(b, f), f
    assert [s.__dict__ for s in a.specs()] == \
        [s.__dict__ for s in b.specs()]
    ra, rb = a.raw(n=700), b.raw(n=700)
    for f in ("kind", "n", "num_types"):
        assert getattr(ra, f) == getattr(rb, f)
    for f in ("type_id", "attr", "group"):
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
    assert sorted(tstreams.SCENARIOS) == sorted(streams.SCENARIOS)


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("rate,rate_end", [(850.0, None), (300.0, 900.0)])
def test_event_batch_equal(name, rate, rate_end):
    sc, tsc = streams.get_scenario(name), tstreams.get_scenario(name)
    ev = streams.classify(sc.specs(), sc.raw(n=900), rate=rate, seed=3,
                          rate_end=rate_end)
    tev = tstreams.classify(tsc.specs(), tsc.raw(n=900), rate=rate, seed=3,
                            rate_end=rate_end, device="cpu")
    want = {"ev_class": torch.int32, "ev_bind": torch.int32,
            "ev_open": torch.bool, "ev_id": torch.int32,
            "ev_rand": torch.float32, "ebl_raw": torch.float32,
            "arrival": torch.float32}
    for f, dtype in want.items():
        x, y = np.asarray(getattr(ev, f)), getattr(tev, f)
        assert y.dtype == dtype and y.device.type == "cpu", f
        np.testing.assert_array_equal(x, y.numpy(), err_msg=f)


def test_drift_generator_equal():
    a = streams.gen_stock_drift(800, p_class=0.02, p_class_end=0.2,
                                hot_fraction_end=0.5, seed=4)
    b = tstreams.gen_stock_drift(800, p_class=0.02, p_class_end=0.2,
                                 hot_fraction_end=0.5, seed=4)
    for f in ("type_id", "attr", "group"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_unknown_scenario_raises():
    with pytest.raises(KeyError, match="unknown scenario"):
        tstreams.get_scenario("nope")
