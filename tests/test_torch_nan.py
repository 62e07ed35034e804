"""The per-event host loop keeps a NaN where the reference's
``jnp.maximum`` does.

The port's engine runs Algorithm 1, E-BL and the clock on host float32
scalars.  Python's ``max`` drops a NaN in its second argument, where the
reference's ``jnp.maximum(c.sim_time, arrival)`` and ``jnp.maximum(
ebl_frac * decay, d_need)`` return it.  A hand-poisoned carry (a NaN
EMA gap with a finite clock, under overload, so that E-BL's shed holds)
and a NaN arrival run through the port's "torch", "cuda" and
"cuda_block" backends (the kernels' plain versions on the CPU) and the
reference's ``xla``; the whole carry and every StepOut must be equal bit
for bit, a NaN equal to a NaN.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.cep import engine as eng
from repro.cep import patterns as pat
from repro.cep import runner

from _torch_bridge import COST, assert_trees_equal, port_config, to_port

N_EV, NAN_AT = 400, 330


@functools.lru_cache(maxsize=None)
def _reference(shedder, poison):
    from repro.data import streams
    specs = [pat.make_q1(window_size=400, num_symbols=4)]
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, max_pms=32, latency_bound=0.005,
                                gather_stats=True, emit_matches=True,
                                shedder=shedder, block_events=16, **COST)
    model = eng.make_model(cp, cfg)
    rate = 2.0 * 3.0 / (cfg.c_base + cfg.c_match * 0.3 * cfg.max_pms)
    raw = streams.gen_stock(N_EV, num_symbols=50, pattern_symbols=4,
                            p_class=0.05, seed=100)
    ev = streams.classify(specs, raw, rate=rate, seed=0)
    carry0 = eng.init_carry(cfg)
    if poison == "ema_gap":
        carry0 = carry0._replace(ema_gap=jnp.float32(np.nan))
    else:
        ev = ev._replace(arrival=ev.arrival.at[NAN_AT].set(np.nan))
    carry, outs = eng.run_engine(cfg, model, ev, carry0)
    return cfg, model, ev, carry0, carry, outs


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_block"])
@pytest.mark.parametrize("poison", ["ema_gap", "arrival"])
@pytest.mark.parametrize("shedder", ["ebl", "pspice"])
def test_nan_kept_as_the_reference_keeps_it(shedder, poison, backend):
    from repro_torch.cep import engine as teng
    cfg, model, ev, carry0, carry, outs = _reference(shedder, poison)
    if poison == "ema_gap" and shedder == "ebl":
        # The fixture's overload holds the shed: E-BL's drop fraction
        # takes the NaN demand.
        assert np.isnan(float(carry.ebl_frac))
    if poison == "arrival":
        assert np.isnan(float(carry.sim_time))
        assert np.isfinite(np.asarray(outs.l_e)[:NAN_AT]).all()
    if shedder == "pspice":
        assert float(carry.shed_calls) > 0, "fixture must fire Alg. 2"
    t_carry, t_outs = teng.run_engine(port_config(cfg, backend),
                                      *to_port(model, ev, carry0),
                                      device="cpu")
    what = f"{shedder}/{poison}/{backend}"
    assert_trees_equal(carry, t_carry, what + " carry", equal_nan=True)
    assert_trees_equal(outs, t_outs, what + " outs", equal_nan=True)


def test_nan_max32_is_jnp_maximum():
    from repro_torch import fp
    vals = np.array([np.nan, -np.inf, -1.5, 0.0, 2.25, np.inf], np.float32)
    for a in vals:
        for b in vals:
            want = np.asarray(jnp.maximum(jnp.float32(a), jnp.float32(b)))
            got = fp.nan_max32(a, b)
            assert np.array_equal(want, got, equal_nan=True), (a, b, got)
