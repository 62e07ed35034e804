"""The paper's settings and E-BL's event-type model in the port against
the reference.

* ``repro_torch.configs.pspice_paper`` holds every name of
  ``repro.configs.pspice_paper`` with an equal value.
* ``ebl_type_utilities`` and ``ebl_drop_mask`` are bitwise the
  reference's; the mask's uniforms come from ``repro_torch.prng`` and
  ``jax.random`` respectively, in both threefry layouts.
* ``repro_torch.eval`` exports the reference's names (the sweep's
  lazily).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import pspice_paper as pp
from repro.core import shedder as shd
from repro_torch import prng
from repro_torch.configs import pspice_paper as tpp
from repro_torch.core import shedder as tshd

PAPER_NAMES = ("COST", "LATENCY_BOUND", "RATE_MULTIPLIER", "MAX_PMS",
               "BIN_SIZE", "WARM_FRAC", "Q1_WINDOW_SIZES", "Q2_WINDOW_SIZES",
               "Q3_PATTERN_SIZES", "Q4_PATTERN_SIZES", "RATE_GRID",
               "TAU_FACTORS")


def _public(mod):
    return {k for k in vars(mod) if k.isupper()}


def test_pspice_paper_names_equal_reference():
    assert _public(tpp) == _public(pp) == set(PAPER_NAMES)
    for name in PAPER_NAMES:
        a, b = getattr(tpp, name), getattr(pp, name)
        assert type(a) is type(b) and a == b, name


def _ebl_inputs(seed, n_types=40, n_classes=6, n_events=3000):
    rng = np.random.default_rng(seed)
    cls_of_type = rng.integers(0, n_classes, n_types).astype(np.int32)
    rep = rng.integers(0, 5, n_classes).astype(np.float32)
    freq = np.where(rng.random(n_types) < 0.2, 0.0,
                    rng.random(n_types)).astype(np.float32)
    types = rng.integers(0, n_types, n_events).astype(np.int32)
    return cls_of_type, rep, freq, types


@pytest.mark.parametrize("seed", range(4))
def test_ebl_type_utilities_bitwise(seed):
    cls_of_type, rep, freq, _ = _ebl_inputs(seed)
    want = np.asarray(shd.ebl_type_utilities(
        jnp.asarray(cls_of_type), jnp.asarray(rep), jnp.asarray(freq)))
    got = tshd.ebl_type_utilities(torch.from_numpy(cls_of_type),
                                  torch.from_numpy(rep),
                                  torch.from_numpy(freq)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got[cls_of_type == 0] == 0).all()


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed,n_events,frac", [
    (0, 3000, 0.2), (1, 3001, 0.5), (2, 17, 0.9), (3, 1000, 0.05)])
def test_ebl_drop_mask_bitwise(seed, n_events, frac, partitionable):
    cls_of_type, rep, freq, types = _ebl_inputs(seed, n_events=n_events)
    utils = np.array(shd.ebl_type_utilities(
        jnp.asarray(cls_of_type), jnp.asarray(rep), jnp.asarray(freq)))
    old = (jax.config.jax_threefry_partitionable, prng.PARTITIONABLE)
    jax.config.update("jax_threefry_partitionable", partitionable)
    prng.PARTITIONABLE = partitionable
    try:
        want = np.asarray(shd.ebl_drop_mask(
            jax.random.PRNGKey(seed), jnp.asarray(types),
            jnp.asarray(utils), frac))
        got = tshd.ebl_drop_mask(prng.PRNGKey(seed), torch.from_numpy(types),
                                 torch.from_numpy(utils), frac).numpy()
    finally:
        jax.config.update("jax_threefry_partitionable", old[0])
        prng.PARTITIONABLE = old[1]
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < n_events


def test_eval_package_exports_the_references_names():
    import repro.eval as ref_eval
    import repro_torch.eval as port_eval
    assert port_eval.__all__ == ref_eval.__all__
    from repro_torch.eval import sweep
    for name in ("run_quality_sweep", "check_headline", "OVERLOAD_LEVELS"):
        assert getattr(port_eval, name) is getattr(sweep, name)
    assert port_eval.OVERLOAD_LEVELS == ref_eval.OVERLOAD_LEVELS
    with pytest.raises(AttributeError):
        port_eval.no_such_name
