"""The port's threefry2x32 against ``jax.random``: keys, splits and
uniforms BITWISE, in the layout the installed jax uses by default (read
from ``jax.config.jax_threefry_partitionable``, not assumed) and in the
other one."""
import jax
import numpy as np
import pytest

from repro_torch import prng

SEEDS = (0, 1, 7, 123456789, 2 ** 31 - 1)
SHAPES = ((1,), (2,), (7,), (3, 5), (3 * 256,), (8 * 53,))


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_port_default_is_installed_default():
    assert prng.PARTITIONABLE == bool(jax.config.jax_threefry_partitionable)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_equal(seed):
    np.testing.assert_array_equal(_bits(jax.random.PRNGKey(seed)),
                                  prng.PRNGKey(seed).numpy())


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_uniform_equal(seed, partitionable):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for num in (2, 3, 5):
            np.testing.assert_array_equal(
                _bits(jax.random.split(key, num)),
                prng.split(tkey, num, partitionable=partitionable).numpy())
        # A chain of splits, as the engine advances its key per fire.
        for _ in range(4):
            key, sub = jax.random.split(key)
            tks = prng.split(tkey, partitionable=partitionable)
            tkey, tsub = tks[0], tks[1]
            np.testing.assert_array_equal(_bits(key), tkey.numpy())
            for shape in SHAPES:
                np.testing.assert_array_equal(
                    np.asarray(jax.random.uniform(sub, shape)),
                    prng.uniform(tsub, shape,
                                 partitionable=partitionable).numpy())
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def test_uniform_range_and_dtype():
    u = prng.uniform(prng.PRNGKey(3), (4096,))
    assert u.dtype.is_floating_point and u.dtype.itemsize == 4
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_layout_context_sets_and_restores():
    key = prng.PRNGKey(3)
    before = prng.PARTITIONABLE
    with prng.layout(not before):
        assert prng.PARTITIONABLE is (not before)
        inside = prng.split(key)
    assert prng.PARTITIONABLE is before
    assert np.array_equal(inside.numpy(),
                          prng.split(key, partitionable=not before).numpy())
    with pytest.raises(RuntimeError):
        with prng.layout(not before):
            raise RuntimeError("restored on the way out")
    assert prng.PARTITIONABLE is before
