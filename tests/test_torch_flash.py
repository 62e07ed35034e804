"""The port's flash attention on the CPU against the reference's: the plain
version (what ``flash_attention`` runs for CPU tensors) against the Pallas
kernel in interpret mode and against ``layers.flash_attention``, on the
very same NumPy inputs; and the wrapper's device rules."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as RL
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL

# The shapes of tests/test_kernels.py's flash sweep: (B, Sq, Sk, H, KVH, D).
SHAPES = [(1, 128, 128, 2, 2, 32), (2, 256, 256, 4, 2, 64),
          (1, 256, 256, 8, 1, 64), (2, 128, 256, 4, 4, 128)]
TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(B, Sq, Sk, H, KVH, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
    return q, k, v


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


# The Pallas kernel's causal mask assumes Sq == Sk.
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,causal", [
    s + (c,) for s in SHAPES for c in (True, False) if not c or s[1] == s[2]])
def test_plain_equals_pallas_interpret(B, Sq, Sk, H, KVH, D, causal):
    q, k, v = _qkv(B, Sq, Sk, H, KVH, D, seed=B * Sq + H)
    ref = flash_attention_pallas(_j(q), _j(k), _j(v), causal=causal,
                                 interpret=True)
    got = kfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D", SHAPES + [
    (1, 2047, 2047, 2, 1, 8),     # ragged S: q chunks of 23, kv of 89
    (2, 48, 48, 4, 2, 16),        # one short chunk
])
@pytest.mark.parametrize("causal_skip", [True, False])
def test_plain_equals_jnp_flash(B, Sq, Sk, H, KVH, D, causal_skip):
    causal = Sq == Sk
    q, k, v = _qkv(B, Sq, Sk, H, KVH, D, seed=Sq + D)
    kw = dict(causal=causal, causal_skip=causal_skip, q_chunk=64,
              kv_chunk=128)
    ref = RL.flash_attention(_j(q), _j(k), _j(v), **kw)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    oracle = tref.attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)


def test_default_chunks_and_q_offset():
    """The settings' default chunks (512 / 1024) and a query block placed
    at q_offset = 128 of a longer cache."""
    q, k, v = _qkv(2, 64, 192, 4, 2, 32, seed=3)
    ref = RL.flash_attention(_j(q), _j(k), _j(v), causal=True, q_offset=128,
                             q_chunk=32, kv_chunk=64)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    q_offset=128, q_chunk=32, kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    oracle = RL.attention_ref(_j(q), _j(k), _j(v), causal=True, q_offset=128)
    np.testing.assert_allclose(
        tref.attention_ref(_t(q), _t(k), _t(v), causal=True,
                           q_offset=128).numpy(), np.asarray(oracle), **TOL)
    q, k, v = _qkv(1, 1536, 1536, 2, 1, 16, seed=5)
    ref = RL.flash_attention(_j(q), _j(k), _j(v))
    got = TL.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_scale_argument():
    q, k, v = _qkv(1, 96, 96, 2, 2, 24, seed=9)
    ref = RL.flash_attention(_j(q), _j(k), _j(v), scale=0.1, q_chunk=32,
                             kv_chunk=32)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), scale=0.1,
                                    q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bf16_plain_equals_jnp_flash_and_pallas():
    """bf16 inputs: the plain version rounds p to bf16 before PV, as the
    jnp flash does (bitwise-level agreement is not asked); the Pallas
    kernel keeps p in float32, within the bf16 bound of test_kernels."""
    q, k, v = _qkv(1, 128, 128, 2, 2, 32, seed=0)
    bt = lambda a: _t(a, torch.bfloat16)  # noqa: E731
    bj = lambda a: _j(a, jnp.bfloat16)    # noqa: E731
    got = kfa.flash_attention(bt(q), bt(k), bt(v))
    assert got.dtype == torch.bfloat16
    ref = RL.flash_attention(bj(q), bj(k), bj(v))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=1e-2,
                               rtol=1e-2)
    pal = flash_attention_pallas(bj(q), bj(k), bj(v), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pal, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_fully_masked_rows_stay_finite():
    """A causal block at q_offset 0 whose chunk boundaries leave rows with
    no visible key in a visited kv chunk: the guard keeps them finite."""
    q, k, v = _qkv(1, 96, 96, 2, 1, 8, seed=4)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    causal_skip=False, q_chunk=32,
                                    kv_chunk=48)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(), tref.attention_ref(_t(q), _t(k), _t(v)).numpy(), **TOL)


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    q = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kfa.flash_attention(q, q, q)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: a bad
    shape raises before any build, and the plain version is not called."""
    called = []
    monkeypatch.setattr(kfa, "flash_attention_plain",
                        lambda *a, **k: called.append(1))

    q = torch.zeros((1, 8, 2, 12))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="multiple of 8"):
        kfa.flash_attention(q, q, q)
    assert called == []
