"""The port's flash attention on the CPU against the reference's: the plain
version (what ``flash_attention`` runs for CPU tensors) against the Pallas
kernel in interpret mode and against ``layers.flash_attention``, on the
very same NumPy inputs; and the wrapper's device rules."""
import types

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


class _RecordingLib:
    """Stands in for the kernel library: records which entry point each
    call reached and returns ``code``."""

    def __init__(self):
        self.calls, self.code = [], 0

    def flash_attention_sm90_launch(self, *args):
        self.calls.append(("sm90", args))
        return self.code

    def flash_attention_launch(self, *args):
        self.calls.append(("simt", args))
        return self.code


@pytest.fixture
def card(monkeypatch):
    """The wrapper as it runs on CUDA tensors, with the library replaced
    by a recorder and the plain version made to fail if it is called."""
    lib = _RecordingLib()
    monkeypatch.setattr(kfa._build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(kfa, "flash_attention_plain", plain)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    return lib


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "simt")])
def test_each_dtype_reaches_its_own_kernel(card, dtype, entry):
    q = torch.zeros((2, 40, 4, 64), dtype=dtype)
    k = torch.zeros((2, 56, 2, 64), dtype=dtype)
    v = torch.zeros((2, 56, 2, 128), dtype=dtype)
    n, n_tc = kfa.flash_attention.launches, kfa.flash_attention.sm90_launches
    out = kfa.flash_attention(q, k, v, causal=True, q_offset=16)
    assert [c[0] for c in card.calls] == [entry]
    args = card.calls[0][1]
    assert args[4:14] == (2, 40, 56, 4, 2, 64, 128, 1, 16,
                          pytest.approx(1 / 8))
    assert out.shape == (2, 40, 4, 128) and out.dtype == dtype
    assert kfa.flash_attention.launches == n + 1
    assert kfa.flash_attention.sm90_launches == n_tc + (entry == "sm90")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("code,match", [(2, "CUDA error 2"),
                                        (-1, "tensor-map encode")])
def test_a_refused_launch_raises(card, dtype, code, match):
    card.code = code
    q = torch.zeros((1, 16, 2, 32), dtype=dtype)
    n = kfa.flash_attention.launches
    with pytest.raises(RuntimeError, match=match):
        kfa.flash_attention(q, q, q)
    assert kfa.flash_attention.launches == n


def test_more_than_65535_heads_reach_the_bf16_kernel(card):
    q = torch.zeros((1, 1, 70000, 8), dtype=torch.bfloat16)
    kv = torch.zeros((1, 1, 1, 8), dtype=torch.bfloat16)
    kfa.flash_attention(q, kv, kv)
    assert [c[0] for c in card.calls] == ["sm90"]
    assert card.calls[0][1][4:9] == (1, 1, 1, 70000, 1)


def test_the_float32_kernel_takes_at_most_65535_heads(card):
    q = torch.zeros((1, 1, 70000, 8))
    kv = torch.zeros((1, 1, 1, 8))
    with pytest.raises(ValueError, match="65535"):
        kfa.flash_attention(q, kv, kv)
    assert card.calls == []


def test_bf16_kernel_takes_a_positive_scale(card):
    q = torch.zeros((1, 16, 2, 32))
    with pytest.raises(ValueError, match="positive scale"):
        kfa.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                            scale=-0.5)
    kfa.flash_attention(q, q, q, scale=-0.5)
    assert [c[0] for c in card.calls] == ["simt"]


# MLA's prefill attention (deepseek-v3): q/k head dim 128 + 64 = 192, v
# head dim 128.
MLA_SHAPES = [(1, 128, 128, 2, 2), (2, 256, 256, 4, 1)]   # (B, Sq, Sk, H, KVH)


def _mla_qkv(B, Sq, Sk, H, KVH, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, 192), (B, Sk, KVH, 192), (B, Sk, KVH, 128)))


@pytest.mark.parametrize("B,Sq,Sk,H,KVH", MLA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_at_192_128_equals_pallas_interpret(B, Sq, Sk, H, KVH, causal):
    q, k, v = _mla_qkv(B, Sq, Sk, H, KVH, seed=Sq + H)
    ref = flash_attention_pallas(_j(q), _j(k), _j(v), causal=causal,
                                 interpret=True)
    got = kfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (B, Sq, H, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("q_offset,Sq,Sk", [(0, 200, 200), (72, 128, 200),
                                            (0, 96, 300)])
def test_plain_at_192_128_equals_jnp_flash(q_offset, Sq, Sk):
    """Ragged chunks, a query block at q_offset > 0 and MLA's explicit
    scale 1/sqrt(192), against layers.flash_attention and the naive
    oracle."""
    q, k, v = _mla_qkv(2, Sq, Sk, 4, 2, seed=Sq + q_offset)
    kw = dict(causal=True, q_offset=q_offset, q_chunk=64, kv_chunk=128,
              scale=1 / np.sqrt(192))
    ref = RL.flash_attention(_j(q), _j(k), _j(v), **kw)
    got = kfa.flash_attention_plain(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    oracle = tref.attention_ref(_t(q), _t(k), _t(v), causal=True,
                                q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "simt")])
def test_wrapper_takes_mla_widths(card, dtype, entry):
    q = torch.zeros((2, 64, 4, 192), dtype=dtype)
    k = torch.zeros((2, 64, 4, 192), dtype=dtype)
    v = torch.zeros((2, 64, 4, 128), dtype=dtype)
    inst = dict(kfa.flash_attention.sm90_instances)
    out = kfa.flash_attention(q, k, v, scale=1 / np.sqrt(192))
    assert [c[0] for c in card.calls] == [entry]
    assert card.calls[0][1][9:11] == (192, 128)
    assert out.shape == (2, 64, 4, 128)
    # Launches counted per bf16 instance.
    want = dict(inst)
    if entry == "sm90":
        want[(192, 128)] += 1
    assert kfa.flash_attention.sm90_instances == want


@pytest.mark.parametrize("D,Dv", [(200, 128), (192, 136), (192, 192),
                                  (136, 256), (196, 128)])
def test_wrapper_refuses_widths_past_the_instances(card, D, Dv):
    q = torch.zeros((1, 16, 2, D), dtype=torch.bfloat16)
    v = torch.zeros((1, 16, 2, Dv), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D up to 192, Dv up to 128"):
        kfa.flash_attention(q, q, v)
    assert card.calls == []


@pytest.mark.parametrize("D,Dv,inst", [(8, 8, (64, 64)), (64, 64, (64, 64)),
                                       (64, 128, (128, 128)),
                                       (72, 64, (128, 128)),
                                       (128, 128, (128, 128)),
                                       (136, 8, (192, 128)),
                                       (192, 128, (192, 128))])
def test_sm90_instance_is_the_smallest_that_holds_both(D, Dv, inst):
    assert kfa.sm90_instance(D, Dv) == inst
