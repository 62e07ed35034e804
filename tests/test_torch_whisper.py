"""The port's encoder-decoder (whisper) on the CPU against the reference's,
at whisper's smoke config in float32 and bfloat16: the same weights (the
reference's ``init_params`` through ``params_from_numpy``), frames and
tokens through the sinusoid, the encoder, cross-attention, ``prefill``
(logits and every cache leaf) and ``decode_step``; decode against the
full forward; ``serve --arch whisper-small``; a frame count the cross
cache cannot hold."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.models import decode as RD
from repro.models import layers as RLY
from repro.models import transformer as RT
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as TS
from repro_torch.models import convert
from repro_torch.models import decode as TD
from repro_torch.models import layers as TLY
from repro_torch.models import transformer as TT

ARCH = "whisper-small"
DTYPES = ["float32", "bfloat16"]
# max|Δ| / max|x| (tests/test_torch_models.py's bars).
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S, MAX_LEN = 2, 12, 20


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


@pytest.fixture(scope="module", params=DTYPES)
def pair(request):
    """(dtype, reference cfg, port cfg, reference params, port params,
    NumPy tokens (B, S + 1), NumPy frames)."""
    dtype = request.param
    rcfg = dataclasses.replace(RR.get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(TR.get_smoke_config(ARCH), dtype=dtype)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rcfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = rng.standard_normal(
        (B, rcfg.enc_frames, rcfg.d_model)).astype(np.float32)
    return dtype, rcfg, tcfg, rparams, tparams, toks, frames


def _batches(dtype, toks, frames):
    rb = {"tokens": jnp.asarray(toks),
          "frames": jnp.asarray(frames).astype(_jdt(dtype))}
    tb = {"tokens": torch.from_numpy(toks),
          "frames": torch.from_numpy(frames).to(_tdt(dtype))}
    return rb, tb


@pytest.mark.parametrize("n,d", [(32, 64), (1500, 768)])
def test_sinusoid_equals_reference(n, d):
    got = TT._sinusoid(torch.arange(n), d)
    want = RT._sinusoid(jnp.arange(n), d)
    assert got.dtype == torch.float32 and got.shape == (1, n, d)
    # Angles up to 1 499 rad: one float32 ulp of the angle is 1.2e-4.
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 3e-4


def test_encoder_equals_reference(pair):
    dtype, rcfg, tcfg, rparams, tparams, toks, frames = pair
    rb, tb = _batches(dtype, toks, frames)
    want = RT.encoder(rcfg, rparams, rb["frames"])
    got = TT.encoder(tcfg, tparams, tb["frames"])
    assert got.dtype == _tdt(dtype) and got.shape == frames.shape
    assert _rel(got.float().numpy(), want) <= CACHE_TOL[dtype] * 10


def test_attention_block_kv_override_equals_reference(pair):
    """Cross-attention: q from x with no RoPE, K and V as given
    (non-contiguous views here, as the einsum gives them), non-causal."""
    dtype, rcfg, tcfg, rparams, tparams, toks, frames = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 5, rcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, rcfg.enc_frames,
                               rcfg.d_model)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[0], rparams["cross_layers"]["attn"])
    tp = {k: v[0] for k, v in tparams["cross_layers"]["attn"].items()}
    je, te = jnp.asarray(enc).astype(_jdt(dtype)), \
        torch.from_numpy(enc).to(_tdt(dtype))
    rkv = (jnp.einsum("bsd,dhk->bshk", je, rp["wk"]),
           jnp.einsum("bsd,dhk->bshk", je, rp["wv"]))
    tkv = TT.cross_kv({"attn": tp}, te)
    want = RLY.attention_block(rp, jnp.asarray(x).astype(_jdt(dtype)), rcfg,
                               causal=False, kv_override=rkv)
    got = TLY.attention_block(tp, torch.from_numpy(x).to(_tdt(dtype)), tcfg,
                              causal=False, kv_override=tkv)
    assert _rel(got.float().numpy(), want) <= LOGIT_TOL[dtype]
    # Without RoPE on q and without a mask, the rows do not depend on
    # their position: permuting x's positions permutes the output.
    perm = torch.from_numpy(x[:, ::-1].copy()).to(_tdt(dtype))
    got_p = TLY.attention_block(tp, perm, tcfg, causal=False,
                                kv_override=tkv)
    assert torch.allclose(got_p.float(), got.flip(1).float(), atol=1e-5,
                          rtol=1e-5)


def test_prefill_logits_and_every_cache_leaf_equal_reference(pair):
    dtype, rcfg, tcfg, rparams, tparams, toks, frames = pair
    rb, tb = _batches(dtype, toks[:, :S], frames)
    rcache, rlog = RD.prefill(rcfg, rparams, rb, MAX_LEN)
    tcache, tlog = TD.prefill(tcfg, tparams, tb, MAX_LEN)
    assert _rel(tlog.float().numpy(), rlog) <= LOGIT_TOL[dtype]
    assert set(tcache) == set(rcache) == {"pos", "k", "v", "ck", "cv"}
    assert int(tcache["pos"]) == int(rcache["pos"]) == S
    tc = convert.to_numpy(tcache)
    for name in ("k", "v", "ck", "cv"):
        assert tc[name].shape == rcache[name].shape, name
        assert tcache[name].dtype == _tdt(dtype), name
        assert _rel(tc[name], rcache[name]) <= CACHE_TOL[dtype], name
    assert tc["ck"].shape == (tcfg.num_layers, B, tcfg.enc_frames,
                              tcfg.num_kv_heads, tcfg.head_dim)
    assert not tc["k"][:, :, S:].any()


def test_decode_step_equals_reference(pair):
    """One decode step from the reference's own prefill cache: logits, the
    self-attention K/V written at pos (in place) and the cross cache left
    as it was."""
    dtype, rcfg, tcfg, rparams, tparams, toks, frames = pair
    rb, _ = _batches(dtype, toks[:, :S], frames)
    rcache, _ = RD.prefill(rcfg, rparams, rb, MAX_LEN)
    tcache = convert.cache_from_numpy(jax.tree.map(np.asarray, rcache),
                                      "cpu")
    cross = {k: tcache[k].clone() for k in ("ck", "cv")}
    rlog, rcache2 = RD.decode_step(rcfg, rparams, rcache,
                                   jnp.asarray(toks[:, S]))
    tlog, tcache2 = TD.decode_step(tcfg, tparams, tcache,
                                   torch.from_numpy(toks[:, S]))
    assert _rel(tlog.float().numpy(), rlog) <= LOGIT_TOL[dtype]
    assert int(tcache2["pos"]) == S + 1
    for name in ("k", "v"):
        assert tcache2[name] is tcache[name]
        assert _rel(convert.to_numpy(tcache2[name]), rcache2[name]) <= \
            CACHE_TOL[dtype]
    for name in ("ck", "cv"):
        assert torch.equal(tcache2[name], cross[name])


def test_decode_equals_full_forward(pair):
    """prefill(S) then decode of token S against the full forward over
    S + 1 tokens (encoder + decoder), in the port alone; and the same
    decode from a cross cache rolled by one utterance must miss."""
    dtype, rcfg, tcfg, rparams, tparams, toks, frames = pair
    _, tb = _batches(dtype, toks, frames)
    cache, _ = TD.prefill(tcfg, tparams, {"tokens": tb["tokens"][:, :S],
                                          "frames": tb["frames"]}, MAX_LEN)
    rolled = dict(cache, ck=cache["ck"].roll(1, dims=1),
                  cv=cache["cv"].roll(1, dims=1),
                  k=cache["k"].clone(), v=cache["v"].clone())
    step, _ = TD.decode_step(tcfg, tparams, cache, tb["tokens"][:, S])
    bad, _ = TD.decode_step(tcfg, tparams, rolled, tb["tokens"][:, S])
    enc = TT.encoder(tcfg, tparams, tb["frames"])
    h, aux = TT.backbone(tcfg, tparams, TT.embed_inputs(
        tcfg, tparams, tb), enc_out=enc)
    assert float(aux) == 0.0
    h = TLY.rmsnorm(h, tparams["final_norm"], tcfg.norm_eps)
    full = TT.lm_head_logits(tcfg, tparams, h[:, -1:])[:, 0]
    tol = LOGIT_TOL[dtype] if dtype == "float32" else 4e-2
    assert _rel(step.float().numpy(), full.float().numpy()) <= tol
    assert _rel(bad.float().numpy(), full.float().numpy()) > tol


def test_params_from_numpy_carries_enc_and_cross_trees():
    """The reference's encoder, cross-layer and final-norm trees arrive
    whole (same paths, shapes, values; bf16 exact), and the port's own
    random weights have the same tree."""
    rcfg = dataclasses.replace(RR.get_smoke_config(ARCH), dtype="bfloat16")
    tcfg = dataclasses.replace(TR.get_smoke_config(ARCH), dtype="bfloat16")
    ref = jax.tree.map(np.asarray, RT.init_params(rcfg,
                                                  jax.random.PRNGKey(0)))
    got = convert.params_from_numpy(ref, "cpu")
    own = TT.init_params(tcfg, seed=0, device="cpu")
    assert {"enc_layers", "enc_final_norm", "cross_layers"} <= set(got)

    def walk(r, t, o, path=""):
        if isinstance(r, dict):
            assert set(r) == set(t) == set(o), path
            for k in r:
                walk(r[k], t[k], o[k], f"{path}/{k}")
            return
        assert t.dtype == o.dtype == torch.bfloat16, path
        assert tuple(t.shape) == tuple(o.shape) == r.shape, path
        assert np.array_equal(t.float().numpy(), r.astype(np.float32)), path
    walk(ref, got, own)


def test_init_params_and_cache_of_whisper():
    cfg = TR.get_smoke_config(ARCH)
    params = TT.init_params(cfg, device="cpu")
    assert params["enc_layers"]["attn"]["wq"].shape == (
        cfg.enc_layers, cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert params["cross_layers"]["norm"].shape == (cfg.num_layers,
                                                    cfg.d_model)
    cache = TD.init_cache(cfg, 3, 8, device="cpu")
    assert cache["ck"].shape == (cfg.num_layers, 3, cfg.enc_frames,
                                 cfg.num_kv_heads, cfg.head_dim)
    assert not cache["cv"].any()


def test_frames_mismatch_raises():
    cfg = TR.get_smoke_config(ARCH)
    params = TT.init_params(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "frames": torch.zeros((1, cfg.enc_frames + 1, cfg.d_model))}
    with pytest.raises(ValueError, match="enc_frames"):
        TD.prefill(cfg, params, batch, 8)
    with pytest.raises(ValueError, match="enc_out"):
        TT.backbone(cfg, params, torch.zeros((1, 4, cfg.d_model)))


def test_serve_whisper(capsys):
    """``serve --arch whisper-small``: decode over the initial cache (the
    cross cache zero, as the reference's CLI runs it)."""
    assert TS.main(["--arch", ARCH, "--device", "cpu", "--requests", "12",
                    "--slots", "4", "--max-len", "24"]) == 0
    out = capsys.readouterr().out
    assert "measured decode_step cost" in out and "goodput=" in out
    cfg = TR.get_smoke_config(ARCH)
    res = TS.serve(cfg, TT.init_params(cfg, device="cpu"), requests=8,
                   slots=4, max_len=16, device="cpu", step_cost=0.01,
                   log=lambda s: None)
    assert res["finished"] == 8 and res["decode_steps"] > 0
