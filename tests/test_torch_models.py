"""The port's serving path on the CPU against the reference's: the same
weights (the reference's ``init_params`` carried over with
``params_from_numpy``) and the same NumPy tokens through ``prefill`` and
``decode_step`` of both packages, in float32 and in bfloat16, for the
dense and the MoE families (MoE layers' own parity:
``tests/test_torch_moe.py``)."""
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
from repro_torch.models import convert
from repro_torch.models import decode as TD
from repro_torch.models import layers as TLY
from repro_torch.models import transformer as TT

# internlm2 (GQA), starcoder2 (head_dim 8), qwen1.5 (QKV bias), the
# internvl2 LM backbone (patch embeddings prepended), deepseek-moe-16b
# (MoE) and deepseek-v3 (MoE + MLA: its cache is (ckv, krope)).
ARCHS = ["internlm2-1.8b", "starcoder2-15b", "qwen1.5-110b", "internvl2-76b",
         "deepseek-moe-16b", "deepseek-v3-671b"]
DTYPES = ["float32", "bfloat16"]
# max|Δ| / max|logits| (tests/test_models.py:106 for bf16).
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 16


def _cfgs(arch, dtype):
    ref = dataclasses.replace(RR.get_smoke_config(arch), dtype=dtype)
    port = dataclasses.replace(TR.get_smoke_config(arch), dtype=dtype)
    return ref, port


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _cache_names(cfg):
    return ("ckv", "krope") if cfg.use_mla else ("k", "v")


def _no_drop(cfg):
    """The MoE config at capacity_factor = E / K: every expert takes every
    token of a row (C = Sr), so no token is dropped."""
    if not cfg.moe:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.moe_top_k)


def _inputs(cfg, seed=1, n=S + 1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    patches = None
    if cfg.vlm_patches:
        patches = (rng.standard_normal((B, cfg.vlm_patches, cfg.d_model))
                   * 0.1).astype(np.float32)
    return toks, patches


def _batch(toks, patches, jx):
    if jx:
        b = {"tokens": jnp.asarray(toks)}
        if patches is not None:
            b["patches"] = jnp.asarray(patches)
    else:
        b = {"tokens": torch.from_numpy(toks)}
        if patches is not None:
            b["patches"] = torch.from_numpy(patches)
    return b


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(arch, dtype, reference cfg, port cfg, reference params, port
    params) — one init per arch and dtype for the whole module."""
    arch, dtype = request.param
    rcfg, tcfg = _cfgs(arch, dtype)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(rparams), "cpu")
    return arch, dtype, rcfg, tcfg, rparams, tparams


def test_prefill_and_decode_equal_reference(pair):
    arch, dtype, rcfg, tcfg, rparams, tparams = pair
    toks, patches = _inputs(rcfg)
    ml = S + 4 + (rcfg.vlm_patches or 0)
    rcache, rlog = RD.prefill(rcfg, rparams, _batch(toks[:, :S], patches,
                                                    True), max_len=ml,
                              remat=False)
    tcache, tlog = TD.prefill(tcfg, tparams, _batch(toks[:, :S], patches,
                                                    False), max_len=ml)
    assert tlog.shape == (B, tcfg.vocab_size) and tlog.dtype == tparams[
        "embed"].dtype
    assert _rel(tlog.float(), rlog) <= LOGIT_TOL[dtype]
    rc, tc = _np(rcache), convert.to_numpy(tcache)
    assert int(tc["pos"]) == int(rc["pos"]) == S + (rcfg.vlm_patches or 0)
    assert tc.keys() == rc.keys()
    for name in _cache_names(tcfg):
        assert tc[name].shape == rc[name].shape
        assert _rel(tc[name], rc[name]) <= CACHE_TOL[dtype], name

    # Both decode one token from the reference's own cache.
    rlog2, rcache2 = RD.decode_step(rcfg, rparams, rcache,
                                    jnp.asarray(toks[:, S]))
    tcache_in = convert.cache_from_numpy(rc, "cpu",
                                         tparams["embed"].dtype)
    tlog2, tcache2 = TD.decode_step(tcfg, tparams, tcache_in,
                                    torch.from_numpy(toks[:, S]))
    assert _rel(tlog2.float(), rlog2) <= LOGIT_TOL[dtype]
    rc2, tc2 = _np(rcache2), convert.to_numpy(tcache2)
    assert int(tc2["pos"]) == int(rc2["pos"])
    for name in _cache_names(tcfg):
        assert _rel(tc2[name], rc2[name]) <= CACHE_TOL[dtype], name


def test_prefill_then_decode_equals_full_forward(pair):
    """Prefill over S tokens + one decode step == the full forward over
    S + 1 tokens at the last position (tests/test_models.py:74).  An MoE
    config runs on its no-drop copy, as the reference's test raises its
    capacity: at the reference's capacity a decode step, whose batch is
    one dispatch row, drops other tokens than the full forward's rows do,
    so the two differ by design."""
    arch, dtype, rcfg, tcfg, rparams, tparams = pair
    rcfg, tcfg = _no_drop(rcfg), _no_drop(tcfg)
    toks, patches = _inputs(tcfg, seed=2)
    full = _batch(toks, patches, False)
    x = TT.embed_inputs(tcfg, tparams, full)
    h, aux = TT.backbone(tcfg, tparams, x)
    # The load-balance loss, summed over the layers (0 without MoE).
    assert (float(aux) > 0.0) == tcfg.moe
    h = TLY.rmsnorm(h, tparams["final_norm"], tcfg.norm_eps)
    want = TT.lm_head_logits(tcfg, tparams, h[:, -1:, :])[:, 0]
    ml = S + 4 + (tcfg.vlm_patches or 0)
    cache, _ = TD.prefill(tcfg, tparams, _batch(toks[:, :S], patches, False),
                          max_len=ml)
    got, _ = TD.decode_step(tcfg, tparams, cache, torch.from_numpy(toks[:, S]))
    assert _rel(got.float(), want.float()) < 2e-2
    # The port's full forward equals the reference's.
    rx = RT.embed_inputs(rcfg, rparams, _batch(toks, patches, True))
    rh, _ = RT.backbone(rcfg, rparams, rx, remat=False)
    rh = RLY.rmsnorm(rh, rparams["final_norm"], rcfg.norm_eps)
    rwant = RT.lm_head_logits(rcfg, rparams, rh[:, -1:, :])[:, 0]
    assert _rel(want.float(), rwant) <= LOGIT_TOL[dtype]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen1.5-110b"])
@pytest.mark.parametrize("pos", [0, 7, 11, 12])
def test_cache_write_clamps_like_dynamic_update_slice(arch, pos):
    """A decode step at pos = max_len (12) writes slot max_len - 1, as
    jax.lax.dynamic_update_slice clamps its start; every position up to
    pos stays visible."""
    rcfg, tcfg = _cfgs(arch, "float32")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(3))
    tparams = convert.params_from_numpy(_np(rparams), "cpu")
    ml = 12
    rng = np.random.default_rng(pos)
    shape = (rcfg.num_layers, B, ml, rcfg.num_kv_heads, rcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tok = rng.integers(0, rcfg.vocab_size, B).astype(np.int32)
    rcache = {"pos": jnp.int32(pos), "k": jnp.asarray(k),
              "v": jnp.asarray(v)}
    rlog, rcache2 = RD.decode_step(rcfg, rparams, rcache, jnp.asarray(tok))
    tcache = convert.cache_from_numpy(
        {"pos": np.int32(pos), "k": k, "v": v}, "cpu")
    tlog, tcache2 = TD.decode_step(tcfg, tparams, tcache,
                                   torch.from_numpy(tok))
    assert _rel(tlog, rlog) <= LOGIT_TOL["float32"]
    rc2, tc2 = _np(rcache2), convert.to_numpy(tcache2)
    slot = min(pos, ml - 1)
    for name, orig in (("k", k), ("v", v)):
        assert _rel(tc2[name], rc2[name]) <= CACHE_TOL["float32"]
        changed = np.nonzero((tc2[name] != orig).any(axis=(0, 1, 3, 4)))[0]
        assert changed.tolist() == [slot]
    assert int(tc2["pos"]) == pos + 1


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TR.get_smoke_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.init_cache(cfg, 1, 8)
    params = TT.init_params(cfg, seed=0, device="cpu")
    assert params["embed"].device.type == "cpu"


def test_registry_copies_the_reference():
    assert TR.ARCH_IDS == RR.ARCH_IDS
    for arch in RR.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            r, t = getattr(RR, get)(arch), getattr(TR, get)(arch)
            assert dataclasses.asdict(r) == dataclasses.asdict(t)
            assert r.param_count() == t.param_count()


def test_init_params_layouts_and_distribution():
    """The port's random weights have the reference's tree, shapes and
    types, and the reference's scale (N(0, 1/d_in))."""
    rcfg, tcfg = _cfgs("qwen1.5-110b", "bfloat16")
    ref = _np(RT.init_params(rcfg, jax.random.PRNGKey(0)))
    got = convert.to_numpy(TT.init_params(tcfg, seed=0, device="cpu"))
    flat_r = dict(_leaves(ref))
    flat_t = dict(_leaves(got))
    assert flat_r.keys() == flat_t.keys()
    for k in flat_r:
        assert flat_r[k].shape == flat_t[k].shape, k
    wq = flat_t[".layers.attn.wq"]
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.05


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, np.asarray(tree)


def test_settings_scan_is_a_loop():
    from repro_torch.models import settings as SET
    xs = {"a": torch.arange(6).reshape(3, 2), "b": (torch.ones(3),)}
    seen = []

    def body(c, x):
        seen.append(float(x["b"][0]))
        return c + x["a"].sum(), None

    assert int(SET.scan(body, torch.tensor(0), xs)) == 15
    assert seen == [1.0, 1.0, 1.0]
    assert SET.flash_chunks() == (512, 1024) and SET.loss_chunk() == 512


def test_bf16_noise_bound_separates_faults(monkeypatch):
    """The bf16 logit bound chip_smoke.py holds at full width (5e-2 of
    max|logits| against a float32 copy of the weights) sits above the
    model's own bf16 noise and below what a wrong attention mask or a
    decode write one slot off produce."""
    from repro_torch.kernels import flash_attention as kfa
    bound = 5e-2
    cfg = dataclasses.replace(TR.get_smoke_config("internlm2-1.8b"),
                              dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = TT.init_params(cfg, seed=0, device="cpu")
    p32 = {k: v.float() if torch.is_tensor(v) else
           {kk: vv.float() if torch.is_tensor(vv) else
            {a: b.float() for a, b in vv.items()} for kk, vv in v.items()}
           for k, v in params.items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 256)).astype(np.int32))
    cache32, ref = TD.prefill(cfg32, p32, {"tokens": toks}, 300)
    tok = ref.argmax(-1).to(torch.int32)
    ref_step, _ = TD.decode_step(cfg32, p32, cache32, tok)

    def rel(a, b):
        return _rel(a.float().numpy(), b.float().numpy())

    cache, good = TD.prefill(cfg, params, {"tokens": toks}, 300)
    good_step, _ = TD.decode_step(cfg, params, dict(cache), tok)
    assert rel(good, ref) < bound and rel(good_step, ref_step) < bound
    shifted = dict(cache, pos=cache["pos"] + 1)      # K/V one slot off
    bad_step, _ = TD.decode_step(cfg, params, shifted, tok)
    assert rel(bad_step, ref_step) > bound
    monkeypatch.setattr(TLY, "flash_attention",        # no causal mask
                        lambda q, k, v, causal=True, **kw:
                        kfa.flash_attention_plain(q, k, v, causal=False,
                                                  **kw))
    _, bad = TD.prefill(cfg, params, {"tokens": toks}, 300)
    assert rel(bad, ref) > bound
