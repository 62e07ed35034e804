"""The port's MoE and MLA layers on the CPU against the reference's: the
same weights (the reference's initialisers carried over with
``params_from_numpy``) and the same NumPy inputs through ``moe_block``,
its routing, ``mla_compress``, ``mla_queries``, ``mla_block`` and the
absorbed MLA decode of both packages, at the smoke configs of
deepseek-moe-16b and deepseek-v3, in float32 and in bfloat16.

Tolerances, as max|Δ| / max|reference|: float32 1e-5 (the two packages
sum the same products in another order), bfloat16 2e-2 (each package
rounds its bf16 products and the combine's bf16 sum at its own places;
``tests/test_models.py`` holds the reference's bf16 logits to the same
bar).  In float32 the routing is held exactly: every token's top-k
experts and every expert's dispatched tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.models import decode as RD
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import decode as TD
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


def _cfgs(arch, **kw):
    return (dataclasses.replace(RR.get_smoke_config(arch), **kw),
            dataclasses.replace(TR.get_smoke_config(arch), **kw))


def _x(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(
        TDT[dtype])


def _ref_route(p, xr, cfg):
    """The reference's routing, the lines of ``layers.moe_block`` that
    pick the experts (``src/repro/models/layers.py:363-372``)."""
    R, Sr, _ = xr.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    logits = jnp.einsum("rsd,de->rse", xr.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    topk_val, topk_idx = jax.lax.top_k(probs, K)
    gate = jnp.zeros((R, Sr, E), jnp.float32)
    gate = gate.at[jnp.arange(R)[:, None, None],
                   jnp.arange(Sr)[None, :, None], topk_idx].set(topk_val)
    C = min(Sr, max(1, int(Sr * K * cfg.capacity_factor / E)))
    gval, gidx = jax.lax.top_k(gate.transpose(0, 2, 1), C)
    return topk_idx, gval, gidx


@pytest.fixture(scope="module")
def ref_fns():
    """The reference's functions, compiled once for the module (each
    config is a static argument)."""
    return {
        "moe": jax.jit(RL.moe_block, static_argnums=2),
        "route": jax.jit(_ref_route, static_argnums=2),
        "mla": jax.jit(RL.mla_block, static_argnums=2),
        "compress": jax.jit(RL.mla_compress, static_argnums=2),
        "queries": jax.jit(RL.mla_queries, static_argnums=2),
        "cached": jax.jit(RD._mla_cached_attn, static_argnums=5),
    }


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in TDT],
                ids=lambda p: f"{p[0]}-{p[1]}")
def moe_pair(request):
    """(dtype, reference cfg, port cfg, reference params, port params) of
    one MoE layer."""
    arch, dtype = request.param
    rcfg, tcfg = _cfgs(arch, dtype=dtype)
    rp = RL.init_moe(jax.random.PRNGKey(0), rcfg, JDT[dtype])
    return dtype, rcfg, tcfg, rp, convert.params_from_numpy(_np(rp), "cpu")


@pytest.mark.parametrize("shape", [(B, S), (8, 1)], ids=["prefill",
                                                          "decode"])
def test_moe_block_equals_reference(ref_fns, moe_pair, shape):
    """Prefill rows, and the S = 1 decode batch that is one dispatch row
    (C = 1 at 8 tokens: tokens are dropped)."""
    dtype, rcfg, tcfg, rp, tp = moe_pair
    jx, tx = _x(shape + (rcfg.d_model,), seed=shape[0], dtype=dtype)
    rout, raux = ref_fns["moe"](rp, jx, rcfg)
    tout, taux = TL.moe_block(tp, tx, tcfg)
    assert tout.shape == tx.shape and tout.dtype == tx.dtype
    assert _rel(tout.float(), rout) <= TOL[dtype]
    assert abs(float(taux) - float(raux)) <= TOL[dtype] * abs(float(raux))
    if dtype == "float32":
        xr = jx.reshape(1, shape[0], -1) if shape[1] == 1 else jx
        ti, gval, gidx = _np(ref_fns["route"](rp, xr, rcfg))
        _, t_ti, _, t_gval, t_gidx = TL.moe_route(
            tp, tx.reshape(xr.shape), tcfg)
        np.testing.assert_array_equal(t_ti.numpy(), ti)
        live = gval > 0
        np.testing.assert_array_equal(t_gval.numpy() > 0, live)
        np.testing.assert_array_equal(t_gidx.numpy()[live], gidx[live])


def test_top_k_keeps_lax_order_among_ties():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 3, (5, 7, 40)).astype(np.float32)   # many ties
    a[0, 0] = 0.0
    for k in (1, 3, 40):
        rv, ri = jax.lax.top_k(jnp.asarray(a), k)
        tv, ti = TL.top_k(torch.from_numpy(a), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_router_ties_follow_lax_order(ref_fns):
    """Three experts with identical router columns and the largest logits
    for every token: lax takes the lower indices first, among the top-k
    (which two of the three) and in each expert's token order."""
    rcfg, tcfg = _cfgs("deepseek-moe-16b")
    rp = jax.tree.map(np.array, RL.init_moe(jax.random.PRNGKey(1), rcfg,
                                            jnp.float32))
    rp["router"][:, 1] = rp["router"][:, 0]
    rp["router"][:, 2] = rp["router"][:, 0]
    rp["router"][0, :3] = 3.0
    tp = convert.params_from_numpy(rp, "cpu")
    x = np.random.default_rng(2).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    x[..., 0] = 5.0
    ti, gval, gidx = _np(ref_fns["route"](rp, jnp.asarray(x), rcfg))
    _, t_ti, _, t_gval, t_gidx = TL.moe_route(tp, torch.from_numpy(x), tcfg)
    assert (ti == np.array([0, 1])).all()          # the tie, resolved
    np.testing.assert_array_equal(t_ti.numpy(), ti)
    np.testing.assert_array_equal(t_gidx.numpy(), gidx)
    np.testing.assert_array_equal(t_gval.numpy(), gval)
    rout, _ = ref_fns["moe"](rp, jnp.asarray(x), rcfg)
    tout, _ = TL.moe_block(tp, torch.from_numpy(x), tcfg)
    assert _rel(tout, rout) <= TOL["float32"]


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_capacity_binds_and_drops_tokens(ref_fns, cf):
    """At the smoke config's capacity (C = 5 of 16 tokens at 1.25) and
    below it, some (token, expert) choices find the expert full: the
    port drops the same ones as the reference."""
    rcfg, tcfg = _cfgs("deepseek-moe-16b", capacity_factor=cf)
    rp = RL.init_moe(jax.random.PRNGKey(3), rcfg, jnp.float32)
    tp = convert.params_from_numpy(_np(rp), "cpu")
    jx, tx = _x((B, S, rcfg.d_model), seed=4, dtype="float32")
    _, t_ti, _, t_gval, t_gidx = TL.moe_route(tp, tx, tcfg)
    chosen = {(r, int(s), int(t_ti[r, s, k])) for r in range(B)
              for s in range(S) for k in range(tcfg.moe_top_k)}
    served = {(r, int(t_gidx[r, e, c]), e) for r in range(B)
              for e in range(tcfg.num_experts)
              for c in range(t_gidx.shape[-1]) if t_gval[r, e, c] > 0}
    assert served < chosen                      # strictly: tokens dropped
    ti, gval, gidx = _np(ref_fns["route"](rp, jx, rcfg))
    np.testing.assert_array_equal(t_gidx.numpy()[gval > 0], gidx[gval > 0])
    rout, raux = ref_fns["moe"](rp, jx, rcfg)
    tout, taux = TL.moe_block(tp, tx, tcfg)
    assert _rel(tout, rout) <= TOL["float32"]
    assert float(taux) == pytest.approx(float(raux), rel=TOL["float32"])


def test_no_drop_capacity_takes_every_token():
    """capacity_factor = E / K gives C = Sr at the full configs' shapes,
    so a decode step there equals the full forward (chip_smoke.py's
    check)."""
    for arch in ARCHS:
        cfg = TR.get_config(arch)
        nd = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.moe_top_k)
        for rows in (1, 4, 16, 512, 2048, 2049):
            assert TL.moe_capacity(nd, rows) == rows
    # deepseek-moe-16b's serve batch of 16 as one decode row: C = 1.
    assert TL.moe_capacity(TR.get_config("deepseek-moe-16b"), 16) == 1


@pytest.fixture(scope="module", params=list(TDT))
def mla_pair(request):
    dtype = request.param
    rcfg, tcfg = _cfgs("deepseek-v3-671b", dtype=dtype)
    rp = RL.init_mla(jax.random.PRNGKey(5), rcfg, JDT[dtype])
    return dtype, rcfg, tcfg, rp, convert.params_from_numpy(_np(rp), "cpu")


def test_mla_compress_and_queries_equal_reference(ref_fns, mla_pair):
    dtype, rcfg, tcfg, rp, tp = mla_pair
    jx, tx = _x((B, S, rcfg.d_model), seed=6, dtype=dtype)
    jpos, tpos = jnp.arange(S), torch.arange(S)
    for name, fn in (("compress", TL.mla_compress),
                     ("queries", TL.mla_queries)):
        want = ref_fns[name](rp, jx, rcfg, jpos)
        got = fn(tp, tx, tcfg, tpos)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and g.dtype == tx.dtype
            assert _rel(g.float(), w) <= TOL[dtype], name


def test_mla_block_equals_reference(ref_fns, mla_pair):
    """The prefill attention: q/k at qk_head_dim (24 here; 192 at full
    width) with v at v_head_dim through the flash path, scale
    1/sqrt(qk_head_dim)."""
    dtype, rcfg, tcfg, rp, tp = mla_pair
    jx, tx = _x((B, S, rcfg.d_model), seed=7, dtype=dtype)
    want = ref_fns["mla"](rp, jx, rcfg)
    got = TL.mla_block(tp, tx, tcfg)
    assert got.shape == tx.shape
    assert _rel(got.float(), want) <= TOL[dtype]
    # Precomputed (c_kv, k_rope), as prefill passes them, change nothing.
    comp = TL.mla_compress(tp, tx, tcfg, torch.arange(S))
    assert torch.equal(TL.mla_block(tp, tx, tcfg, compressed=comp), got)


@pytest.mark.parametrize("pos", [0, 9, 19, 20])
def test_mla_cached_attn_equals_reference(ref_fns, mla_pair, pos):
    """The absorbed decode over a random cache, written in place at pos
    (clamped to the last slot at pos = Smax, as dynamic_update_slice
    clamps it)."""
    dtype, rcfg, tcfg, rp, tp = mla_pair
    ml = 20
    rng = np.random.default_rng(pos)
    ckv = rng.standard_normal((B, ml, rcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, ml, rcfg.rope_head_dim)).astype(np.float32)
    jx, tx = _x((B, rcfg.d_model), seed=8 + pos, dtype=dtype)
    jc = [jnp.asarray(a).astype(JDT[dtype]) for a in (ckv, kr)]
    # Copies: the port writes its cache in place, and jnp.asarray may
    # share the NumPy buffers.
    tc = [torch.tensor(a).to(TDT[dtype]) for a in (ckv, kr)]
    want, wckv, wkr = ref_fns["cached"](rp, jx, *jc, jnp.int32(pos), rcfg)
    got, gckv, gkr = TD._mla_cached_attn(tp, tx, *tc,
                                         torch.tensor(pos, dtype=torch.int32),
                                         tcfg)
    assert gckv is tc[0] and gkr is tc[1]          # written in place
    assert _rel(got.float(), want) <= TOL[dtype]
    for g, w in ((gckv, wckv), (gkr, wkr)):
        assert _rel(g.float(), w) <= TOL[dtype]
    slot = min(pos, ml - 1)
    changed = np.nonzero((gckv.float().numpy() !=
                          np.asarray(jc[0], np.float32)).any(axis=(0, 2)))[0]
    assert changed.tolist() == [slot]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layouts_and_distributions(arch):
    """The port's random weights have the reference's tree, shapes and
    types (the router float32 in a bf16 model), the reference's scales
    (N(0, 1/d_in); experts' wo N(0, 1/d_ff)) and ones for the norms."""
    rcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    ref = dict(_leaves(RT.init_params(rcfg, jax.random.PRNGKey(0))))
    got = dict(_leaves(TT.init_params(tcfg, seed=0, device="cpu")))
    assert ref.keys() == got.keys()
    for k, r in ref.items():
        assert tuple(got[k].shape) == r.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(r.dtype), k
    assert got[".layers.moe.router"].dtype == torch.float32
    d, ff = tcfg.d_model, tcfg.d_ff
    scales = {".layers.moe.wi": d, ".layers.moe.wg": d, ".layers.moe.wo": ff,
              ".layers.moe.router": d, ".layers.moe.shared.wo":
              ff * tcfg.num_shared_experts}
    if tcfg.use_mla:
        scales.update({".layers.attn.wq_b": tcfg.q_lora_rank,
                       ".layers.attn.wkv_a": d,
                       ".layers.attn.wv_b": tcfg.kv_lora_rank})
        for norm in (".layers.attn.norm_kv", ".layers.attn.norm_q"):
            assert bool((got[norm] == 1).all())
    for k, fan_in in scales.items():
        w = got[k].float()
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05, k
        assert abs(float(w.mean())) < 0.05 / np.sqrt(fan_in), k


def test_init_params_draws_the_same_weights_from_a_seed():
    cfg = TR.get_smoke_config("deepseek-v3-671b")
    a = dict(_leaves(TT.init_params(cfg, seed=4, device="cpu")))
    b = dict(_leaves(TT.init_params(cfg, seed=4, device="cpu")))
    c = dict(_leaves(TT.init_params(cfg, seed=5, device="cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[".layers.moe.wi"], c[".layers.moe.wi"])
    # Every expert, layer and matrix gets its own draw.
    wi = a[".layers.moe.wi"]
    assert not torch.equal(wi[0, 0], wi[0, 1])
    assert not torch.equal(wi[0, 0], wi[1, 0])


def test_params_from_numpy_keeps_the_router_float32():
    rcfg, _ = _cfgs("deepseek-moe-16b")
    rp = _np(RT.init_params(rcfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(rp, "cpu", torch.bfloat16)
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(tp["layers"]["moe"]["router"].numpy(),
                                  rp["layers"]["moe"]["router"])
    assert tp["layers"]["moe"]["wi"].dtype == torch.bfloat16
    assert tp["layers"]["moe"]["shared"]["wi"].dtype == torch.bfloat16
    assert tp["embed"].dtype == torch.bfloat16


def test_mla_cache_layout_equals_reference():
    rcfg, tcfg = _cfgs("deepseek-v3-671b")
    ref = _np(RD.init_cache(rcfg, 3, 12))
    got = convert.to_numpy(TD.init_cache(tcfg, 3, 12, device="cpu"))
    assert ref.keys() == got.keys() == {"pos", "ckv", "krope"}
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_moe_smoke_configs_on_the_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--device", "cpu", "--requests",
                        "12", "--max-len", "24"]) == 0
    out = capsys.readouterr().out
    assert "measured decode_step cost" in out and "policy=pspice" in out
