"""The port's SSM and hybrid layers on the CPU against the reference's:
the same weights (the reference's initialisers carried over with
``params_from_numpy``) and the same NumPy inputs through the Mamba2
pieces (``_causal_conv``, ``_segsum``, ``ssd_forward``,
``ssd_decode_step``, ``ssd_reference``) and through ``prefill`` and
``decode_step`` of the mamba2 and zamba2 smoke configs, in float32 and
in bfloat16.

Tolerances, as max|Δ| / max|reference|: float32 logits 1e-4 and caches
and layer outputs 1e-5 (``tests/test_torch_models.py``'s); bf16 2e-2 for
one layer.  A whole bf16 model is held to ``_bf16_bar``: the smoke
models amplify a one-ulp perturbation over their 3 and 7 layers, so the
reference's own bf16 forward lies a few 1e-2 of max|logits| from its
float32 forward on the same weights, beyond 2e-2 for zamba2.  Two bf16
runs each that far from the float32 truth can lie twice that far from
each other; the bar is the larger of 2e-2 and twice the reference's own
distance, read in the same test on the same inputs.
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
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.models.config import ModelConfig as RConfig
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import decode as TD
from repro_torch.models import layers as TL
from repro_torch.models import settings as SET
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig as TConfig

ARCHS = ["mamba2-1.3b", "zamba2-7b"]
DTYPES = ["float32", "bfloat16"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S, ML = 2, 32, 40          # the smoke configs' chunk is 16: 2 chunks


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(
        jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _rel(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


def _bf16_bar(ref_reading: float) -> float:
    """The bar of a whole bf16 model: the larger of 2e-2 and twice the
    reference's own bf16 distance from its float32 forward (module
    docstring)."""
    return max(2e-2, 2.0 * ref_reading)


def _cfgs(arch, dtype):
    return (dataclasses.replace(RR.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(TR.get_smoke_config(arch), dtype=dtype))


def _toks(cfg, seed=1, n=S + 1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(dtype, reference cfg, port cfg, reference params, port params,
    the reference's params in float32) — one init per arch and dtype."""
    arch, dtype = request.param
    rcfg, tcfg = _cfgs(arch, dtype)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(rparams), "cpu", TDT[dtype])
    r32 = jax.tree.map(lambda a: a.astype(jnp.float32), rparams)
    return dtype, rcfg, tcfg, rparams, tparams, r32


# ---------------------------------------------------------------------------
# The Mamba2 pieces, on one layer
# ---------------------------------------------------------------------------

# The reference's own oracle test config (tests/test_models.py:120).
ORACLE_KW = dict(name="t", family="ssm", num_layers=1, d_model=64,
                 num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
                 vocab_size=64, ssm=True, ssm_state=16, ssm_head_dim=8,
                 ssm_chunk=8, dtype="float32")


@pytest.fixture(scope="module", params=DTYPES)
def block(request):
    """(dtype, reference cfg, port cfg, reference block params, port
    block params) at the mamba2 smoke config's width."""
    dtype = request.param
    rcfg, tcfg = _cfgs("mamba2-1.3b", dtype)
    rp = RS.init_mamba2(jax.random.PRNGKey(0), rcfg, JDT[dtype])
    tp = convert.params_from_numpy(_np(rp), "cpu", TDT[dtype])
    return dtype, rcfg, tcfg, rp, tp


def _x(shape, dtype, seed=0, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.from_numpy(x).to(TDT[dtype]))


def test_causal_conv_equals_reference(block):
    dtype, rcfg, _, rp, tp = block
    C = rcfg.d_inner + 2 * rcfg.ssm_state
    xj, xt = _x((B, S, C), dtype)
    got = TS._causal_conv(xt, tp["conv_w"])
    assert got.dtype == TDT[dtype] and got.shape == (B, S, C)
    assert _rel(got, _np(RS._causal_conv(xj, rp["conv_w"]))) <= \
        CACHE_TOL[dtype]


@pytest.mark.parametrize("L", [16, 256])
def test_segsum_equals_reference_and_masks_before_exp(L):
    """Equal to the reference's, -inf exactly above the diagonal, and its
    exp finite: at chunk 256 cum[i] - cum[j] above the diagonal reaches
    ~+180, where exp overflows (an exp before the mask gives inf · 0 =
    NaN)."""
    a = -np.random.default_rng(L).uniform(0.2, 1.2, (2, 3, L)).astype(
        np.float32)
    want = np.asarray(RS._segsum(jnp.asarray(a)))
    got = TS._segsum(torch.from_numpy(a))
    upper = ~np.tril(np.ones((L, L), bool))
    assert np.isneginf(got.numpy()[..., upper]).all()
    assert np.isneginf(want[..., upper]).all()
    low = ~upper
    # Two cumsums in float32 (values down to ~-180 at L = 256).
    assert _rel(got.numpy()[..., low], want[..., low]) <= 1e-6
    w = torch.exp(got)
    assert torch.isfinite(w).all() and float(w.max()) <= 1.0
    if L == 256:
        assert float((torch.from_numpy(a).cumsum(-1)[..., -1:] -
                      torch.from_numpy(a).cumsum(-1)[..., :1]).abs().max()) \
            > 88.0   # exp(88.7) overflows float32


def test_segsum_sums_each_segment():
    """Each entry is summed over its own segment, so it keeps float32's
    precision at its own size: near the diagonal (|entry| < 1) within
    1e-6 of the float64 sums at L = 256, where the reference's difference
    of two running sums (~-180) is off by ~1e-5."""
    L = 256
    a = -np.random.default_rng(L).uniform(0.2, 1.2, (2, 3, L)).astype(
        np.float32)
    cum = np.cumsum(a.astype(np.float64), -1)
    truth = cum[..., :, None] - cum[..., None, :]
    near = np.tril(np.ones((L, L), bool)) & (np.abs(truth) < 1.0)
    got = TS._segsum(torch.from_numpy(a)).numpy()
    assert np.abs(got - truth)[..., near].max() <= 1e-6
    ref = np.asarray(RS._segsum(jnp.asarray(a)))
    assert np.abs(ref - truth)[..., near].max() > 1e-6


@pytest.mark.parametrize("s,with_init", [(S, False), (24, False),
                                         (10, False), (S, True)],
                         ids=["aligned", "padded", "shorter_than_chunk",
                              "init_state"])
def test_ssd_forward_equals_reference(block, s, with_init):
    dtype, rcfg, tcfg, rp, tp = block
    xj, xt = _x((B, s, rcfg.d_model), dtype)
    init = None
    if with_init:
        init = (np.random.default_rng(5).standard_normal(
            (B, rcfg.ssm_heads, rcfg.ssm_head_dim, rcfg.ssm_state)) *
            0.3).astype(np.float32)
    ry, rs = RS.ssd_forward(rp, xj, rcfg, None if init is None else
                            jnp.asarray(init))
    ty, ts = TS.ssd_forward(tp, xt, tcfg, None if init is None else
                            torch.from_numpy(init))
    assert ty.shape == (B, s, rcfg.d_model) and ty.dtype == TDT[dtype]
    assert ts.dtype == torch.float32 and ts.shape == rs.shape
    assert _rel(ty, _np(ry)) <= CACHE_TOL[dtype]
    assert _rel(ts, _np(rs)) <= CACHE_TOL[dtype]


def test_ssd_decode_step_equals_reference(block):
    dtype, rcfg, tcfg, rp, tp = block
    C = rcfg.d_inner + 2 * rcfg.ssm_state
    xj, xt = _x((B, rcfg.d_model), dtype)
    cj, ct = _x((B, rcfg.conv_width - 1, C), dtype, seed=1)
    st = (np.random.default_rng(2).standard_normal(
        (B, rcfg.ssm_heads, rcfg.ssm_head_dim, rcfg.ssm_state)) * 0.3
        ).astype(np.float32)
    want = RS.ssd_decode_step(rp, xj, cj, jnp.asarray(st), rcfg)
    got = TS.ssd_decode_step(tp, xt, ct, torch.from_numpy(st), tcfg)
    assert got[0].dtype == got[1].dtype == TDT[dtype]
    assert got[2].dtype == torch.float32
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _rel(g, _np(w)) <= CACHE_TOL[dtype]


def test_ssd_reference_equals_reference(block):
    dtype, rcfg, tcfg, rp, tp = block
    xj, xt = _x((B, 12, rcfg.d_model), dtype, scale=0.5)
    got = TS.ssd_reference(tp, xt, tcfg)
    assert got.dtype == TDT[dtype]
    assert _rel(got, _np(RS.ssd_reference(rp, xj, rcfg))) <= CACHE_TOL[dtype]


@pytest.mark.parametrize("s", [40, 64])
def test_port_chunked_equals_its_recurrent_oracle(s):
    """The port's chunked SSD against its own token-by-token oracle within
    the reference's 2e-4 (tests/test_models.py:120-130): S = 40 pads to
    the chunk, S = 64 is aligned."""
    rcfg, tcfg = RConfig(**ORACLE_KW), TConfig(**ORACLE_KW)
    rp = RS.init_mamba2(jax.random.PRNGKey(0), rcfg, jnp.float32)
    tp = convert.params_from_numpy(_np(rp), "cpu")
    x = torch.from_numpy((np.random.default_rng(s).standard_normal(
        (2, s, 64)) * 0.5).astype(np.float32))
    y, _ = TS.ssd_forward(tp, x, tcfg)
    np.testing.assert_allclose(y.numpy(), TS.ssd_reference(tp, x, tcfg)
                               .numpy(), atol=2e-4)


def test_chunked_matches_the_recurrence_at_chunk_256():
    """At mamba2's chunk of 256 the port's chunked SSD stays within 5e-6
    of its recurrence over 512 tokens (two chunks) in float32; the
    reference's, whose decays come from differences of running sums,
    reads ~2.6e-5 here (its bound is 2e-4)."""
    kw = dict(ORACLE_KW, ssm_chunk=256)
    tcfg = TConfig(**kw)
    rp = RS.init_mamba2(jax.random.PRNGKey(0), RConfig(**kw), jnp.float32)
    tp = convert.params_from_numpy(_np(rp), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 512, 64)).astype(np.float32))
    y, _ = TS.ssd_forward(tp, x, tcfg)
    assert float((y - TS.ssd_reference(tp, x, tcfg)).abs().max()) <= 5e-6


# ---------------------------------------------------------------------------
# The whole models: prefill, decode and the full forward
# ---------------------------------------------------------------------------

def _ref_prefill(cfg, params, toks):
    return RD.prefill(cfg, params, {"tokens": jnp.asarray(toks)},
                      max_len=ML, remat=False)


def _tol(dtype, name, readings):
    """The bar of leaf ``name``: float32's fixed bar, or ``_bf16_bar`` of
    the reference's own bf16 reading in ``readings``."""
    if dtype == "float32":
        return (LOGIT_TOL if name == "logits" else CACHE_TOL)[dtype]
    return _bf16_bar(readings[name])


def _f32_readings(rcfg, rcache, rlog, r32, toks, decode_from=None):
    """The reference's bf16 distances from its float32 forward, per leaf:
    its prefill (and, given a cache, one decode step from it)."""
    c32 = dataclasses.replace(rcfg, dtype="float32")
    if decode_from is None:
        want_c, want_l = _ref_prefill(c32, r32, toks)
    else:
        want_l, want_c = RD.decode_step(
            c32, r32, jax.tree.map(lambda a: a.astype(jnp.float32) if
                                   a.dtype == jnp.bfloat16 else a,
                                   decode_from), jnp.asarray(toks))
    out = {"logits": _rel(_np(rlog), _np(want_l))}
    out.update({k: _rel(_np(rcache[k]), _np(want_c[k])) for k in rcache
                if k != "pos"})
    return out


def test_prefill_equals_reference(pair):
    """The logits and every cache leaf: conv (activation type), state
    (float32), the hybrid's sk/sv, pos."""
    dtype, rcfg, tcfg, rparams, tparams, r32 = pair
    toks = _toks(rcfg)[:, :S]
    rcache, rlog = _ref_prefill(rcfg, rparams, toks)
    tcache, tlog = TD.prefill(tcfg, tparams, {"tokens": torch.from_numpy(
        toks)}, max_len=ML)
    rc = _np(rcache)
    assert tcache.keys() == rc.keys() == ({"pos", "conv", "state"} | (
        {"sk", "sv"} if rcfg.hybrid_attn_every else set()))
    assert tlog.shape == (B, tcfg.vocab_size) and tlog.dtype == TDT[dtype]
    assert tcache["state"].dtype == torch.float32
    assert tcache["conv"].dtype == TDT[dtype]
    assert int(tcache["pos"]) == int(rc["pos"]) == S
    readings = (_f32_readings(rcfg, rcache, rlog, r32, toks)
                if dtype == "bfloat16" else {})
    assert _rel(tlog, _np(rlog)) <= _tol(dtype, "logits", readings)
    for name in ("conv", "state", "sk", "sv"):
        if name in rc:
            assert tuple(tcache[name].shape) == rc[name].shape, name
            assert _rel(tcache[name], rc[name]) <= _tol(dtype, name,
                                                        readings), name


def test_decode_step_equals_reference_and_writes_in_place(pair):
    """One decode step from the reference's own cache: logits and cache
    against the reference's; conv and state written into the input's
    tensors, and the hybrid's K/V only at position ``pos`` of each
    slot."""
    dtype, rcfg, tcfg, rparams, tparams, r32 = pair
    toks = _toks(rcfg, seed=3)
    rcache, _ = _ref_prefill(rcfg, rparams, toks[:, :S])
    rlog, rcache2 = RD.decode_step(rcfg, rparams, rcache,
                                   jnp.asarray(toks[:, S]))
    rc = _np(rcache)
    tin = convert.cache_from_numpy(rc, "cpu", TDT[dtype])
    assert tin["state"].dtype == torch.float32
    before = {k: v.clone() for k, v in tin.items()}
    tlog, tc2 = TD.decode_step(tcfg, tparams, tin,
                               torch.from_numpy(toks[:, S]))
    readings = {}
    if dtype == "bfloat16":
        readings = _f32_readings(rcfg, rcache2, rlog, r32, toks[:, S],
                                 decode_from=rcache)
    assert _rel(tlog, _np(rlog)) <= _tol(dtype, "logits", readings)
    rc2 = _np(rcache2)
    assert int(tc2["pos"]) == int(rc2["pos"]) == S + 1
    for name in tin:
        if name == "pos":
            continue
        assert tc2[name] is tin[name], name          # the same tensors
        assert _rel(tc2[name], rc2[name]) <= _tol(dtype, name,
                                                  readings), name
    for name in ("sk", "sv"):
        if name in tin:
            changed = (tc2[name] != before[name]).any(dim=(0, 1, 3, 4))
            assert torch.nonzero(changed).flatten().tolist() == [S]


def test_prefill_then_decode_equals_full_forward(pair):
    """Prefill over S tokens + one decode step == the port's full forward
    over S + 1 at the last position (tests/test_models.py:71 holds the
    reference so); the port's full forward equals the reference's."""
    dtype, rcfg, tcfg, rparams, tparams, r32 = pair
    toks = _toks(rcfg, seed=2)
    h, aux = TT.backbone(tcfg, tparams, TT.embed_inputs(
        tcfg, tparams, {"tokens": torch.from_numpy(toks)}))
    assert float(aux) == 0.0
    h = TL.rmsnorm(h, tparams["final_norm"], tcfg.norm_eps)
    want = TT.lm_head_logits(tcfg, tparams, h[:, -1:])[:, 0]
    cache, _ = TD.prefill(tcfg, tparams, {"tokens": torch.from_numpy(
        toks[:, :S])}, max_len=ML)
    got, _ = TD.decode_step(tcfg, tparams, cache, torch.from_numpy(
        toks[:, S]))

    def ref_full(cfg, params):
        x = RT.embed_inputs(cfg, params, {"tokens": jnp.asarray(toks)})
        rh, _ = RT.backbone(cfg, params, x, remat=False)
        rh = RL.rmsnorm(rh, params["final_norm"], cfg.norm_eps)
        return RT.lm_head_logits(cfg, params, rh[:, -1:])[:, 0]

    rwant = ref_full(rcfg, rparams)
    readings = {}
    if dtype == "bfloat16":
        # The reference's own decode-vs-full gap, and its full forward's
        # distance from the float32 one.
        rcache, _ = _ref_prefill(rcfg, rparams, toks[:, :S])
        rgot, _ = RD.decode_step(rcfg, rparams, rcache,
                                 jnp.asarray(toks[:, S]))
        r32want = ref_full(dataclasses.replace(rcfg, dtype="float32"), r32)
        readings = {"decode": _rel(_np(rgot), _np(rwant)),
                    "logits": _rel(_np(rwant), _np(r32want))}
    bar = 1e-4 if dtype == "float32" else _bf16_bar(readings["decode"])
    assert _rel(got, want.float()) <= bar
    assert _rel(want, _np(rwant)) <= _tol(dtype, "logits", readings)


@pytest.mark.parametrize("arch", ARCHS)
def test_unaligned_prompt_keeps_the_padding_decay(arch):
    """A prompt of 20 tokens pads to 32 (chunk 16): the final state picks
    up the padding's extra decay exactly as the reference's does, so it
    differs from the state the recurrence reaches after the 20 tokens."""
    rcfg, tcfg = _cfgs(arch, "float32")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(rparams), "cpu")
    toks = _toks(rcfg, seed=4)[:, :20]
    rcache, rlog = _ref_prefill(rcfg, rparams, toks)
    tcache, tlog = TD.prefill(tcfg, tparams, {"tokens": torch.from_numpy(
        toks)}, max_len=ML)
    rc = _np(rcache)
    assert _rel(tlog, _np(rlog)) <= LOGIT_TOL["float32"]
    for name in tcache:
        assert _rel(tcache[name], rc[name]) <= CACHE_TOL["float32"], name
    # The recurrence's state after the same 20 tokens, layer 0 (whose
    # input is the embedding alone).
    lp = SET.tree_index(tparams["layers"], 0)
    h = TL.rmsnorm(tparams["embed"][torch.from_numpy(toks).long()],
                   lp["norm1"], tcfg.norm_eps)
    conv = torch.zeros_like(tcache["conv"][0])
    st = torch.zeros_like(tcache["state"][0])
    for t in range(h.shape[1]):
        _, conv, st = TS.ssd_decode_step(lp["mamba"], h[:, t], conv, st,
                                         tcfg)
    assert float((tcache["state"][0] - st).abs().max()) > 1e-3 * float(
        st.abs().max())
    assert torch.allclose(tcache["conv"][0], conv, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [1, 2])
def test_prompt_shorter_than_the_conv_state_raises(arch, s):
    _, tcfg = _cfgs(arch, "float32")
    params = TT.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="shorter than the conv state"):
        TD.prefill(tcfg, params, {"tokens": torch.zeros((1, s),
                                                        dtype=torch.int32)},
                   max_len=8)


# ---------------------------------------------------------------------------
# Parameters, cache layout, conversion, entry points
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layouts_and_distributions(arch):
    """The port's random weights have the reference's tree, shapes and
    types (A_log, D, dt_bias float32 in a bf16 model), its scales
    (N(0, 1/d_in); the conv N(0, 1/W)) and constants."""
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    ref = dict(_leaves(RT.init_params(rcfg, jax.random.PRNGKey(0))))
    got = dict(_leaves(TT.init_params(tcfg, seed=0, device="cpu")))
    assert ref.keys() == got.keys()
    for k, r in ref.items():
        assert tuple(got[k].shape) == r.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(r.dtype), k
    m = ".layers.mamba."
    for name in ("A_log", "D", "dt_bias"):
        assert got[m + name].dtype == torch.float32
    assert bool((got[m + "A_log"] == 0).all())
    assert bool((got[m + "D"] == 1).all())
    assert bool((got[m + "dt_bias"] == 0).all())
    assert bool((got[m + "norm"] == 1).all())
    d, di = tcfg.d_model, tcfg.d_inner
    scales = {m + "wz": d, m + "wx": d, m + "wo": di,
              m + "conv_w": tcfg.conv_width}
    if tcfg.hybrid_attn_every:
        scales.update({".shared_attn.attn.wq": d, ".shared_attn.mlp.wo":
                       tcfg.d_ff})
    for k, fan_in in scales.items():
        w = got[k].float()
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1, k


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout_equals_reference(arch):
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    ref = RD.init_cache(rcfg, 3, 12)
    got = TD.init_cache(tcfg, 3, 12, device="cpu")
    assert ref.keys() == got.keys()
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(ref[k].dtype), k
    assert got["state"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_leaves_survive_a_bf16_conversion(arch):
    """params_from_numpy(..., bfloat16) keeps A_log, D and dt_bias float32
    and bit for bit; cache_from_numpy keeps the SSM state float32."""
    rcfg, tcfg = _cfgs(arch, "float32")
    rp = _np(RT.init_params(rcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for name in ("A_log", "D", "dt_bias"):   # not their constant init
        rp["layers"]["mamba"][name] = rng.standard_normal(
            rp["layers"]["mamba"][name].shape).astype(np.float32)
    tp = convert.params_from_numpy(rp, "cpu", torch.bfloat16)
    for name in ("A_log", "D", "dt_bias"):
        t = tp["layers"]["mamba"][name]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), rp["layers"]["mamba"][name])
    assert tp["layers"]["mamba"]["wz"].dtype == torch.bfloat16
    assert tp["embed"].dtype == torch.bfloat16
    rc = _np(RD.init_cache(rcfg, 2, 8))
    rc["state"] = rng.standard_normal(rc["state"].shape).astype(np.float32)
    tc = convert.cache_from_numpy(rc, "cpu", torch.bfloat16)
    assert tc["state"].dtype == torch.float32
    np.testing.assert_array_equal(tc["state"].numpy(), rc["state"])
    assert tc["conv"].dtype == torch.bfloat16
    assert tc["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_ssm_smoke_configs_on_the_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--device", "cpu", "--requests",
                        "12", "--max-len", "24"]) == 0
    out = capsys.readouterr().out
    assert "measured decode_step cost" in out and "policy=pspice" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_need_a_card_unless_told_cpu(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TR.get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.init_cache(cfg, 1, 8)
    assert TT.init_params(cfg, device="cpu")["embed"].device.type == "cpu"


@pytest.mark.parametrize("arch", ARCHS)
def test_shared_block_runs_at_the_reference_points(arch):
    """zamba2-7b: 13 application points (layers 5, 11, .., 77), one cache
    slot each; its smoke config 2 (layers 2 and 5); mamba2 none."""
    for cfg in (TR.get_config(arch), TR.get_smoke_config(arch)):
        pts = [i for i in range(cfg.num_layers)
               if TT.shared_slot(cfg, i) is not None]
        every = cfg.hybrid_attn_every
        want = ([i for i in range(cfg.num_layers) if (i + 1) % every == 0]
                if every else [])
        assert pts == want
        assert [TT.shared_slot(cfg, i) for i in pts] == list(range(len(pts)))
        if every:
            assert len(pts) == cfg.num_layers // every
    assert len([i for i in range(81) if TT.shared_slot(
        TR.get_config("zamba2-7b"), i) is not None]) == 13
