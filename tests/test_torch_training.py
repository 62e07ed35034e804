"""The port's training path on the CPU against the reference's.

* ``forward_train``'s loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's on the smoke configs of the
  dense, MoE, SSM, hybrid, VLM and encoder-decoder families (float32, the
  same NumPy weights and batch); one train step (clip + AdamW) likewise.
* The flash ``autograd.Function``: its gradient (the plain version's VJP,
  recomputed in its backward) against the plain version under autograd
  and against ``jax.grad`` of the reference's flash attention.
* AdamW, clipping and the schedule over several steps against the
  reference's; its own tests (``tests/test_training.py``: TestOptimizer,
  TestCheckpoint, TestCompression) ported.
* Checkpoints: the reference's on-disk format byte for byte, and each
  package restoring the other's (float32, int32 and bf16 leaves).
* int8 compression bitwise (round half to even), and the compressed
  all-reduce in a gloo world of 2 (``dist.spawn``) against the
  reference's ``shard_map`` on 2 forced host devices, exactly.
* ``launch.train``: its batch bit for bit, the loop through a NaN restore
  and a resume equal to running on.
"""
import filecmp
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.launch import train as RLT
from repro.models import layers as RLY
from repro.models import transformer as RT
from repro.training import checkpoint as RCK
from repro.training import compression as RCOMP
from repro.training import optimizer as RO
from repro.training import train_step as RTS
from repro_torch import dist as D
from repro_torch.configs import registry as TR
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import train as TLT
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint as CK
from repro_torch.training import compression as COMP
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as TS
from repro_torch.training.tree import items

import _dist_worlds as W
import _train_reference as TRF

# One smoke config per family: dense, MoE, MoE + MLA, SSM, hybrid, VLM,
# encoder-decoder.
ARCHS = ["internlm2-1.8b", "deepseek-moe-16b", "deepseek-v3-671b",
         "mamba2-1.3b", "zamba2-7b", "internvl2-76b", "whisper-small"]
B, S = 2, 32
# float32: |loss| relative, and each gradient leaf's max|Δ| against its
# max|grad| (the reference's remat and XLA's fusion round otherwise).
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    """{"a/b/c": array} of a jax or port tree (tensors as NumPy)."""
    return {"/".join(map(str, p)): (v.detach().float().numpy()
                                    if isinstance(v, torch.Tensor)
                                    else np.asarray(v, np.float32))
            for p, v in items(tree)}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-30)


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    s_text = S - cfg.vlm_patches
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s_text)),
           "labels": rng.integers(0, cfg.vocab_size, (B, s_text))}
    out = {k: v.astype(np.int32) for k, v in out.items()}
    mask = np.ones((B, s_text), np.float32)
    mask[1, -5:] = 0.0
    out["loss_mask"] = mask
    if cfg.vlm_patches:
        out["patches"] = (rng.standard_normal(
            (B, cfg.vlm_patches, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def _family(arch):
    """(arch, reference cfg, port cfg, reference params, port params,
    NumPy batch)."""
    rcfg = RR.get_smoke_config(arch)
    tcfg = TR.get_smoke_config(arch)
    assert rcfg.dtype == "float32"
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(rparams), "cpu")
    return arch, rcfg, tcfg, rparams, tparams, _batch(rcfg)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return _family(request.param)


def test_forward_train_loss_and_grads_equal_reference(fam):
    arch, rcfg, tcfg, rparams, tparams, nb = fam
    rb = {k: jnp.asarray(v) for k, v in nb.items()}
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: RT.forward_train(rcfg, p, rb), has_aux=True)(rparams)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tloss, tmet, tgrads = TS.loss_and_grads(tcfg, tparams, tb)
    assert abs(float(tloss) - float(rloss)) <= LOSS_TOL * abs(float(rloss))
    assert abs(float(tmet["ce"]) - float(rmet["ce"])) <= \
        LOSS_TOL * abs(float(rmet["ce"]))
    assert abs(float(tmet["aux"]) - float(rmet["aux"])) <= 1e-5
    if rcfg.moe:
        assert float(rmet["aux"]) > 0
    rg, tg = _flat(rgrads), _flat(tgrads)
    assert rg.keys() == tg.keys()
    bad = {k: _rel(tg[k], rg[k]) for k in rg
           if not _rel(tg[k], rg[k]) <= GRAD_TOL}
    assert not bad, bad
    # Every leaf the loss reaches has a gradient somewhere.
    assert sum(float(np.abs(g).max()) > 0 for g in tg.values()) >= \
        len(tg) - 1


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-small"])
def test_train_step_equals_reference(arch):
    """One step of loss -> grads -> clip -> AdamW from the same weights
    and batch (one dense and the encoder-decoder config; the loss and
    grads are held for every family above): the parameters and both
    moments.  eps 1e-3: Adam's first step moves each weight by about
    lr·sign(g), so at the default eps a gradient near 1e-8 would turn
    its rounding into a whole step."""
    arch, rcfg, tcfg, rparams, tparams, nb = _family(arch)
    ocfg = RO.AdamWConfig(lr=1e-2, warmup_steps=2, eps=1e-3)
    tocfg = O.AdamWConfig(lr=1e-2, warmup_steps=2, eps=1e-3)
    rp, ro, rm = jax.jit(RTS.make_train_step(rcfg, ocfg))(
        rparams, RO.init_opt_state(rparams),
        {k: jnp.asarray(v) for k, v in nb.items()})
    tp, to, tm = TS.make_train_step(tcfg, tocfg)(
        tparams, O.init_opt_state(tparams),
        {k: torch.from_numpy(v) for k, v in nb.items()})
    assert int(to["step"]) == int(ro["step"]) == 1
    assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
        1e-5 * float(rm["grad_norm"])
    for name, r, t in (("params", rp, tp), ("m", ro["m"], to["m"]),
                       ("v", ro["v"], to["v"])):
        rf, tf = _flat(r), _flat(t)
        bad = {k: _rel(tf[k], rf[k]) for k in rf
               if not _rel(tf[k], rf[k]) <= GRAD_TOL}
        assert not bad, (name, bad)


# ---------------------------------------------------------------------------
# The flash kernel's gradient
# ---------------------------------------------------------------------------

FLASH_CASES = [  # B, Sq, Sk, H, KVH, D, Dv, causal, q_offset
    (2, 40, 40, 4, 2, 16, 16, True, 0),
    (1, 24, 56, 4, 4, 16, 8, False, 0),
    (2, 20, 36, 4, 1, 8, 8, True, 16),
    # Several chunk pairs at the default chunks (512, 1024): q chunks of
    # 300 on the causal triangle; two KV chunks of 550.
    (1, 600, 600, 2, 1, 8, 8, True, 0),
    (1, 40, 1100, 2, 2, 8, 8, False, 0),
]


def _qkv(case, seed=5):
    Bq, Sq, Sk, H, KVH, Dk, Dv, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((Bq, Sq, H, Dk), (Bq, Sk, KVH, Dk), (Bq, Sk, KVH, Dv))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_function_gradient_is_the_plain_versions(case):
    """On the CPU the wrapper's forward is the plain version, inside the
    autograd.Function when an input requires grad; its backward is the
    plain version's VJP — equal, bit for bit, to autograd through the
    plain version itself, and within 1e-5 of jax.grad through the
    reference's flash attention."""
    causal, q_off = case[7], case[8]
    arrs = _qkv(case)
    cot = np.random.default_rng(6).standard_normal(
        case[:2] + (case[3], case[6])).astype(np.float32)

    def grads(fn):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
        out = fn(*ins)
        return out, torch.autograd.grad(out, ins, torch.from_numpy(cot))

    out_f, g_f = grads(lambda q, k, v: kfa.flash_attention(
        q, k, v, causal=causal, q_offset=q_off))
    assert type(out_f.grad_fn).__name__ == "_FlashAttentionBackward"
    out_p, g_p = grads(lambda q, k, v: kfa.flash_attention_plain(
        q, k, v, causal=causal, q_offset=q_off))
    assert torch.equal(out_f, out_p)
    for a, b in zip(g_f, g_p):
        assert torch.equal(a, b)

    def ref(q, k, v):
        o = RLY.flash_attention(q, k, v, causal=causal, q_offset=q_off)
        return jnp.sum(o * jnp.asarray(cot))
    rg = jax.grad(ref, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    for a, b in zip(g_f, rg):
        assert _rel(a.numpy(), b) <= 1e-5


def test_flash_without_grad_records_nothing():
    arrs = [torch.from_numpy(a) for a in _qkv(FLASH_CASES[0])]
    out = kfa.flash_attention(*arrs)
    assert out.grad_fn is None
    with torch.no_grad():
        ins = [a.clone().requires_grad_() for a in arrs]
        out2 = kfa.flash_attention(*ins)
    assert out2.grad_fn is None and torch.equal(out, out2)
    # Only the inputs that need a gradient get one.
    q, k, v = (arrs[0].clone().requires_grad_(), arrs[1], arrs[2])
    (gq,) = torch.autograd.grad(kfa.flash_attention(q, k, v).sum(), [q])
    assert gq.shape == q.shape and bool(torch.isfinite(gq).all())


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def _opt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "blk": {"b": rng.standard_normal((16,)).astype(np.float32),
                    "h": (rng.standard_normal((4, 4)) * 3).astype(
                        np.float32)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_and_clip_over_steps_equal_reference(dtype):
    """Five clipped AdamW steps (warm-up 3, decay on) from the same
    weights and gradients.  float32 within 1e-6 of each leaf's size; in
    bf16 the parameter may round one bf16 step apart where the float32
    update lands within an ulp of a rounding boundary."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p0 = _opt_tree()
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p0)
    tp = convert.params_from_numpy(p0, "cpu", tdt)
    ro, to = RO.init_opt_state(rp), O.init_opt_state(tp)
    rcfg = RO.AdamWConfig(lr=0.05, warmup_steps=3, clip_norm=2.0)
    tcfg = O.AdamWConfig(lr=0.05, warmup_steps=3, clip_norm=2.0)
    for step in range(5):
        g = jax.tree.map(lambda a: a * (step + 1), _opt_tree(10 + step))
        rg, rn = RO.clip_by_global_norm(
            jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g),
            rcfg.clip_norm)
        tg, tn = O.clip_by_global_norm(
            convert.params_from_numpy(g, "cpu", tdt), tcfg.clip_norm)
        assert abs(float(tn) - float(rn)) <= 1e-6 * float(rn)
        for k, v in _flat(tg).items():
            assert _rel(v, _flat(rg)[k]) <= (1e-6 if dtype == "float32"
                                             else 4e-3)
        rp, ro = RO.adamw_update(rcfg, rp, rg, ro)
        tp, to = O.adamw_update(tcfg, tp, tg, to)
        assert float(O.lr_schedule(tcfg, to["step"])) == \
            float(RO.lr_schedule(rcfg, ro["step"]))
        for name, r, t, tol in (("params", rp, tp, 1e-6 if dtype ==
                                 "float32" else 8e-3),
                                ("m", ro["m"], to["m"], 1e-6),
                                ("v", ro["v"], to["v"], 1e-6)):
            rf, tf = _flat(r), _flat(t)
            for k in rf:
                assert _rel(tf[k], rf[k]) <= tol, (step, name, k)
        assert to["m"]["w"].dtype == torch.float32
        assert tp["w"].dtype == tdt
    assert int(to["step"]) == 5


class TestOptimizer:
    """The reference's own optimizer tests, on the port."""

    def test_adamw_decreases_quadratic(self):
        cfg = O.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
        params = {"w": torch.tensor([5.0, -3.0])}
        opt = O.init_opt_state(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, opt = O.adamw_update(cfg, params, grads, opt)
        assert float(params["w"].abs().max()) < 0.1

    def test_clip_by_global_norm(self):
        g = {"a": torch.ones(100) * 10.0}
        clipped, norm = O.clip_by_global_norm(g, 1.0)
        assert abs(float(O.global_norm(clipped)) - 1.0) < 1e-4
        assert abs(float(norm) - 100.0) < 1e-3

    def test_nested_structure_preserved(self):
        cfg = O.AdamWConfig()
        params = {"l": {"w": torch.ones((2, 2)), "b": torch.zeros(2)}}
        opt = O.init_opt_state(params)
        grads = {"l": {k: torch.ones_like(v)
                       for k, v in params["l"].items()}}
        p2, o2 = O.adamw_update(cfg, params, grads, opt)
        assert set(p2) == {"l"} and set(p2["l"]) == {"w", "b"}
        assert int(o2["step"]) == 1
        assert torch.equal(params["l"]["w"], torch.ones((2, 2)))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

class TestCheckpoint:
    """The reference's own checkpoint tests, on the port."""

    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                "b": {"c": torch.ones(5, dtype=torch.int32)}}
        CK.save(str(tmp_path), 7, tree)
        out = CK.restore(str(tmp_path), tree)
        assert torch.equal(out["a"], tree["a"])
        assert torch.equal(out["b"]["c"], tree["b"]["c"])

    def test_latest_and_gc(self, tmp_path):
        tree = {"x": torch.zeros(3)}
        for s in (1, 2, 3, 4, 5):
            CK.save(str(tmp_path), s, tree, keep_last=2)
        assert CK.latest_step(str(tmp_path)) == 5
        assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                                "step_00000005"]

    def test_atomicity_no_partial_dirs(self, tmp_path):
        CK.save(str(tmp_path), 1, {"x": torch.zeros(3)})
        assert not any(d.startswith(".tmp") for d in os.listdir(tmp_path))

    def test_shape_mismatch_raises(self, tmp_path):
        CK.save(str(tmp_path), 1, {"x": torch.zeros(3)})
        with pytest.raises(ValueError):
            CK.restore(str(tmp_path), {"x": torch.zeros(4)})

    def test_no_checkpoint_raises(self, tmp_path):
        assert CK.latest_step(str(tmp_path / "none")) is None
        with pytest.raises(FileNotFoundError):
            CK.restore(str(tmp_path), {"x": torch.zeros(3)})


def _mixed_tree():
    """float32, int32 and bf16 leaves, a 0-d step, nested and sorted
    apart from insertion order (jax flattens by sorted keys)."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return {"params": {"z": w, "a": {"bf": jnp.asarray(w.T).astype(
        jnp.bfloat16)}}, "opt": {"step": np.int32(7),
                                 "m": np.arange(6, dtype=np.int32)}}


def _port_tree(ref):
    return {"params": {"z": torch.from_numpy(np.array(ref["params"]["z"])),
                       "a": {"bf": torch.from_numpy(np.asarray(
                           ref["params"]["a"]["bf"], np.float32)).to(
                               torch.bfloat16)}},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": torch.arange(6, dtype=torch.int32)}}


def test_checkpoint_format_is_the_references(tmp_path):
    """The same tree written by both packages: the same directory, file
    names, manifest and .npy bytes (bf16 as the reference's '<V2')."""
    ref = _mixed_tree()
    RCK.save(str(tmp_path / "ref"), 3, ref)
    CK.save(str(tmp_path / "port"), 3, _port_tree(ref))
    a, b = tmp_path / "ref" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    assert ma == mb and list(ma["arrays"]) == list(mb["arrays"])
    assert ma["arrays"]["params/a/bf"]["dtype"] == "bfloat16"
    for f in os.listdir(a):
        assert filecmp.cmp(a / f, b / f, shallow=False), f


def test_checkpoints_restore_across_packages(tmp_path):
    ref = _mixed_tree()
    port = _port_tree(ref)
    # The reference's checkpoint restored by the port, as tensors.
    RCK.save(str(tmp_path / "ref"), 5, ref)
    got = CK.restore(str(tmp_path / "ref"), port)
    for (pa, x), (pb, y) in zip(items(got), items(port)):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa
    # The port's restored by the reference (its bf16 leaves come back as
    # the raw '<V2' bytes, as from its own checkpoints).
    CK.save(str(tmp_path / "port"), 6, port)
    back = RCK.restore(str(tmp_path / "port"), ref)
    assert RCK.latest_step(str(tmp_path / "port")) == 6
    np.testing.assert_array_equal(back["params"]["z"], ref["params"]["z"])
    np.testing.assert_array_equal(back["opt"]["m"], ref["opt"]["m"])
    assert int(back["opt"]["step"]) == 7
    bits = port["params"]["a"]["bf"].view(torch.int16).numpy()
    assert back["params"]["a"]["bf"].dtype.itemsize == 2
    np.testing.assert_array_equal(back["params"]["a"]["bf"].view(np.int16),
                                  bits)
    # A NumPy-like tree restores as arrays, bf16 as its int16 bits.
    got = CK.restore(str(tmp_path / "port"), ref)
    np.testing.assert_array_equal(got["params"]["a"]["bf"], bits)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def test_quantize_int8_bitwise():
    """Round half to even (127 / 127 = 1: halves land exactly), then a
    random tensor and compress_decompress with error feedback."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.49, -126.5],
                 np.float32)
    rng = np.random.default_rng(4)
    for a in (x, (rng.standard_normal(1000) * 3).astype(np.float32)):
        rq, rs = RCOMP.quantize_int8(jnp.asarray(a))
        tq, ts = COMP.quantize_int8(torch.from_numpy(a))
        assert tq.dtype == torch.int8 and float(ts) == float(rs)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(
            COMP.dequantize_int8(tq, ts).numpy(),
            np.asarray(RCOMP.dequantize_int8(rq, rs)))
    assert COMP.quantize_int8(torch.from_numpy(x))[0].tolist()[:6] == \
        [127, 0, 2, 2, 0, -2]
    e = rng.standard_normal(1000).astype(np.float32) * 1e-2
    rd, re = RCOMP.compress_decompress(jnp.asarray(a), jnp.asarray(e))
    td, te = COMP.compress_decompress(torch.from_numpy(a),
                                      torch.from_numpy(e))
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))


class TestCompression:
    """The reference's own compression tests, on the port."""

    def test_quantize_roundtrip_bounded_error(self):
        g = torch.Generator().manual_seed(0)
        x = torch.randn(1000, generator=g) * 3
        q, s = COMP.quantize_int8(x)
        err = (COMP.dequantize_int8(q, s) - x).abs().max()
        assert float(err) <= float(s) * 0.5 + 1e-6

    def test_error_feedback_unbiased_over_time(self):
        g = torch.randn(512, generator=torch.Generator().manual_seed(1))
        err = torch.zeros_like(g)
        acc = torch.zeros_like(g)
        for _ in range(100):
            deq, err = COMP.compress_decompress(g, err)
            acc += deq
        rel = float((acc - 100 * g).abs().max() / (100 * g).abs().max())
        assert rel < 1e-3

    def test_wire_bytes_and_error_state(self):
        grads = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5)}}
        ref = {"a": jnp.zeros((3, 4)), "b": {"c": jnp.zeros(5)}}
        assert COMP.wire_bytes_saved(grads) == \
            RCOMP.wire_bytes_saved(ref) == (68, 17)
        e = COMP.init_error_state(grads)
        assert e["b"]["c"].dtype == torch.float32 and \
            e["a"].shape == (3, 4)


def test_compressed_psum_world_of_two_equals_reference(tmp_path):
    """Two error-feedback rounds of ``sync_tree`` on a gloo world of 2
    rank processes, against the reference's ``sync_tree`` in a
    ``shard_map`` over 2 forced host devices (its own process): every
    rank's mean and new error equal, bit for bit."""
    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(W.HERE.parent / "src"),
                                           str(W.HERE)]))
    ref = subprocess.Popen(
        [sys.executable, str(W.HERE / "_train_reference.py"), str(out)],
        env=env, cwd=W.HERE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    grads, err = TRF.inputs()
    ranks = D.spawn(W.compressed_sync_rank, 2, args=(grads, err),
                    timeout=W.WORLD_TIMEOUT, workdir=str(tmp_path))
    truth = W.reference_result(ref, out)
    assert set(truth) == set(ranks[0]) and len(truth) == 8
    for r, got in enumerate(ranks):
        for k, v in got.items():
            np.testing.assert_array_equal(v, truth[k][r], err_msg=k)
    for k in truth:
        if ".mean" in k:
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


# ---------------------------------------------------------------------------
# The training driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seq", [("internlm2-1.8b", 64),
                                      ("internvl2-76b", 40),
                                      ("whisper-small", 16)])
def test_synthetic_batch_is_the_references(arch, seq):
    cfg = TR.get_smoke_config(arch)
    rcfg = RR.get_smoke_config(arch)
    for step in (0, 5):
        got = TLT.synthetic_batch(cfg, 3, seq, step, device="cpu")
        want = RLT.synthetic_batch(rcfg, 3, seq, step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == {"int32": torch.int32,
                                    "float32": torch.float32}[
                str(want[k].dtype)]
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_train_main_through_nan_restore_and_resume(tmp_path, capsys):
    """``launch.train --smoke`` (CLI): a NaN at step 3 restores the step-2
    checkpoint (bit for bit what was saved) and skips the batch; a second
    command resumes from the latest checkpoint (6) and its result equals
    running on in memory from the first run's state."""
    d = str(tmp_path / "ck")
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-dir", d, "--ckpt-every", "2"]
    assert TLT.main(argv + ["--steps", "6", "--inject-nan-at", "3"]) == 0
    log = capsys.readouterr().out
    assert "step 3: NON-FINITE loss — restoring last checkpoint" in log
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000006"]
    assert "step    3 loss" not in log and "step    5 loss" in log
    assert TLT.main(argv + ["--steps", "8"]) == 0
    log = capsys.readouterr().out
    assert "resuming from checkpoint step 6" in log
    assert "step    6 loss" in log and "step    5 loss" not in log

    # The same through the loop, each restore checked against its save.
    cfg = TR.get_smoke_config("internlm2-1.8b")
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=10)
    params = TT.init_params(cfg, seed=0, device="cpu")
    kw = dict(batch=2, seq=32, opt_cfg=ocfg, device="cpu",
              log=lambda s: None)
    saved, seen = {}, []

    def on_checkpoint(kind, step, state):
        bits = [t.clone() for _, t in items(state)]
        if kind == "save":
            saved[step] = bits
        else:
            seen.append(step)
            assert all(torch.equal(a, b) for a, b in
                       zip(bits, saved[step]))
    d2 = str(tmp_path / "ck2")
    run = TLT.train_loop(cfg, params, O.init_opt_state(params), steps=6,
                         ckpt_dir=d2, ckpt_every=2, inject_nan_at=3,
                         on_checkpoint=on_checkpoint, **kw)
    assert seen == [2] and run["restored"] == [2]
    assert run["saved"] == [2, 6]
    assert [s for s, _ in run["losses"]] == [0, 1, 2, 4, 5]
    assert all(np.isfinite(x) for _, x in run["losses"])
    on = TLT.train_loop(cfg, run["params"], run["opt"], steps=8, start=6,
                        **kw)
    p, o, start = TLT.resume(d2, params, O.init_opt_state(params),
                             log=lambda s: None)
    assert start == 6
    for (pa, a), (pb, b) in zip(items({"p": p, "o": o}),
                                items({"p": run["params"],
                                       "o": run["opt"]})):
        assert torch.equal(a, b), pa
    res = TLT.train_loop(cfg, p, o, steps=8, start=start, **kw)
    assert res["losses"] == on["losses"]
    for (pa, a), (_, b) in zip(items(res["params"]), items(on["params"])):
        assert torch.equal(a, b), pa


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-small"])
def test_train_loop_equals_reference_loss(arch):
    """The first steps of the port's loop against the reference's jitted
    train step on the same (smoke, float32) weights and batches (whisper:
    the reference's zero frames stub)."""
    rcfg = RR.get_smoke_config(arch)
    tcfg = TR.get_smoke_config(arch)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np(rparams), "cpu")
    rstep = jax.jit(RTS.make_train_step(rcfg, RO.AdamWConfig(
        lr=1e-3, warmup_steps=10)))
    ropt = RO.init_opt_state(rparams)
    want = []
    for step in range(3):
        rparams, ropt, m = rstep(rparams, ropt,
                                 RLT.synthetic_batch(rcfg, 2, 32, step))
        want.append(float(m["loss"]))
    run = TLT.train_loop(tcfg, tparams, O.init_opt_state(tparams), steps=3,
                         batch=2, seq=32, opt_cfg=O.AdamWConfig(
                             lr=1e-3, warmup_steps=10), device="cpu",
                         log=lambda s: None)
    assert [s for s, _ in run["losses"]] == [0, 1, 2]
    np.testing.assert_allclose([x for _, x in run["losses"]], want,
                               rtol=1e-5)


def test_eval_step_equals_reference():
    arch, rcfg, tcfg, rparams, tparams, nb = _family("internvl2-76b")
    want = RTS.make_eval_step(rcfg)(
        rparams, {k: jnp.asarray(v) for k, v in nb.items()})
    got = TS.make_eval_step(tcfg)(
        tparams, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert got.grad_fn is None
    assert abs(float(got) - float(want)) <= LOSS_TOL * abs(float(want))


def test_training_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TR.get_smoke_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        TLT.synthetic_batch(cfg, 1, 8, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TLT.main(["--smoke", "--steps", "1"])
    params = TT.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TLT.train_loop(cfg, params, O.init_opt_state(params), steps=1,
                       batch=1, seq=8, log=lambda s: None)
