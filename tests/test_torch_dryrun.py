"""The port's dry-run and roofline tools against the reference's.

* Per-device argument bytes (``launch.dryrun.argument_bytes``, from the
  structures and the specs, no trace) equal the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` to the byte for every
  architecture's decode_32k and internlm2-1.8b's train_4k on (16, 16)
  and (32, 8) (the reference on 256 forced host devices with Auto axes,
  ``tests/_dryrun_reference.py``, in a subprocess).
* ``model_flops``, ``analysis_depths`` and ``engine_block_intensity``
  (stock, soccer, bus) equal the reference's (its ``model_flops`` from
  the subprocess: its dryrun module forces 512 host devices on import,
  which no test process may do).
* The flash op's FLOP formula equals ``FlopCounterMode`` over the plain
  version (causal, non-causal, ragged 1 500, Dv != D; both chunk
  settings); the op's fake output; the wrapper's DTensor alignment.
* The collective recorder's bytes on known collectives of a fake mesh.
* A world of one on the CPU (mesh (1, 1)): the full-depth trace's FLOPs
  equal ``FlopCounterMode`` over the same step run for real, its
  argument bytes the real tensors' bytes, and under analysis mode the
  two-depth extrapolation the full-depth trace in FLOPs and bytes; every
  family's smoke config traces on a fake (2, 2) mesh.
* ``remat=True`` equals ``remat=False`` bit for bit in loss and every
  gradient (float32 smoke configs of every family), and the latter is
  within the 1e-4 bar of the reference's ``remat=True`` gradients (dense,
  MoE with MLA, encoder-decoder); ``constrain`` leaves a
  plain tensor as it is; the CLI with ``--device cpu`` on one cell.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.cep import patterns as RPAT
from repro.cep import runner as RRUN
from repro.configs import registry as RR
from repro.configs import shapes as RSH
from repro.data import streams as RST
from repro.launch import roofline as RRF
from repro.models import transformer as RT
from repro_torch.cep import patterns as TPAT
from repro_torch.cep import runner as TRUN
from repro_torch.configs import registry as TR
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.data import streams as TST
from repro_torch.dist.mesh import abstract_mesh
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RF
from repro_torch.models import convert
from repro_torch.models import settings as SET
from repro_torch.training import train_step as TS
from repro_torch.training.tree import items

import _dryrun_reference as DRF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(RR.ARCH_IDS)
FAMILIES = ["internlm2-1.8b", "deepseek-moe-16b", "deepseek-v3-671b",
            "mamba2-1.3b", "zamba2-7b", "internvl2-76b", "whisper-small"]


@pytest.fixture(scope="module")
def reference_bytes(tmp_path_factory):
    """The reference's compiled argument bytes (started at once: the
    subprocess compiles while the tests before the ones that read it
    run)."""
    out = tmp_path_factory.mktemp("dryrun_ref") / "bytes.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_dryrun_reference.py"),
         "bytes", str(out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    holder = {}

    def read():
        if "v" not in holder:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-2000:]
            holder["v"] = json.loads(out.read_text())
        return holder["v"]
    yield read
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference_bytes):
    """Requests the fixture first so that the compile overlaps the rest."""


@pytest.fixture(scope="module")
def fake_world():
    """A fake process group for the module's DeviceMeshes, removed after
    it (other test modules in the worker see no process group)."""
    yield M
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Counts equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_analysis_depths_equal(arch):
    r = RRF.analysis_depths(RR.get_config(arch))
    t = RF.analysis_depths(TR.get_config(arch))
    assert r[2:] == t[2:]
    for rc, tc in zip(r[:2], t[:2]):
        assert (rc.num_layers, rc.enc_layers) == (tc.num_layers,
                                                   tc.enc_layers)


@pytest.mark.parametrize("scenario", ["stock", "soccer", "bus"])
def test_engine_block_intensity_equal(scenario):
    rsc, tsc = RST.get_scenario(scenario), TST.get_scenario(scenario)
    rcfg = RRUN.default_config(RPAT.compile_patterns(rsc.specs()),
                               max_pms=256, block_events=32)
    tcfg = TRUN.default_config(TPAT.compile_patterns(tsc.specs()),
                               max_pms=256, block_events=32)
    assert RF.engine_block_intensity(tcfg) == \
        RRF.engine_block_intensity(rcfg)


# ---------------------------------------------------------------------------
# The flash op
# ---------------------------------------------------------------------------

FLASH_SHAPES = [  # B, Sq, Sk, H, KVH, D, Dv, causal, q_offset
    (1, 2048, 2048, 4, 2, 16, 16, True, 0),
    (1, 1500, 1500, 2, 2, 16, 16, False, 0),     # whisper's ragged frames
    (1, 1500, 1500, 2, 1, 24, 16, True, 0),      # ragged causal, Dv != D
    (1, 96, 2048, 2, 2, 16, 8, True, 1952),      # a block at an offset
    (2, 40, 40, 4, 4, 8, 8, False, 0),
]


@pytest.mark.parametrize("chunks", [(512, 1024), (4096, 4096)])
@pytest.mark.parametrize("case", FLASH_SHAPES, ids=str)
def test_flash_formula_counts_the_plain_version(case, chunks):
    """FlopCounterMode over the op (its formula) equals FlopCounterMode
    over the plain version's own products, at the chunks in force."""
    B, Sq, Sk, H, KVH, D, Dv, causal, q_off = case
    q = torch.zeros((B, Sq, H, D))
    k = torch.zeros((B, Sk, KVH, D))
    v = torch.zeros((B, Sk, KVH, Dv))
    with kfa.use_chunks(*chunks):
        with FlopCounterMode(display=False) as plain:
            kfa.flash_attention_plain(q, k, v, causal=causal,
                                      q_offset=q_off, q_chunk=chunks[0],
                                      kv_chunk=chunks[1])
        with FlopCounterMode(display=False) as op:
            out = kfa.flash_attention(q, k, v, causal=causal,
                                      q_offset=q_off)
    assert out.shape == (B, Sq, H, Dv)
    assert op.get_total_flops() == plain.get_total_flops() > 0
    assert op.get_flop_counts()["Global"] == {
        torch.ops.repro_torch.flash_attention: plain.get_total_flops()}


def test_flash_op_fake_output_and_chunks():
    with FakeTensorMode():
        q = torch.empty((2, 64, 4, 192), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((2, 80, 4, 192), dtype=torch.bfloat16, device="cuda")
        v = torch.empty((2, 80, 4, 128), dtype=torch.bfloat16, device="cuda")
        out = kfa.flash_attention(q, k, v)
    assert out.shape == (2, 64, 4, 128) and out.dtype == torch.bfloat16
    assert out.device.type == "cuda"
    assert kfa.chunks() == SET.flash_chunks() == (512, 1024)
    with SET.analysis_mode():
        assert SET.flash_chunks() == (4096, 4096) and SET.loss_chunk() == 4096
    assert SET.loss_chunk() == 512


def test_flash_aligns_gqa_shards(fake_world):
    """Query heads sharded where the KV heads cannot be: the wrapper
    replicates the heads before the op, so no rank pairs a query head
    with another group's KV head."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = M.make_mesh((2, 2), ("data", "model"), "cpu")
    DR.register_rules()
    with FakeTensorMode():
        def dt(shape, pl):
            loc = list(shape)
            for md, p in enumerate(pl):
                if isinstance(p, Shard):
                    loc[p.dim] //= 2
            return DTensor.from_local(torch.empty(loc), mesh, pl,
                                      run_check=False, shape=shape,
                                      stride=torch.empty(shape,
                                                         device="meta")
                                      .stride())
        q = dt((4, 16, 6, 8), [Shard(0), Shard(2)])
        k = dt((4, 16, 1, 8), [Shard(0), Replicate()])
        aq, ak, av = kfa._align(q, k, k)
        assert tuple(aq.placements) == (Shard(0), Replicate())
        assert tuple(ak.placements) == (Shard(0), Replicate())
        k2 = dt((4, 16, 2, 8), [Shard(0), Shard(2)])
        assert tuple(kfa._align(q, k2, k2)[0].placements) == \
            (Shard(0), Shard(2))
        out = kfa.flash_attention(q, k, k)
    assert tuple(out.placements) == (Shard(0), Replicate())
    assert out.to_local().shape == (2, 16, 6, 8)


# ---------------------------------------------------------------------------
# The collective recorder
# ---------------------------------------------------------------------------

def test_collective_bytes_on_a_fake_mesh(fake_world):
    """Each kind's wire bytes by the ring factors on a group of 4: 512 B
    in, all-gather 512·3 (result 2048 × 3/4), all-reduce 512 × 2·3/4,
    reduce-scatter result 128 × 3, all-to-all 512 × 3/4."""
    mesh = M.make_mesh((4,), ("data",), "cpu")
    name = mesh.get_group(0).group_name
    rec = HA.TraceRecorder("cpu")
    ops = torch.ops._c10d_functional
    with FakeTensorMode():
        t = torch.empty((8, 16))
        with rec:
            ops.wait_tensor(ops.all_gather_into_tensor(t, 4, name))
            ops.wait_tensor(ops.all_reduce(t, "sum", name))
            ops.wait_tensor(ops.reduce_scatter_tensor(t, "sum", 4, name))
            ops.wait_tensor(ops.all_to_all_single(t, [2] * 4, [2] * 4,
                                                  name))
    assert rec.coll.bytes_by_kind == {
        "all-gather": 1536.0, "all-reduce": 768.0, "reduce-scatter": 384.0,
        "all-to-all": 384.0, "collective-permute": 0.0}
    assert rec.coll.count_by_kind == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
        "all-to-all": 1, "collective-permute": 0}
    assert rec.coll.total_bytes == 3072.0
    assert rec.flops == 0 and rec.bytes == 0


def test_collective_stats_algebra():
    a = HA.CollectiveStats.empty()
    a.bytes_by_kind["all-gather"], a.count_by_kind["all-gather"] = 10.0, 1
    b = a.scaled(3.0)
    assert b.bytes_by_kind["all-gather"] == 30.0
    assert b.minus(a).bytes_by_kind["all-gather"] == 20.0
    assert a.plus(b).total_bytes == 40.0
    assert a.minus(b).bytes_by_kind["all-gather"] == 0.0


# ---------------------------------------------------------------------------
# A world of one on the CPU, and every family on a fake (2, 2) mesh
# ---------------------------------------------------------------------------

def _smoke(arch, layers=None):
    cfg = TR.get_smoke_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers, **(
            {"enc_layers": layers} if cfg.enc_dec else {}))
    return cfg


WORLD_ONE = [("internlm2-1.8b", ShapeSpec("p", "prefill", 64, 2)),
             ("internlm2-1.8b", ShapeSpec("d", "decode", 80, 2)),
             ("internlm2-1.8b", ShapeSpec("t", "train", 64, 2)),
             ("deepseek-moe-16b", ShapeSpec("p", "prefill", 64, 2)),
             ("mamba2-1.3b", ShapeSpec("p", "prefill", 64, 2))]


def _real_args(cfg, shape):
    """The step's arguments as real CPU tensors (weights from a seed)."""
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    structs, _ = DR.step_inputs(cfg, shape, abstract_mesh((1, 1), (
        "data", "model")))
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)

    def tokens(t):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, t.shape)
                                .astype(np.int32))
    if shape.kind == "decode":
        return {"params": D.decode_weights(cfg, params),
                "cache": D.init_cache(cfg, shape.global_batch,
                                      shape.seq_len, device="cpu"),
                "tokens": tokens(structs["tokens"])}
    batch = {k: tokens(v) if v.dtype == torch.int32 else
             torch.zeros(v.shape, dtype=v.dtype)
             for k, v in structs["batch"].items()}
    out = {"params": params, "batch": batch}
    if shape.kind == "train":
        out["opt"] = O.init_opt_state(params)
    return out


@pytest.mark.parametrize("arch,shape", WORLD_ONE,
                         ids=lambda x: getattr(x, "kind", x))
def test_world_of_one_trace_counts_the_real_step(fake_world, arch, shape):
    cfg = _smoke(arch)
    mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
    args = _real_args(cfg, shape)
    real_bytes = sum(t.numel() * t.element_size()
                     for _, t in items(args))
    assert DR.argument_bytes(cfg, shape, mesh) == real_bytes
    with FlopCounterMode(display=False) as fc:
        DR.run_step(cfg, shape, args)
    rec = DR.trace_step(cfg, shape, mesh, device="cpu")
    assert rec.flops == fc.get_total_flops() > 0
    assert rec.peak >= real_bytes and rec.coll.total_bytes == 0
    # The roofline's two depths, extrapolated, equal the full depth.
    c1, c2, l1, l2, lt = RF.analysis_depths(cfg)
    with SET.analysis_mode():
        full = DR.trace_step(cfg, shape, mesh, device="cpu")
    rf = RF.roofline_cell(cfg, shape, mesh, 1, device="cpu")
    assert rf.flops == full.flops and rf.bytes_accessed == full.bytes
    assert rf.dominant in ("compute", "memory")
    one = HA.analyze(full, 1, DR.model_flops(cfg, shape))
    assert (one.flops, one.bytes_accessed, one.per_device_mem) == (
        full.flops, full.bytes, full.peak)
    assert one.useful_ratio == DR.model_flops(cfg, shape) / full.flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_traces_on_a_fake_mesh(fake_world, arch, kind):
    cfg = _smoke(arch)
    S = 48 if cfg.vlm_patches else 32
    shape = ShapeSpec(kind, kind, S, 4)
    mesh = M.make_mesh((2, 2), ("data", "model"), "cpu")
    rec = DR.trace_step(cfg, shape, mesh, device="cpu")
    assert rec.flops > 0 and rec.bytes > 0 and rec.peak > 0
    assert rec.peak >= DR.argument_bytes(cfg, shape, mesh)


def test_memory_is_not_counted_for_structures():
    rec = HA.TraceRecorder("cuda")
    with FakeTensorMode():
        with rec:
            torch.empty((1000,), device="meta")
            t = torch.empty((1000,), device="cpu")
            u = t + 1
            assert rec.live == 2 * 4096
            del t, u
    assert rec.peak == 2 * 4096 and rec.live == 0


# ---------------------------------------------------------------------------
# remat, constrain, the CLI
# ---------------------------------------------------------------------------

# The families whose remat=False gradients are also held to the
# reference's remat=True ones here (tests/test_torch_training.py holds
# every family's remat=True gradients to them).
REMAT_REFERENCE = ("internlm2-1.8b", "deepseek-v3-671b", "whisper-small")


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_equals_no_remat_and_the_reference(arch):
    rcfg = RR.get_smoke_config(arch)
    tcfg = TR.get_smoke_config(arch)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        "cpu")
    rng = np.random.default_rng(3)
    s_text = 32 - rcfg.vlm_patches
    nb = {"tokens": rng.integers(0, rcfg.vocab_size, (2, s_text)),
          "labels": rng.integers(0, rcfg.vocab_size, (2, s_text))}
    nb = {k: v.astype(np.int32) for k, v in nb.items()}
    if rcfg.vlm_patches:
        nb["patches"] = (rng.standard_normal(
            (2, rcfg.vlm_patches, rcfg.d_model)) * 0.1).astype(np.float32)
    if rcfg.enc_dec:
        nb["frames"] = rng.standard_normal(
            (2, rcfg.enc_frames, rcfg.d_model)).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    on = TS.loss_and_grads(tcfg, tparams, tb, remat=True)
    off = TS.loss_and_grads(tcfg, tparams, tb, remat=False)
    assert torch.equal(on[0], off[0])
    g_on, g_off = dict(items(on[2])), dict(items(off[2]))
    assert g_on.keys() == g_off.keys()
    assert all(torch.equal(g_on[k], g_off[k]) for k in g_on)
    if arch not in REMAT_REFERENCE:
        return
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: RT.forward_train(rcfg, p, {k: jnp.asarray(v)
                                             for k, v in nb.items()},
                                   remat=True), has_aux=True)(rparams)
    assert abs(float(off[0]) - float(rloss)) <= 1e-5 * abs(float(rloss))
    rg = {"/".join(map(str, p)): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(rgrads)[0]
          for p in [[getattr(k, "key", k) for k in p]]}
    for k, g in g_off.items():
        want = rg["/".join(map(str, k))]
        err = float(np.abs(g.numpy() - want).max()) / (
            float(np.abs(want).max()) + 1e-30)
        assert err <= 1e-4, (k, err)


def test_constrain_leaves_a_plain_tensor_as_it_is(fake_world):
    x = torch.randn(4, 6)
    assert SET.constrain(x, "data", "model") is x
    mesh = M.make_mesh((2, 2), ("data", "model"), "cpu")
    with SET.use_mesh(mesh):
        assert SET.constrain(x, "data", "model") is x
        assert SET.gather_weights({"w": x})["w"] is x
    assert SET.active_mesh() is None


def test_cli_on_one_cell_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "decode_32k", "--device", "cpu",
         "--json", str(out)], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    row = json.loads(out.read_text().splitlines()[-1])
    assert row["status"] == "ok" and row["chips"] == 256
    assert row["memory_analysis"]["argument_gb"] == 2083065876 / 1e9
    assert row["flops"] > 0 and row["dominant"] in ("compute", "memory",
                                                    "collective")


# ---------------------------------------------------------------------------
# Argument bytes against the reference's compiled steps (last: the
# reference's compile has run meanwhile)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(DRF.MESHES))
@pytest.mark.parametrize("arch,shape", DRF.BYTES_CELLS,
                         ids=lambda x: str(x))
def test_argument_bytes_equal_the_compiled_reference(reference_bytes, arch,
                                                     shape, mesh):
    want = reference_bytes()[f"{arch}|{shape}|{mesh}"]
    got = DR.argument_bytes(TR.get_config(arch), SHAPES[shape],
                            abstract_mesh(DRF.MESHES[mesh],
                                          ("data", "model")))
    assert got == want
    if (arch, shape) == ("internlm2-1.8b", "decode_32k"):
        assert want == {"16x16": 2035683364, "32x8": 2083065876}[mesh]


@pytest.mark.parametrize("shape", list(RSH.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal(reference_bytes, arch, shape):
    """The reference's (computed in the subprocess: its dryrun module
    forces 512 host devices when imported)."""
    assert DR.model_flops(TR.get_config(arch), SHAPES[shape]) == \
        reference_bytes()[f"flops|{arch}|{shape}"]
