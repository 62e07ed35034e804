"""The model half of the port's sharding specs against the reference's.

* ``configs.shapes`` (``SHAPES``, ``applicable``) and
  ``registry.input_specs`` (shapes and dtypes, cache leaves included) for
  all 10 architectures × 4 shapes.
* ``param_specs`` (schemes tp, fsdp, moe2d), ``batch_axes``,
  ``batch_specs``, ``cache_specs``, ``train_specs`` and ``decode_specs``
  tuple-equal to the reference's ``PartitionSpec``s for the 10 full
  configs on the (16, 16), (32, 8), (2, 16, 16) and (2, 32, 8) meshes
  (abstract meshes: the specs need no device); the reference's own
  ``TestParamSpecs`` / ``TestBatchAndCacheSpecs`` cases on the port.
* DTensor placements (``dist.sharding.placements``) and the port's shard
  slices give every mesh coordinate the shard jax's
  ``devices_indices_map`` gives it on a (4, 4) and a (2, 2, 2) mesh, tuple
  entries included (the reference on 256 forced host devices in a
  subprocess, ``tests/_dryrun_reference.py``).
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as RR
from repro.configs import shapes as RSH
from repro.dist import sharding as RS
from repro.models import transformer as RT
from repro.training import optimizer as RO
from repro_torch.configs import registry as TR
from repro_torch.configs import shapes as TSH
from repro_torch.dist import sharding as TS
from repro_torch.dist.mesh import abstract_mesh
from repro_torch.launch import mesh as TM
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as TO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(RR.ARCH_IDS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "32x8": ((32, 8), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x32x8": ((2, 32, 8), ("pod", "data", "model"))}
SCHEMES = ("tp", "fsdp", "moe2d")
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}


def _ref_mesh(key):
    return RS.abstract_mesh(*MESHES[key])


def _port_mesh(key):
    return abstract_mesh(*MESHES[key])


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = RR.get_config(arch)
    return jax.eval_shape(lambda: RT.init_params(cfg, jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return TT.param_structs(TR.get_config(arch))


def _leaves(tree, path=()):
    """{path: leaf} of a dict tree whose leaves are arrays, structures or
    specs (a PartitionSpec or a spec tuple is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _tup(spec):
    """A reference PartitionSpec as the port's spec tuple."""
    return tuple(spec)


def _specs_equal(ref_tree, port_tree):
    r, t = _leaves(ref_tree), _leaves(port_tree)
    assert r.keys() == t.keys()
    bad = {k: (_tup(r[k]), t[k]) for k in r if _tup(r[k]) != t[k]}
    assert not bad, bad


def test_shapes_and_applicable_equal():
    assert {k: (s.name, s.kind, s.seq_len, s.global_batch)
            for k, s in RSH.SHAPES.items()} == \
        {k: (s.name, s.kind, s.seq_len, s.global_batch)
         for k, s in TSH.SHAPES.items()}
    for arch in ARCHS:
        for name in RSH.SHAPES:
            assert RSH.applicable(RR.get_config(arch), RSH.SHAPES[name]) == \
                TSH.applicable(TR.get_config(arch), TSH.SHAPES[name])
    assert TR.SHAPES is TSH.SHAPES


@pytest.mark.parametrize("shape", list(RSH.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal(arch, shape):
    ref = RR.input_specs(RR.get_config(arch), RSH.SHAPES[shape])
    got = TR.input_specs(TR.get_config(arch), TSH.SHAPES[shape])
    r, t = _leaves(ref), _leaves(got)
    assert r.keys() == t.keys()
    for k in r:
        assert tuple(r[k].shape) == tuple(t[k].shape), k
        assert DTYPES[jnp.dtype(r[k].dtype)] == t[k].dtype, k
        assert t[k].device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_structures_equal(arch):
    r, t = _leaves(_ref_params(arch)), _leaves(_port_params(arch))
    assert r.keys() == t.keys()
    for k in r:
        assert tuple(r[k].shape) == tuple(t[k].shape), k
        assert DTYPES[jnp.dtype(r[k].dtype)] == t[k].dtype, k


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal(arch, scheme, mesh):
    ref = RS.param_specs(_ref_mesh(mesh), RR.get_config(arch),
                         _ref_params(arch), scheme=scheme)
    got = TS.param_specs(_port_mesh(mesh), TR.get_config(arch),
                         _port_params(arch), scheme=scheme)
    _specs_equal(ref, got)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_train_decode_specs_equal(arch, mesh):
    rm, tm = _ref_mesh(mesh), _port_mesh(mesh)
    rcfg, tcfg = RR.get_config(arch), TR.get_config(arch)
    for name, shape in RSH.SHAPES.items():
        rb = RR.input_specs(rcfg, shape)
        tb = TR.input_specs(tcfg, TSH.SHAPES[name])
        for scheme in SCHEMES:
            assert RS.batch_axes(rm, shape.global_batch, scheme) == \
                TS.batch_axes(tm, shape.global_batch, scheme)
            if shape.kind != "decode":
                _specs_equal(RS.batch_specs(rm, rcfg, rb, scheme),
                             TS.batch_specs(tm, tcfg, tb, scheme))
        if shape.kind == "decode":
            _specs_equal(RS.cache_specs(rm, rcfg, rb["cache"]),
                         TS.cache_specs(tm, tcfg, tb["cache"]))
            rtok, rlog = RS.decode_specs(rm, rcfg, shape.global_batch)
            ttok, tlog = TS.decode_specs(tm, tcfg, shape.global_batch)
            assert (_tup(rtok), _tup(rlog)) == (ttok, tlog)
        if shape.kind == "train":
            rp, ro, rbs = RS.train_specs(rm, rcfg, _ref_params(arch), rb)
            tp, to, tbs = TS.train_specs(tm, tcfg, _port_params(arch), tb)
            _specs_equal({"p": rp, "o": ro, "b": rbs},
                         {"p": tp, "o": to, "b": tbs})
    assert TS.spec(tm, (256, 48), "data", "model") == _tup(
        RS.spec(rm, (256, 48), "data", "model"))


def test_optimizer_structures_mirror_the_params():
    ro = jax.eval_shape(RO.init_opt_state, _ref_params("internlm2-1.8b"))
    to = TO.init_opt_state(_port_params("internlm2-1.8b"))
    r, t = _leaves(ro), _leaves(to)
    assert r.keys() == t.keys()
    for k in r:
        assert tuple(r[k].shape) == tuple(t[k].shape)
        assert DTYPES[jnp.dtype(r[k].dtype)] == t[k].dtype
        assert t[k].device.type == "meta"


# The reference's own spec tests (tests/test_sharding.py) on the port, on
# the reference's (16, 16) production mesh.
@pytest.fixture(scope="module")
def mesh():
    return _port_mesh("16x16")


def _specs_for(arch, mesh):
    cfg = TR.get_config(arch)
    return cfg, _port_params(arch), TS.param_specs(mesh, cfg,
                                                   _port_params(arch))


class TestParamSpecs:
    def test_dense_attention_head_sharded(self, mesh):
        cfg, params, specs = _specs_for("starcoder2-15b", mesh)
        assert specs["layers"]["attn"]["wq"] == (None, None, "model", None)
        # kv heads = 4 < 16 → replicated
        assert specs["layers"]["attn"]["wk"] == (None, None, None, None)
        assert specs["layers"]["mlp"]["wi"] == (None, None, "model")

    def test_minitron_falls_back_to_replicated_attention(self, mesh):
        cfg, params, specs = _specs_for("minitron-4b", mesh)
        assert specs["layers"]["attn"]["wq"] == (None, None, None, None)
        assert specs["layers"]["mlp"]["wi"] == (None, None, "model")

    def test_fsdp_shards_over_data_too(self, mesh):
        cfg, params, specs = _specs_for("qwen1.5-110b", mesh)
        assert specs["layers"]["mlp"]["wi"] == (None, "data", "model")
        assert specs["embed"] == ("model", "data")

    def test_moe_experts_on_model_axis(self, mesh):
        cfg, params, specs = _specs_for("deepseek-moe-16b", mesh)
        assert specs["layers"]["moe"]["wi"] == (None, "model", None, None)
        assert specs["layers"]["moe"]["router"] == (None, None, "model")

    def test_mamba_channels_sharded(self, mesh):
        cfg, params, specs = _specs_for("mamba2-1.3b", mesh)
        assert specs["layers"]["mamba"]["wz"] == (None, None, "model")
        assert specs["layers"]["mamba"]["wB"] == (None, None, None)

    def test_every_leaf_divisible(self, mesh):
        """Property: every sharded dim divides evenly over its axes."""
        for arch in TR.ARCH_IDS:
            cfg, params, specs = _specs_for(arch, mesh)
            flat_p, flat_s = _leaves(params), _leaves(specs)
            for k, leaf in flat_p.items():
                for dim, ax in zip(leaf.shape, flat_s[k]):
                    if ax is None:
                        continue
                    axes = (ax,) if isinstance(ax, str) else ax
                    size = 1
                    for a in axes:
                        size *= dict(zip(mesh.mesh_dim_names,
                                         mesh.shape))[a]
                    assert dim % size == 0, (arch, leaf.shape, flat_s[k])


class TestBatchAndCacheSpecs:
    def test_batch_axes_fallback(self, mesh):
        assert TS.batch_axes(mesh, 256) == ("data",)
        assert TS.batch_axes(mesh, 1) is None

    def test_multipod_batch_axes(self):
        mp = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
        assert TS.batch_axes(mp, 256) == ("pod", "data")
        assert TS.batch_axes(mp, 16) == ("data",)

    def test_cache_sequence_sharded_over_model(self, mesh):
        from repro_torch.models import decode as D
        cfg = TR.get_config("starcoder2-15b")
        specs = TS.cache_specs(mesh, cfg, D.cache_structs(cfg, 128, 32768))
        assert specs["k"] == (None, "data", "model", None, None)
        assert specs["pos"] == ()


def test_production_topology_is_the_h100_cluster():
    assert TM.production_topology() == ((32, 8), ("data", "model"))
    assert TM.production_topology(multi_pod=True) == (
        (2, 32, 8), ("pod", "data", "model"))
    m = TM.make_abstract_production_mesh(multi_pod=True)
    assert m.size() == 512 and m.mesh_dim_names == ("pod", "data", "model")
    assert (TM.PEAK_FLOPS_BF16, TM.HBM_BW, TM.COLL_BW_PER_GPU) == (
        989e12, 3.35e12, 50e9)
    # Without a process group the host mesh is the world of one.
    assert TM.make_host_mesh() == abstract_mesh((1,), ("data",))


# ---------------------------------------------------------------------------
# Shards against jax's devices_indices_map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_indices(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref") / "indices.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(ROOT, "tests",
                                                 "_dryrun_reference.py"),
                    "indices", str(out)], check=True, env=env, cwd=ROOT,
                   timeout=300)
    return json.loads(out.read_text())


def _index_cases():
    import _dryrun_reference as DRF
    return [(key, i) for key, (_, _, cases) in DRF.INDEX_CASES.items()
            for i in range(len(cases))]


@pytest.mark.parametrize("key,i", _index_cases())
def test_shards_equal_jax_devices_indices_map(jax_indices, key, i):
    """Every coordinate's shard: the port's slices and DTensor's own
    offsets for the placements equal jax's."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)
    import _dryrun_reference as DRF
    shape, names, cases = DRF.INDEX_CASES[key]
    tshape, spec = cases[i]
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    mesh = abstract_mesh(shape, names)
    pl = TS.placements(mesh, spec)
    assert TS.placements_tree(mesh, {"t": {"x": spec}}) == {"t": {"x": pl}}
    rows = jax_indices[key][i]
    assert len(rows) == mesh.size()
    for coord, want in rows:
        want = tuple(tuple(w) for w in want)
        assert TS.shard_slices(mesh, tshape, spec, coord) == want
        local, off = _compute_local_shape_and_global_offset(
            tshape, shape, list(coord), pl)
        assert tuple((o, o + n) for o, n in zip(off, local)) == want
