"""``launch.train`` and ``launch.serve`` over a mesh of several ranks.

Gloo worlds of 2 and 4 CPU ranks (``dist.spawn``, the rank functions in
``tests/_dist_worlds.py``) run the entry points on a "data" mesh, as
the reference runs them over its host mesh's specs:

* ``train_loop`` on DTensors laid out by ``dist.sharding.train_specs``:
  internlm2's smoke config (params replicated) and qwen1.5-110b's with
  ``fsdp=True`` (params sharded over "data": local shapes halved or
  quartered as the specs say).  Each step's loss, gradient norm and
  params within 1e-5 of their max against the port's one-process run
  and the reference's ``--no-shard`` run (its jitted step) on the same
  weights and batches, float32: the all-reduce sums in another order.
* The NaN restore and a resume from disk on a mesh, bit for bit against
  the same mesh's uninterrupted run; the mesh's checkpoint written by
  rank 0 alone, byte for byte the files one process writes of the same
  state, and read by the reference's ``checkpoint.restore``.
* ``serve`` on 2 ranks: the scheduler's decisions equal to the
  one-process run at one step cost, one step cost (rank 0's) on every
  rank, and a decode step's gathered logits within 1e-5 of the
  one-process ``decode_step``.
* The CLIs: ``torchrun`` worlds of 2 CPU ranks; ``--no-shard`` the
  one-process run; a card needed unless told ``--device cpu``.
"""
import filecmp
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.launch import train as RLT
from repro.models import transformer as RT
from repro.training import checkpoint as RCK
from repro.training import optimizer as RO
from repro.training import train_step as RTS
from repro_torch import dist as D
from repro_torch.dist import sharding as SH
from repro_torch.launch import serve as LS
from repro_torch.launch import train as TLT
from repro_torch.models import convert
from repro_torch.training import checkpoint as CK
from repro_torch.training import optimizer as O
from repro_torch.training.tree import items

import _dist_worlds as W

TOL = 1e-5                  # of each quantity's max, float32
BATCH, SEQ, STEPS = 4, 32, 3
# eps 1e-3, as tests/test_torch_training.py's one step against the
# reference: Adam's first steps move each weight by about lr·sign(g), so
# at the default eps a gradient near 1e-8 turns its rounding (here the
# all-reduce's order of summation) into a whole step of lr.
OPT = dict(lr=1e-3, warmup_steps=10, eps=1e-3)
# (arch, fsdp): params replicated over "data", and sharded over it.
CASES = [("internlm2-1.8b", False), ("qwen1.5-110b", True)]
WORLDS = [2, 4]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-30)


def _ref_params(arch):
    return jax.tree.map(np.asarray, RT.init_params(
        RR.get_smoke_config(arch), jax.random.PRNGKey(0)))


def _reference_run(arch, np_params) -> dict:
    """The reference's ``--no-shard`` run: its jitted train step (remat,
    as its CLI) over its synthetic batches."""
    rcfg = RR.get_smoke_config(arch)
    step = jax.jit(RTS.make_train_step(rcfg, RO.AdamWConfig(**OPT),
                                       remat=True))
    params = jax.tree.map(jax.numpy.asarray, np_params)
    opt = RO.init_opt_state(params)
    out = {"losses": [], "grad_norms": [], "params": []}
    for s in range(STEPS):
        params, opt, m = step(params, opt,
                              RLT.synthetic_batch(rcfg, BATCH, SEQ, s))
        out["losses"].append((s, float(m["loss"])))
        out["grad_norms"].append((s, float(m["grad_norm"])))
        out["params"].append({
            "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
    return out


def _one_process_run(arch, fsdp, np_params) -> dict:
    cfg = W._model_cfg(arch, fsdp)
    params = convert.params_from_numpy(np_params, "cpu")
    state = (params, O.init_opt_state(params))
    out = {"losses": [], "grad_norms": [], "params": []}
    for s in range(STEPS):
        run = TLT.train_loop(cfg, *state, steps=s + 1, start=s, batch=BATCH,
                             seq=SEQ, opt_cfg=O.AdamWConfig(**OPT),
                             device="cpu", log=lambda x: None)
        state = (run["params"], run["opt"])
        out["losses"] += run["losses"]
        out["grad_norms"] += run["grad_norms"]
        out["params"].append({"/".join(map(str, p)): t.numpy()
                              for p, t in items(run["params"])})
    return out


@pytest.fixture(scope="module")
def truth():
    """Per case, the reference's ``--no-shard`` run and the port's
    one-process run on the reference's weights."""
    out = {}
    for arch, fsdp in CASES:
        np_params = _ref_params(arch)
        out[arch] = (np_params, _reference_run(arch, np_params),
                     _one_process_run(arch, fsdp, np_params))
    return out


@pytest.fixture(scope="module")
def mesh_runs(truth):
    """Per (arch, world size), every rank's ``train_world``."""
    return {(arch, n): D.spawn(W.train_world, n, args=(
        arch, fsdp, truth[arch][0], STEPS, BATCH, SEQ, OPT),
        timeout=W.WORLD_TIMEOUT) for arch, fsdp in CASES for n in WORLDS}


def _close(got: dict, want: dict, what: str) -> None:
    assert [s for s, _ in got["losses"]] == list(range(STEPS))
    for key in ("losses", "grad_norms"):
        for (s, x), (_, y) in zip(got[key], want[key]):
            assert abs(x - y) <= TOL * abs(y), (what, key, s, x, y)
    for s, (gp, wp) in enumerate(zip(got["params"], want["params"])):
        assert gp.keys() == wp.keys()
        bad = {k: _rel(gp[k], wp[k]) for k in wp
               if not _rel(gp[k], wp[k]) <= TOL}
        assert not bad, (what, s, bad)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch,fsdp", CASES)
def test_mesh_train_equals_one_process_and_reference(truth, mesh_runs, arch,
                                                     fsdp, n):
    _, ref, one = truth[arch]
    ranks = mesh_runs[(arch, n)]
    for r, got in enumerate(ranks):
        _close(got, one, f"rank {r} of {n} vs one process")
        _close(got, ref, f"rank {r} of {n} vs the reference's --no-shard")
    # Every rank holds the same whole params and the same losses.
    for got in ranks[1:]:
        assert got["losses"] == ranks[0]["losses"]
        for a, b in zip(got["params"], ranks[0]["params"]):
            assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch,fsdp", CASES)
def test_local_shapes_follow_train_specs(truth, mesh_runs, arch, fsdp, n):
    cfg = W._model_cfg(arch, fsdp)
    mesh = D.abstract_mesh((n,), ("data",))
    params = convert.params_from_numpy(truth[arch][0], "cpu")
    specs = SH.param_specs(mesh, cfg, params)
    for got in mesh_runs[(arch, n)]:
        sharded = 0
        for path, t in items(params):
            key = "/".join(map(str, path))
            spec = specs
            for k in path:
                spec = spec[k]
            local, placements = got["local"][key]
            assert local == SH.local_shape(mesh, tuple(t.shape), spec), key
            sharded += local != tuple(t.shape)
            if local != tuple(t.shape):
                assert placements != ["Replicate()"]
                assert np.prod(local) * n == t.numel(), key
        # FSDP shards every matrix over "data"; without it, none.
        assert (sharded > 0) == fsdp, sharded


@pytest.fixture(scope="module", params=[(c, n) for c in CASES
                                        for n in WORLDS],
                ids=lambda p: f"{p[0][0]}-{p[1]}")
def nan_run(request, tmp_path_factory):
    (arch, fsdp), n = request.param
    d = tmp_path_factory.mktemp("mesh-ckpt")
    ranks = D.spawn(W.nan_resume_world, n, args=(
        arch, fsdp, str(d / "ck"), BATCH, SEQ, OPT), timeout=W.WORLD_TIMEOUT)
    return arch, fsdp, n, d, ranks


def test_nan_restore_and_resume_bitwise_on_the_mesh(nan_run):
    _, _, n, _, ranks = nan_run
    for got in ranks:
        assert got["kept"] == [0, 1, 2, 4, 5] and got["saved"] == [2, 6]
        assert got["restores"] == [(2, True)]
        assert got["nan_equals_clean"]
        assert got["resume_step"] == 6 and got["resume_equals_memory"]
    for got in ranks[1:]:
        assert all(np.array_equal(got["state6"][k], ranks[0]["state6"][k])
                   for k in ranks[0]["state6"])


def test_mesh_checkpoint_is_the_one_process_files(nan_run, tmp_path):
    arch, fsdp, n, d, ranks = nan_run
    # Rank 0 alone wrote each generation.
    assert ranks[0]["writes"] == [2, 6]
    assert all(got["writes"] == [] for got in ranks[1:])
    # One process writing the same state writes the same bytes.
    state = {}
    for key, a in ranks[0]["state6"].items():
        node = state
        *head, leaf = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(a)
    CK.save(str(tmp_path), 6, state)
    mesh_dir = d / "ck" / "step_00000006"
    names = sorted(os.listdir(mesh_dir))
    assert names == sorted(os.listdir(tmp_path / "step_00000006"))
    match, mismatch, errors = filecmp.cmpfiles(
        mesh_dir, tmp_path / "step_00000006", names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)
    # The reference reads it.
    got = RCK.restore(str(d / "ck"), jax.tree.map(np.asarray, state))
    flat = {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat.keys() == ranks[0]["state6"].keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(v, ranks[0]["state6"][k])


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

SERVE_ARCH, SERVE_COST, SERVE_REQUESTS = "internlm2-1.8b", 0.02, 64


@pytest.fixture(scope="module")
def serve_runs():
    np_params = _ref_params(SERVE_ARCH)
    ranks = D.spawn(W.serve_world, 2, args=(
        SERVE_ARCH, np_params, SERVE_COST, SERVE_REQUESTS, 3, 3),
        timeout=W.WORLD_TIMEOUT)
    return np_params, ranks


def test_serve_on_the_mesh_decides_as_one_process(serve_runs):
    np_params, ranks = serve_runs
    cfg = W._model_cfg(SERVE_ARCH, False)
    params = convert.params_from_numpy(np_params, "cpu")
    one = LS.serve(cfg, params, requests=SERVE_REQUESTS,
                   step_cost=SERVE_COST, device="cpu", log=lambda s: None)
    assert one["finished"] == SERVE_REQUESTS
    for got in ranks:
        assert got["fixed"]["metrics"] == one["metrics"]
        assert got["fixed"]["finished"] == one["finished"]
        assert got["fixed"]["decode_steps"] == one["decode_steps"]
    # One step cost, rank 0's measurement, on every rank; and at it every
    # rank decides alike.
    cost = ranks[0]["measured"]["measured"]
    assert cost > 0
    for got in ranks:
        assert got["measured"]["step_cost"] == cost
        assert got["measured"]["metrics"] == ranks[0]["measured"]["metrics"]


def test_serve_mesh_decode_logits_equal_one_process(serve_runs):
    np_params, ranks = serve_runs
    cfg = W._model_cfg(SERVE_ARCH, False)
    want = W.decode_logits(cfg, convert.params_from_numpy(np_params, "cpu"),
                           3, 3)
    assert np.isfinite(want).all()
    for got in ranks:
        assert got["logits"].shape == want.shape
        assert _rel(got["logits"], want) <= TOL


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _torchrun(module: str, args: list, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(W.HERE.parent / "src")] + os.environ.get(
            "PYTHONPATH", "").split(os.pathsep)), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module] + args,
        env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=W.WORLD_TIMEOUT)


def test_train_cli_under_torchrun_joins_the_world(tmp_path):
    """Two ranks started by ``torchrun``: the world joined through
    ``env://``, one log (rank 0's), a checkpoint within 1e-5 of the
    one-process CLI's."""
    args = ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "4",
            "--seq", "32", "--ckpt-every", "2"]
    run = _torchrun("repro_torch.launch.train",
                    args + ["--ckpt-dir", str(tmp_path / "mesh")], tmp_path)
    assert run.returncode == 0, run.stderr[-4000:]
    lines = [x for x in run.stdout.splitlines() if "loss" in x]
    assert [x.split()[2] for x in lines] == ["0", "1", "2", "3"], run.stdout
    assert TLT.main(args + ["--no-shard", "--ckpt-dir",
                            str(tmp_path / "one")]) == 0
    cfg = W._model_cfg("internlm2-1.8b", False)
    like = TLT.T.init_params(cfg, seed=0, device="cpu")
    like = {"params": like, "opt": O.init_opt_state(like)}
    a = dict(items(CK.restore(str(tmp_path / "mesh"), like)))
    b = dict(items(CK.restore(str(tmp_path / "one"), like)))
    assert sorted(os.listdir(tmp_path / "mesh")) == ["step_00000002",
                                                     "step_00000004"]
    for k in b:
        assert _rel(a[k].numpy(), b[k].numpy()) <= TOL, k


def test_serve_cli_under_torchrun_joins_the_world(tmp_path):
    run = _torchrun("repro_torch.launch.serve",
                    ["--device", "cpu", "--requests", "16"], tmp_path)
    assert run.returncode == 0, run.stderr[-4000:]
    done = [x for x in run.stdout.splitlines() if "policy=pspice" in x]
    assert len(done) == 1, run.stdout       # rank 0 logs, once
    assert "measured decode_step cost" in run.stdout


def test_no_shard_is_the_one_process_run(tmp_path, monkeypatch):
    """``--no-shard`` writes the files the default writes without a world
    (one process both), and refuses a world of several ranks."""
    args = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "32", "--ckpt-every", "3"]
    assert TLT.main(args + ["--no-shard", "--ckpt-dir",
                            str(tmp_path / "a")]) == 0
    assert TLT.main(args + ["--ckpt-dir", str(tmp_path / "b")]) == 0
    a, b = tmp_path / "a" / "step_00000003", tmp_path / "b" / "step_00000003"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert filecmp.cmpfiles(a, b, names, shallow=False)[0] == names
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="one process"):
        TLT.main(args + ["--no-shard"])


def test_mesh_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LS.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        TLT.main(["--smoke", "--steps", "1", "--no-shard"])
    cfg = W._model_cfg("internlm2-1.8b", False)
    params = TLT.T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LS.serve(cfg, params, requests=1, step_cost=0.01)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.mesh._mesh_device("cuda")
