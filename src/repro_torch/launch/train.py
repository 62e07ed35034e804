"""Fault-tolerant training driver (port of ``repro.launch.train``).

  - the train step (loss -> grads -> clip -> AdamW), on one card or as
    SPMD ranks over the host mesh (``launch.mesh.make_host_mesh``: the
    world ``torchrun`` or ``dist.spawn`` started, on one "data" dim);
  - step-tagged atomic checkpoints + keep-last-k (``training/checkpoint``;
    on a mesh rank 0 writes the reference's files);
  - a non-finite loss restores the last checkpoint and skips the batch
    (``--inject-nan-at`` plants one);
  - crash-resume: rerunning the command continues from the latest step;
  - a deterministic batch per step (``synthetic_batch``, the reference's
    bit for bit), so a restarted run re-derives exactly its data; on a
    mesh each rank cuts its rows from the global batch.

Each layer is rematerialised (``remat=True``, as the reference's CLI
runs).  On a mesh (the default where the world has several ranks) the
params, AdamW state and each batch are DTensors laid out by
``dist.sharding.train_specs`` — the reference's in/out shardings — and
the step runs on them under ``settings.use_mesh``; ``--no-shard`` runs
the one-process path.  The data-parallel path with compressed gradient
sync is ``training.compression.sync_tree`` over a process group of
``dist.mesh``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --steps 50 --batch 8 --seq 256 --smoke --ckpt-dir /tmp/ckpt \\
      [--device cpu] [--no-shard]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --smoke --steps 6 --batch 4 --seq 64 [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.dist.mesh import AbstractMesh, mesh_rank
from repro_torch.launch import mesh as M
from repro_torch.models import settings as SET
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as CK
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step


def synthetic_batch(cfg, batch: int, seq: int, step: int, seed: int = 0,
                    device=None) -> dict:
    """Deterministic per-step batch, the reference's: a learnable
    synthetic language of arithmetic token ramps (+ zero patch and frame
    stubs)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed * 1_000_003 + step)
    s_text = seq - cfg.vlm_patches if cfg.vlm_patches else seq
    base = rng.integers(0, cfg.vocab_size - 1, size=(batch, 1))
    ramp = (base + np.arange(s_text + 1)[None, :] * 7) % (cfg.vocab_size - 1)
    as_i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    out = {"tokens": as_i32(ramp[:, :-1]), "labels": as_i32(ramp[:, 1:])}
    if cfg.vlm_patches:
        out["patches"] = torch.zeros((batch, cfg.vlm_patches, cfg.d_model),
                                     dtype=torch.float32, device=dev)
    if cfg.enc_dec:
        out["frames"] = torch.zeros((batch, cfg.enc_frames, cfg.d_model),
                                    dtype=torch.float32, device=dev)
    return out


def resume(ckpt_dir: str | None, params, opt_state, log=print):
    """(params, opt_state, first step): the latest checkpoint under
    ``ckpt_dir`` if there is one, else the given state from step 0."""
    if ckpt_dir and (s := CK.latest_step(ckpt_dir)) is not None:
        log(f"[train] resuming from checkpoint step {s}")
        state = CK.restore(ckpt_dir, {"params": params, "opt": opt_state})
        return state["params"], state["opt"], s
    return params, opt_state, 0


class Layout:
    """The train step's layout on a mesh: the (pspecs, ospecs, bspecs)
    of ``dist.sharding.train_specs``, the reference's call (step 0's
    batch serves as the batch's structure)."""

    def __init__(self, mesh, cfg, params, batch: int, seq: int):
        b0 = synthetic_batch(cfg, batch, seq, 0, device="cpu")
        self.mesh = mesh
        self.pspecs, self.ospecs, self.bspecs = SH.train_specs(
            mesh, cfg, params, b0)

    def state(self, params, opt_state):
        """(params, opt_state) as DTensors on their specs: a plain
        (global) leaf cut to this rank's shard, no collective; a DTensor
        redistributed where its layout differs (an all-reduce of partial
        sums, the counterpart of ``out_shardings``)."""
        return (SH.distribute_tree(self.mesh, params, self.pspecs),
                SH.distribute_tree(self.mesh, opt_state, self.ospecs))

    def batch(self, b: dict) -> dict:
        """A global batch cut to this rank's rows."""
        return SH.distribute_tree(self.mesh, b, self.bspecs)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value, the same bits on every rank (partial sums
    all-reduced); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def train_loop(cfg, params, opt_state, *, steps: int, batch: int, seq: int,
               start: int = 0, opt_cfg: O.AdamWConfig | None = None,
               ckpt_dir: str | None = None, ckpt_every: int = 20,
               inject_nan_at: int = -1, device=None, on_checkpoint=None,
               log=print, remat: bool = True, mesh=None) -> dict:
    """Steps ``start`` .. ``steps - 1``.  After a step whose loss is not
    finite the step's result is dropped, and the latest checkpoint (if
    any) restored; every ``ckpt_every`` steps the state is saved.  The
    loop holds one state between steps (a second only inside a step's
    update), so a caller that hands over ``params`` and ``opt_state``
    keeps no reference to them.
    Each step rematerialises its layers under ``remat``.
    ``on_checkpoint(kind, step, state)`` is told of each save and restore
    ("save" / "restore").  Returns {"params", "opt", "losses": [(step,
    loss)], "grad_norms": [(step, norm before clipping)], "step_s":
    seconds per kept step, "saved", "restored": the steps whose
    checkpoint was written or read}.

    ``mesh`` (a DeviceMesh of the world; every rank calls the loop with
    the same arguments) runs the step as SPMD ranks: params and state
    (global tensors, or DTensors) laid out by ``Layout``, each step's
    batch cut to the rank's rows, the step under ``settings.use_mesh``
    and its outputs put back on their specs.  The loss the NaN decision
    reads is replicated (``replicated``), so every rank decides alike.
    The returned state is DTensors; None runs one process."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"the mesh's DTensors live on {mesh.device_type}, "
                         f"the loop runs on {dev}")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    step_fn = make_train_step(cfg, opt_cfg or O.AdamWConfig(), remat=remat)
    layout = None if mesh is None else Layout(mesh, cfg, params, batch, seq)
    if layout is not None:
        params, opt_state = layout.state(params, opt_state)
        step_fn = _on_mesh(step_fn, layout)
    losses, norms, step_s, saved, restored = [], [], [], [], []
    for step in range(start, steps):
        b = synthetic_batch(cfg, batch, seq, step, device=dev)
        if layout is not None:
            b = layout.batch(b)
        sync()
        t0 = time.perf_counter()
        new_params, new_opt, metrics = step_fn(params, opt_state, b)
        loss = float(replicated(metrics["loss"]))
        dt = time.perf_counter() - t0
        if inject_nan_at == step:
            loss = float("nan")
        if not math.isfinite(loss):
            log(f"[train] step {step}: NON-FINITE loss — restoring last "
                "checkpoint and skipping batch")
            del new_params, new_opt, metrics
            if ckpt_dir and (s := CK.latest_step(ckpt_dir)) is not None:
                t0 = time.perf_counter()
                state = CK.restore(ckpt_dir, {"params": params,
                                              "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
                sync()
                log(f"[train] restored step {s} "
                    f"({time.perf_counter() - t0:.2f}s)")
                restored.append(s)
                if on_checkpoint:
                    on_checkpoint("restore", s, state)
                del state   # no reference outlives the next step
            continue
        params, opt_state = new_params, new_opt
        del new_params, new_opt
        gnorm = float(replicated(metrics["grad_norm"]))
        losses.append((step, loss))
        norms.append((step, gnorm))
        step_s.append(dt)
        log(f"[train] step {step:4d} loss {loss:.4f} gnorm {gnorm:.3f} "
            f"({dt:.2f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            state = {"params": params, "opt": opt_state}
            t0 = time.perf_counter()
            d = CK.save(ckpt_dir, step + 1, state)
            dt = time.perf_counter() - t0
            saved.append(step + 1)
            if on_checkpoint:
                on_checkpoint("save", step + 1, state)
            del state
            log(f"[train] checkpointed -> {d} ({dt:.2f}s)")
    if len(losses) >= 10:
        kept = [x for _, x in losses]
        log(f"[train] loss first5={np.mean(kept[:5]):.4f} "
            f"last5={np.mean(kept[-5:]):.4f}")
    return {"params": params, "opt": opt_state, "losses": losses,
            "grad_norms": norms, "step_s": step_s, "saved": saved,
            "restored": restored}


def _on_mesh(step_fn, layout: Layout):
    """``step_fn`` run on DTensors over the layout's mesh, its new state
    put back on the specs."""
    def step(params, opt_state, b):
        with SET.use_mesh(layout.mesh):
            new_params, new_opt, metrics = step_fn(params, opt_state, b)
            new_params, new_opt = layout.state(new_params, new_opt)
        return new_params, new_opt, metrics
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-nan-at", type=int, default=-1,
                    help="fault-injection test: corrupt loss at this step")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--no-shard", action="store_true",
                    help="run one process, without the mesh's layouts")
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    opt_cfg = O.AdamWConfig(lr=args.lr, warmup_steps=10)
    dev = resolve_device(args.device)
    mesh = None if args.no_shard else M.make_host_mesh(dev.type)
    if isinstance(mesh, AbstractMesh):
        mesh = None                    # a world of one: one process
    if mesh is None and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        raise SystemExit("--no-shard runs one process, not a world of "
                         f"{os.environ['WORLD_SIZE']} ranks")
    log = print if mesh is None or mesh_rank(mesh) == 0 else \
        (lambda s: None)
    params = T.init_params(cfg, seed=0, device=dev)
    opt_state = O.init_opt_state(params)
    if mesh is not None:
        params, opt_state = Layout(mesh, cfg, params, args.batch,
                                   args.seq).state(params, opt_state)
    params, opt_state, start = resume(args.ckpt_dir, params, opt_state,
                                      log=log)
    train_loop(cfg, params, opt_state, steps=args.steps, batch=args.batch,
               seq=args.seq, start=start, opt_cfg=opt_cfg,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               inject_nan_at=args.inject_nan_at, device=dev, log=log,
               remat=True, mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
