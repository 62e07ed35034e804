"""Fault-tolerant training driver (port of ``repro.launch.train``).

  - the train step (loss -> grads -> clip -> AdamW) on one card;
  - step-tagged atomic checkpoints + keep-last-k (``training/checkpoint``);
  - a non-finite loss restores the last checkpoint and skips the batch
    (``--inject-nan-at`` plants one);
  - crash-resume: rerunning the command continues from the latest step;
  - a deterministic batch per step (``synthetic_batch``, the reference's
    bit for bit), so a restarted run re-derives exactly its data.

It runs in one process, each layer rematerialised (``remat=True``, as
the reference's CLI runs).  The data-parallel path with compressed
gradient sync is ``training.compression.sync_tree`` over a process group
of ``dist.mesh``; the reference's run over its host mesh's specs
(``dist.sharding.train_specs``) is ROADMAP item 6g.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --steps 50 --batch 8 --seq 256 --smoke --ckpt-dir /tmp/ckpt \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
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


def train_loop(cfg, params, opt_state, *, steps: int, batch: int, seq: int,
               start: int = 0, opt_cfg: O.AdamWConfig | None = None,
               ckpt_dir: str | None = None, ckpt_every: int = 20,
               inject_nan_at: int = -1, device=None, on_checkpoint=None,
               log=print, remat: bool = True) -> dict:
    """Steps ``start`` .. ``steps - 1``.  After a step whose loss is not
    finite the step's result is dropped, and the latest checkpoint (if
    any) restored; every ``ckpt_every`` steps the state is saved.  The
    loop holds one state between steps (a second only inside a step's
    update), so a caller that hands over ``params`` and ``opt_state``
    keeps no reference to them.
    Each step rematerialises its layers under ``remat``.
    ``on_checkpoint(kind, step, state)`` is told of each save and restore
    ("save" / "restore").  Returns {"params", "opt", "losses": [(step,
    loss)], "step_s": seconds per kept step, "saved", "restored": the
    steps whose checkpoint was written or read}."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    step_fn = make_train_step(cfg, opt_cfg or O.AdamWConfig(), remat=remat)
    losses, step_s, saved, restored = [], [], [], []
    for step in range(start, steps):
        b = synthetic_batch(cfg, batch, seq, step, device=dev)
        sync()
        t0 = time.perf_counter()
        new_params, new_opt, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
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
        losses.append((step, loss))
        step_s.append(dt)
        log(f"[train] step {step:4d} loss {loss:.4f} "
            f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.2f}s)")
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
            "step_s": step_s, "saved": saved, "restored": restored}


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
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    opt_cfg = O.AdamWConfig(lr=args.lr, warmup_steps=10)
    params = T.init_params(cfg, seed=0, device=args.device)
    params, opt_state, start = resume(args.ckpt_dir, params,
                                      O.init_opt_state(params))
    train_loop(cfg, params, opt_state, steps=args.steps, batch=args.batch,
               seq=args.seq, start=start, opt_cfg=opt_cfg,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               inject_nan_at=args.inject_nan_at, device=args.device,
               remat=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
