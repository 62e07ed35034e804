"""Fault-tolerant LM training end to end on the PyTorch/CUDA port.

The counterpart of ``examples/train_lm.py``: trains the reduced internlm2
config (``--smoke``) on a learnable synthetic stream through
``repro_torch.launch.train``, with a checkpoint every 20 steps and a
simulated failure (a NaN loss at step 35) that the loop recovers from by
restoring the last checkpoint; then a second run resumes from the latest
checkpoint and trains on.  Attention runs through the flash kernel's
``autograd.Function`` (the kernel forward on the GPU).  Runs on the GPU
unless given ``--device cpu``.

  PYTHONPATH=src python examples/torch_train_lm.py
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
      --steps 6 --resume-steps 8 --ckpt-every 2 --inject-nan-at 3
"""
import argparse
import shutil
import sys
import tempfile

from repro_torch.launch import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--resume-steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-nan-at", type=int, default=35)
    args = ap.parse_args(argv)
    common = ["--arch", "internlm2-1.8b", "--smoke", "--batch",
              str(args.batch), "--seq", str(args.seq), "--ckpt-every",
              str(args.ckpt_every)]
    if args.device is not None:
        common += ["--device", args.device]
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        print("=== phase 1: train w/ checkpoints + injected fault ===")
        train.main(common + ["--steps", str(args.steps), "--ckpt-dir", ckpt,
                             "--inject-nan-at", str(args.inject_nan_at)])
        print("\n=== phase 2: crash-resume from the latest checkpoint ===")
        train.main(common + ["--steps", str(args.resume_steps),
                             "--ckpt-dir", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
