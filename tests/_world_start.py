"""Where a spawned world's start time goes, on the card.

    python3 tests/_world_start.py

Prints the time one fresh process takes to import torch and initialize
CUDA, then, for worlds of ``repro_torch.dist.spawn`` (4 ranks on the
card, 4 on the CPU, 4 and 2 on the card again, then two 4-rank worlds at
once), each rank's seconds from the spawn to its function's entry, to
CUDA initialized, to the port imported and to the kernel library open,
and the world's wall.  Needs CUDA and the built kernel library.
"""
import json
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def fn(t0, device):
    out = {"entry": time.time() - t0}
    import torch
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    out["cuda_init"] = time.time() - t0
    from repro_torch import dist, runtime  # noqa: F401
    out["import_port"] = time.time() - t0
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.load()
    out["lib"] = time.time() - t0
    out["end"] = time.time() - t0
    return out


def main():
    t = time.time()
    r = subprocess.run([sys.executable, "-c", (
        "import time; t = time.time(); import torch; a = time.time(); "
        "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
        "print(a - t, time.time() - a)")], capture_output=True, text=True)
    print("one process: import torch, cuda init", r.stdout.strip(), "wall",
          time.time() - t)
    from repro_torch.kernels import _build
    t = time.time()
    _build.load()
    print("build", time.time() - t)
    from repro_torch import dist as D

    def world(n, dev):
        t0 = time.time()
        res = D.spawn(fn, n, args=(t0, dev), timeout=120,
                      workdir=str(ROOT / "build"))
        return res, time.time() - t0

    for dev, n in (("cuda", 4), ("cpu", 4), ("cuda", 4), ("cuda", 2)):
        res, wall = world(n, dev)
        print(dev, n, "wall", round(wall, 2), json.dumps(
            [{k: round(v, 2) for k, v in r.items()} for r in res]))
    outs = {}
    th = [threading.Thread(target=lambda k=k: outs.update(
        {k: world(4, "cuda")[1]})) for k in range(2)]
    t = time.time()
    for x in th:
        x.start()
    for x in th:
        x.join()
    print("two 4-rank worlds at once: wall", round(time.time() - t, 2),
          {k: round(v, 2) for k, v in outs.items()})


if __name__ == "__main__":
    main()
