"""Step-tagged atomic checkpoints (port of ``repro.training.checkpoint``),
in the reference's on-disk format, so that each package restores the
other's:

  - a directory ``<root>/step_%08d`` per step;
  - one ``.npy`` per leaf, named by its path (keys joined by ``__``), and
    ``manifest.json``: ``{"step", "arrays": {path: {"file", "shape",
    "dtype"}}}`` with paths joined by ``/`` in jax's leaf order (sorted
    dict keys) and NumPy's dtype names ("bfloat16" for bf16);
  - bf16 leaves stored as the reference stores them, two raw bytes an
    element under the descr ``'<V2'`` (NumPy's view of ``ml_dtypes``'
    bfloat16), which this module writes and reads without ``ml_dtypes``;
  - atomic commit: written into ``.tmp-step_%08d``, the manifest fsynced,
    then renamed (a crashed writer never corrupts the latest checkpoint);
  - keep-last-k garbage collection.

Leaves are copied from the card and written, or read and copied back,
by a few threads at once (the copies and NumPy's file I/O release the
interpreter lock); the files are the same.

A tree of DTensors (a world of ranks, ``launch.train``'s sharded path)
saves and restores the same files.  Every rank calls ``save``: each leaf
is gathered whole (``full_tensor``, a collective every rank enters in
leaf order), rank 0 alone writes, and a barrier follows, so that no rank
reads a generation still being written.  Every rank calls ``restore``:
it reads the same files and cuts its own shard (no collective).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.training.tree import items, unflatten

_STEP_RE = re.compile(r"^step_(\d{8})$")
# A bf16 leaf's NumPy header descr (ml_dtypes.bfloat16's dtype.str).
_BF16_DESCR = "<V2"
_IO_THREADS = 8
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16, "float64": torch.float64,
                 "int8": torch.int8, "int16": torch.int16,
                 "int32": torch.int32, "int64": torch.int64,
                 "uint8": torch.uint8, "bool": torch.bool}


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf):
    """(NumPy array of the leaf's bytes, dtype name): bf16 as int16 bits
    named "bfloat16"."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return a.view(np.int16), "bfloat16"
    return a, str(a.dtype)


def _write(path: str, leaf) -> tuple[list, str]:
    """Copy the leaf to the host and write its .npy; returns its (shape,
    dtype name) for the manifest."""
    arr, dtype = _host(leaf)
    if dtype != "bfloat16":
        np.save(path, arr)
    else:
        arr = np.asarray(arr, order="C")
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(arr.shape)})
            arr.tofile(f)
    return list(arr.shape), dtype


def _pool():
    return concurrent.futures.ThreadPoolExecutor(_IO_THREADS)


def _distributed(tree) -> bool:
    """Whether a leaf of the tree is a DTensor."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for _, x in items(tree))


def _whole(leaf):
    """A DTensor leaf gathered whole (a collective); any other as it is."""
    from torch.distributed.tensor import DTensor
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def save(root: str, step: int, tree, *, keep_last: int = 3) -> str:
    """Atomically write a checkpoint of ``tree`` (tensors on any device,
    arrays, or DTensors: then every rank of their mesh calls it, and rank
    0 writes); returns the committed directory."""
    if _distributed(tree):
        import torch.distributed as dist
        whole = [(path, _whole(leaf)) for path, leaf in items(tree)]
        if dist.get_rank() == 0:
            _save(root, step, whole, keep_last)
        del whole
        dist.barrier()
        return os.path.join(root, f"step_{step:08d}")
    return _save(root, step, list(items(tree)), keep_last)


def _save(root: str, step: int, pairs: list, keep_last: int) -> str:
    """``save`` of the (path, leaf) pairs (jax's leaf order)."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = os.path.join(root, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": {}}
    jobs = {}
    with _pool() as pool:
        for path, leaf in pairs:
            key = _key(path)
            fname = key.replace("/", "__") + ".npy"
            jobs[key] = (fname, pool.submit(_write, os.path.join(tmp, fname),
                                            leaf))
        for key, (fname, job) in jobs.items():
            shape, dtype = job.result()
            manifest["arrays"][key] = {"file": fname, "shape": shape,
                                       "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic commit
    _gc(root, keep_last)
    return final


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [int(m.group(1)) for d in os.listdir(root)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def _read(path: str, dtype: str, like):
    a = np.load(path)
    if dtype == "bfloat16":
        a = a.view(np.int16)
    if not isinstance(like, torch.Tensor):
        return a
    t = torch.from_numpy(np.asarray(a, order="C"))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    elif dtype in _TORCH_DTYPES:
        t = t.to(_TORCH_DTYPES[dtype])
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(like, DTensor):
        # This rank's shard of the whole leaf, cut here (no collective).
        return distribute_tensor(t.to(like.to_local().device),
                                 like.device_mesh, like.placements,
                                 src_data_rank=None)
    return t.to(like.device)


def restore(root: str, tree_like, step: int | None = None):
    """Load a checkpoint into the structure of ``tree_like`` (shapes must
    match).  A tensor leaf of ``tree_like`` comes back as a tensor of the
    checkpoint's dtype on that leaf's device (a DTensor leaf as a DTensor
    of its layout, this rank's shard cut from the whole); any other leaf
    as a NumPy array (bf16 as its int16 bits)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with _pool() as pool:
        jobs = []
        for path, leaf in items(tree_like):
            key = _key(path)
            meta = manifest["arrays"][key]
            if tuple(meta["shape"]) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape "
                                 f"{tuple(meta['shape'])} != expected "
                                 f"{tuple(leaf.shape)}")
            jobs.append(pool.submit(_read, os.path.join(d, meta["file"]),
                                    meta["dtype"], leaf))
        return unflatten(tree_like, [j.result() for j in jobs])


def _gc(root: str, keep_last: int) -> None:
    steps = sorted(int(m.group(1)) for d in os.listdir(root)
                   if (m := _STEP_RE.match(d)))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"),
                      ignore_errors=True)
