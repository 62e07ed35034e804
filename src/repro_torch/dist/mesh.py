"""Device meshes and rank worlds for the port's scale-out.

Counterpart of ``jax.make_mesh`` and ``repro.dist.compat.use_mesh``.  The
reference is one process that drives many devices (``shard_map``); the
port is SPMD: one process per rank, every rank handed the same global
inputs.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims ("data", "model"); :class:`AbstractMesh` is a mesh's shape and
names with no process group behind it — the counterpart of jax's
``AbstractMesh`` for the specs, and the world of one rank when
``torch.distributed`` is not initialized.

Backends: NCCL where each rank has a GPU of its own; gloo on the CPU and
for several ranks that share one GPU (NCCL refuses two ranks on one
device).  A mesh's device type is its DTensors' device, the card where
there is one whatever the backend (gloo stages a CUDA tensor's
collective through host memory); the CEP merge asks for the backend's
(``backend_device_type``).  ``repro.dist.compat`` (jax API shims) has no
counterpart.

:func:`spawn` runs a function on a world of rank processes (the tests'
and ``chip_smoke.py``'s worlds): ranks forked from a server that has
imported torch and the port, a ``file://`` store, a timeout on
``init_process_group`` and on the whole world, and the traceback of a
rank that failed re-raised in the parent after every rank has been
stopped (a rank killed by a signal is named with its exit code as soon
as it is seen).  :func:`broadcast_object` sends a picklable object from
rank 0 to every rank: a mesh runtime's recovery from disk, which rank 0
alone reads.
"""
from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import math
import os
import pathlib
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and dim names, with no process group behind it."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def size(self, mesh_dim: int | None = None) -> int:
        return math.prod(self.shape) if mesh_dim is None \
            else self.shape[mesh_dim]


def abstract_mesh(shape, names) -> AbstractMesh:
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         "length")
    return AbstractMesh(shape, names)


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, (AbstractMesh, DeviceMesh)):
        raise TypeError(f"expected a DeviceMesh or an AbstractMesh, got "
                        f"{type(mesh).__name__}")


def dim_names(mesh) -> tuple[str, ...]:
    _check_mesh(mesh)
    return tuple(mesh.mesh_dim_names or ())


def _dim(mesh, name: str) -> int:
    names = dim_names(mesh)
    if name not in names:
        raise ValueError(f"mesh has no dim {name!r}; its dims: {names}")
    return names.index(name)


def axis_size(mesh, name: str) -> int:
    """Ranks along the mesh dim ``name``."""
    return int(mesh.size(_dim(mesh, name)))


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 on an AbstractMesh)."""
    d = _dim(mesh, name)
    return 0 if isinstance(mesh, AbstractMesh) else \
        int(mesh.get_local_rank(d))


def axis_group(mesh, name: str):
    """The process group of this rank's ranks along ``name`` (None on an
    AbstractMesh, which runs only where that dim has one rank)."""
    d = _dim(mesh, name)
    if isinstance(mesh, AbstractMesh):
        if mesh.shape[d] != 1:
            raise ValueError(f"an AbstractMesh has no process group: dim "
                             f"{name!r} of {mesh.shape} cannot run")
        return None
    return mesh.get_group(d)


def mesh_rank(mesh) -> int:
    """This process's rank in the world (0 on an AbstractMesh)."""
    _check_mesh(mesh)
    if isinstance(mesh, AbstractMesh) or not dist.is_initialized():
        return 0
    return dist.get_rank()


def broadcast_object(obj, mesh):
    """World rank 0's ``obj`` on every rank of ``mesh`` (pickled,
    ``broadcast_object_list`` over the world's group, which a mesh of
    several ranks spans); ``obj`` itself without a process group.  Every
    rank calls it; what the other ranks pass is ignored."""
    _check_mesh(mesh)
    if isinstance(mesh, AbstractMesh) or not dist.is_initialized():
        return obj
    box = [obj if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def backend_device_type() -> str:
    """The device type of the CEP merge's meshes: the card under NCCL, the
    host under gloo, whose merge stages CUDA tensors through host memory
    (``sharding._Collective``)."""
    return "cuda" if dist.is_initialized() and \
        dist.get_backend() == "nccl" else "cpu"


def _mesh_device(device_type: str | None) -> str:
    """The device type a mesh is made for: ``device_type`` where the
    caller names one, else the card where there is one.  A card's rank
    takes ``cuda:(LOCAL_RANK % device count)`` (its world rank without
    ``LOCAL_RANK``), so that the ranks of a world sharing one card all
    land on it."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh is made for cuda or cpu, not "
                         f"{device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh for cuda needs a CUDA device; pass "
                               "device_type='cpu' for the host")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return device_type


def init_mesh(shape, names, backend: str | None = None,
              init_method: str | None = None, rank: int | None = None,
              timeout: float = 60.0, device_type: str | None = None):
    """The process group (unless one exists) and a ``DeviceMesh`` of
    ``shape`` with dims ``names`` over it: the counterpart of
    ``jax.make_mesh``.  Every rank calls it with the same shape.

    Without a process group, one is made: ``backend`` (default NCCL with
    a card, gloo without), ``rank`` (default ``$RANK`` or 0) of
    ``prod(shape)`` ranks, from ``init_method`` (a ``file://``,
    ``tcp://`` or ``env://`` address every rank is given; a world of one
    may omit it) with a ``timeout`` in seconds on its collectives.  The
    mesh's DTensors live on ``device_type`` ("cuda" or "cpu"; default the
    card where there is one, whatever the backend: a gloo world of ranks
    sharing one card keeps its DTensors there)."""
    shape, names = abstract_mesh(shape, names).shape, tuple(names)
    world = math.prod(shape)
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if rank is None:
            rank = int(os.environ.get("RANK", 0))
        if init_method is None:
            if world != 1:
                raise ValueError("a world of several ranks needs the "
                                 "address of its store (init_method)")
            init_method = "file://" + os.path.join(
                tempfile.mkdtemp(prefix="repro-torch-store-"), "store")
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
    if dist.get_world_size() != world:
        raise ValueError(f"a mesh of {shape} needs {world} ranks; the "
                         f"process group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_mesh_device(device_type), shape,
                            mesh_dim_names=names)


_world_meshes: dict = {}


def world_mesh(axis: str, device_type: str | None = None):
    """The default mesh: every rank of the world on one dim ``axis``, its
    DTensors on ``device_type`` (as ``init_mesh``) — with no process
    group, the world of one rank (an AbstractMesh)."""
    if not dist.is_initialized():
        return AbstractMesh((1,), (axis,))
    device_type = _mesh_device(device_type)
    key = (axis, id(dist.group.WORLD), dist.get_world_size(), device_type)
    if key not in _world_meshes:
        from torch.distributed.device_mesh import init_device_mesh
        _world_meshes[key] = init_device_mesh(
            device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))
    return _world_meshes[key]


# ---------------------------------------------------------------------------
# Rank worlds
# ---------------------------------------------------------------------------

class RankError(RuntimeError):
    """A rank of a spawned world failed; the message holds its traceback,
    or, for a rank that died without one (a signal), its exit code.
    ``rank`` and ``exitcode`` name that rank (None where a traceback
    says it)."""

    def __init__(self, msg: str, rank: int | None = None,
                 exitcode: int | None = None):
        super().__init__(msg)
        self.rank = rank
        self.exitcode = exitcode


def _rank_main(fn, rank: int, world: int, backend: str, tmp: str,
               timeout: float, args: tuple) -> None:
    # A rank that dies by a signal (a segfault in a native library)
    # leaves its Python stack on stderr.
    faulthandler.enable()
    torch.set_num_threads(1)
    d = pathlib.Path(tmp)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{d / 'store'}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
    except BaseException:
        # Written before the group goes down: the peers' failures follow.
        part = d / f"error-{rank}.part"
        part.write_text(f"rank {rank} of {world}:\n{traceback.format_exc()}")
        os.replace(part, d / f"error-{rank}.txt")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    part = d / f"result-{rank}.part"
    part.write_bytes(pickle.dumps(out))
    os.replace(part, d / f"result-{rank}.pkl")


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def _context():
    """The ranks' start method: a fork server that imports torch and the
    port once, then forks each rank from that state — a rank skips the
    interpreter's start and the imports (seconds each), and, forked from
    a process that never touched CUDA, initializes the card itself.  The
    server forks while idle: the threads torch starts at import wait in
    their pools holding no lock, as in a DataLoader's forked workers.
    It preloads DTensor (``torch.distributed.tensor``, which imports
    dynamo's pieces) too: a rank that trains or serves on a mesh would
    import it on its first DTensor op."""
    import multiprocessing
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed.tensor",
                                "repro_torch.dist", "repro_torch.runtime",
                                "repro_torch.launch.serve"])
    return ctx


def spawn(fn, world: int, args: tuple = (), backend: str = "gloo",
          timeout: float = 60.0, workdir: str | None = None) -> list:
    """``fn(*args)`` on ``world`` rank processes; returns each rank's
    result, in rank order.

    Each rank joins a ``backend`` process group through a ``file://``
    store in a fresh directory (under ``workdir``, default the system's
    temporary directory) with ``timeout`` seconds on its collectives,
    runs ``fn`` and leaves the group.  ``fn`` and ``args`` must pickle
    (a module-level function).  When a rank raises, every rank is stopped
    and its traceback raised here as :class:`RankError`; when the world
    has not finished within ``timeout`` seconds, every rank is stopped and
    ``TimeoutError`` raised.  A rank that dies without a traceback (a
    signal: SIGKILL gives exit code -9) stops the world as soon as it is
    seen, and :class:`RankError` names it and its exit code; its peers,
    waiting in a collective with it, are not waited for.  A rank that
    builds nothing: callers on the card load the kernel library
    (``kernels._build.load``) before spawning, so the ranks only open
    it."""
    ctx = _context()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="repro-torch-world-",
                                        dir=workdir))
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, backend, str(tmp), timeout, tuple(args)))
        for r in range(world)]

    def dead() -> list:
        # A rank writes its traceback before it exits, so a rank that
        # exited non-zero with none was stopped from outside.
        return [(r, p.exitcode) for r, p in enumerate(procs)
                if p.exitcode not in (None, 0)
                and not (tmp / f"error-{r}.txt").exists()]

    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs) \
                and not any(tmp.glob("error-*.txt")) and not dead() \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        # Read before the stop below, whose signals would count.
        killed = dead()
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        _stop(procs)
        if killed:
            r, code = killed[0]
            how = f" (signal {-code})" if code < 0 else ""
            raise RankError(f"rank {r} of {world} exited with code {code}"
                            f"{how} and left no traceback", rank=r,
                            exitcode=code)
        errors = list(tmp.glob("error-*.txt"))
        if errors:
            # The first failure is the cause: its peers fail after it.
            first = min(errors, key=lambda p: p.stat().st_mtime_ns)
            raise RankError(first.read_text())
        if late:
            raise TimeoutError(f"ranks {late} of a world of {world} did not "
                               f"finish within {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RankError(f"rank exit codes {codes}")
        return [pickle.loads((tmp / f"result-{r}.pkl").read_bytes())
                for r in range(world)]
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)
