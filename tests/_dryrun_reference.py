"""The reference's side of the dry-run tests (tests/test_torch_dryrun.py,
tests/test_torch_sharding_specs.py), run as a script in a process of its
own with 256 forced host devices:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_dryrun_reference.py \\
        bytes|indices OUT.json

``bytes``: the per-device argument bytes of the reference's compiled
step (``memory_analysis().argument_size_in_bytes``) for every
architecture's decode_32k and internlm2-1.8b's train_4k on the (16, 16)
and (32, 8) meshes, and ``model_flops`` of every cell.  ``indices``: jax's ``devices_indices_map`` of a set
of specs on a (4, 4) and a (2, 2, 2) mesh, as each device's mesh
coordinate and its (start, stop) per dim.

Under jax 0.9.0 ``jax.make_mesh`` makes Explicit axes, on which the
reference's ``with_sharding_constraint`` by names fails
(``repro.launch.mesh.make_production_mesh``); the meshes here are made
with Auto axes, on which its ``build_lowered`` lowers and compiles.  The
device count is forced (``XLA_FLAGS``) before jax starts, so only when
the file runs as a script.
"""
import json
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=256")

MESHES = {"16x16": (16, 16), "32x8": (32, 8)}
# (arch, shape) cells whose argument bytes are held.
BYTES_CELLS = ([(a, "decode_32k") for a in (
    "zamba2-7b", "starcoder2-15b", "qwen1.5-110b", "internlm2-1.8b",
    "minitron-4b", "deepseek-v3-671b", "deepseek-moe-16b", "internvl2-76b",
    "mamba2-1.3b", "whisper-small")] + [("internlm2-1.8b", "train_4k")])
# Specs whose shards are compared on a small mesh: (shape, spec).
INDEX_CASES = {
    "4x4": ((4, 4), ("data", "model"), [
        ((8, 12), ("data", "model")), ((8, 12), ("model", None)),
        ((16, 4), (("data", "model"), None)), ((4, 8, 8), (None, "data", None)),
        ((2, 8, 16, 4), (None, "data", "model", None))]),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), [
        ((8, 4), (("pod", "data"), "model")),
        ((8, 6, 4), (("pod", "data", "model"), None, None)),
        ((4, 4), ("pod", ("data", "model"))), ((6, 4), (None, "data"))]),
}


def _mesh(shape, names):
    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names,
                axis_types=(AxisType.Auto,) * len(shape))


def argument_bytes() -> dict:
    """The compiled argument bytes ("arch|shape|mesh"), and the
    reference's ``model_flops`` of every cell ("flops|arch|shape"; its
    module forces 512 host devices on import, so only here)."""
    from repro.configs import registry
    from repro.configs.shapes import SHAPES
    from repro.launch import dryrun as DR
    out = {f"flops|{a}|{s}": DR.model_flops(registry.get_config(a), sh)
           for a in registry.ARCH_IDS for s, sh in SHAPES.items()}
    for key, shape in MESHES.items():
        mesh = _mesh(shape, ("data", "model"))
        for arch, sh in BYTES_CELLS:
            lowered = DR.build_lowered(registry.get_config(arch), SHAPES[sh],
                                       mesh)
            mem = lowered.compile().memory_analysis()
            out[f"{arch}|{sh}|{key}"] = int(mem.argument_size_in_bytes)
    return out


def indices() -> dict:
    from jax.sharding import NamedSharding, PartitionSpec as P
    out = {}
    for key, (shape, names, cases) in INDEX_CASES.items():
        mesh = _mesh(shape, names)
        coords = {d.id: c for c, d in zip(
            __import__("numpy").ndindex(*shape), mesh.devices.flat)}
        rows = []
        for tshape, spec in cases:
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tshape)
            rows.append([[list(coords[d.id]),
                          [[s.start or 0, tshape[i] if s.stop is None
                            else s.stop] for i, s in enumerate(sl)]]
                         for d, sl in idx.items()])
        out[key] = rows
    return out


if __name__ == "__main__":
    what, path = sys.argv[1], sys.argv[2]
    res = argument_bytes() if what == "bytes" else indices()
    with open(path, "w") as f:
        json.dump(res, f)
