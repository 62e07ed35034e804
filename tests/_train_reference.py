"""The reference's side of the compressed all-reduce test
(tests/test_torch_training.py): ``repro.training.compression.sync_tree``
inside a ``shard_map`` over a 2-device mesh, two error-feedback rounds
on the inputs of ``inputs()``; writes each round's mean and new error
(every device's row) to an .npz:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_train_reference.py OUT.npz

The device count is forced (``XLA_FLAGS``) before jax starts, so only
when the file runs as a script.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=2")

import numpy as np  # noqa: E402

RANKS, ROUNDS = 2, 2


def inputs():
    """Per round, the gradients {"a": (2, 64), "b": {"c": (2, 3, 5)}}
    (row r = rank r's), of different magnitudes per rank, and the first
    round's error state."""
    rng = np.random.default_rng(23)
    grads = []
    for _ in range(ROUNDS):
        s = np.array([1.0, 3.0], np.float32)
        grads.append({
            "a": (rng.standard_normal((RANKS, 64)) * s[:, None]).astype(
                np.float32),
            "b": {"c": (rng.standard_normal((RANKS, 3, 5)) *
                        s[:, None, None]).astype(np.float32)}})
    err = {"a": (rng.standard_normal((RANKS, 64)) * 1e-2).astype(np.float32),
           "b": {"c": np.zeros((RANKS, 3, 5), np.float32)}}
    return grads, err


def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{path}.{k}"))
        return out
    return {path: np.asarray(tree)}


def truth() -> dict:
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.training import compression as COMP

    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("d",))

    def f(g, e):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        m, ne = COMP.sync_tree(g, e, "d")
        return (jax.tree.map(lambda x: x[None], m),
                jax.tree.map(lambda x: x[None], ne))

    fn = jax.jit(COMP.shard_map(f, mesh=mesh, in_specs=(P("d"), P("d")),
                                out_specs=(P("d"), P("d"))))
    grads, err = inputs()
    out = {}
    for r, g in enumerate(grads):
        mean, err = fn(g, err)
        out.update(flat(mean, f"round{r}.mean"))
        out.update(flat(err, f"round{r}.err"))
    return out


if __name__ == "__main__":
    import jax
    assert len(jax.devices()) == RANKS, jax.devices()
    np.savez(sys.argv[1], **truth())
