"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Both packages get the very same inputs through NumPy
(``repro_torch.cep.convert``), and results compare as NumPy trees.
"""
import dataclasses
import functools

import numpy as np

from repro.cep import patterns as pat
from repro.cep import runner
from repro.configs import pspice_paper as pp
from repro.data import streams
from repro_torch.cep import convert
from repro_torch.cep import engine as teng

# The cost constants of tests/test_backend.py: a tight bound with these
# makes the shed path fire within a few hundred events.
COST = dict(c_base=3e-4, c_match=6e-5, c_shed_base=1.5e-4, c_shed_pm=1.5e-6,
            c_ebl=6e-5)
SHEDDERS = ("none", "pspice", "pmbl", "ebl")


def leaves(tree, path=""):
    """(path, array) pairs of a ``convert.tree_to_numpy`` tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    else:
        a = np.asarray(tree)
        yield path, (a.view(np.int32) if a.dtype == np.uint32 else a)


def assert_trees_equal(ref, port, what="", equal_nan=False):
    """Bitwise equality of two trees (the reference's uint32 key is
    compared as the int32 bits the port keeps); with ``equal_nan`` a NaN
    equals a NaN."""
    a = dict(leaves(convert.tree_to_numpy(ref)))
    b = dict(leaves(convert.tree_to_numpy(port)))
    assert a.keys() == b.keys(), (what, sorted(a.keys() ^ b.keys()))

    def same(x, y):
        nan = equal_nan and x.dtype.kind == "f"
        return np.array_equal(x, y, equal_nan=nan)
    bad = [k for k in a if a[k].shape != b[k].shape or
           a[k].dtype != b[k].dtype or not same(a[k], b[k])]
    assert not bad, f"{what}: differs in {bad}"


def port_config(ref_cfg, backend: str) -> teng.EngineConfig:
    """The port's EngineConfig with the reference config's fields."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["backend"] = backend
    return teng.EngineConfig(**kw)


def to_port(model, events, carry, device="cpu"):
    """The reference's (model, events, carry) as the port's tensors."""
    return (convert.model_from_numpy(convert.tree_to_numpy(model), device),
            convert.events_from_numpy(convert.tree_to_numpy(events), device),
            convert.carry_from_numpy(convert.tree_to_numpy(carry), device))


@functools.lru_cache(maxsize=None)
def reference_built(name, n=1500):
    """The reference's BuiltModel of a scenario (warm-up on the first
    third of n events) and the rest of the stream to run."""
    sc = streams.get_scenario(name)
    specs = sc.specs()
    cp = pat.compile_patterns(specs)
    cfg = runner.default_config(cp, latency_bound=sc.latency_bound,
                                max_pms=sc.max_pms, emit_matches=True,
                                **pp.COST)
    raw = sc.raw(n=n)
    n_warm = n // 3
    warm = streams.classify(specs, cut(raw, 0, n_warm), rate=1.0,
                            seed=sc.seed)
    built = runner.build_model(specs, cfg, warm, bin_size=sc.bin_size,
                               seed=sc.seed)
    return sc, cfg, built, cut(raw, n_warm, n)


def cut(raw, a, b):
    """Events [a, b) of a RawStream."""
    return dataclasses.replace(raw, n=b - a, type_id=raw.type_id[a:b],
                               attr=raw.attr[a:b], group=raw.group[a:b])
