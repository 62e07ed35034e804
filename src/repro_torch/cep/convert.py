"""Carry engine inputs and state across, as NumPy arrays.

The reference package and the port share no code, so tests hand both
the very same inputs through NumPy: ``tree_to_numpy`` turns any
NamedTuple / dataclass / list / tensor tree (or any object whose leaves
``np.asarray`` accepts) into nested dicts and lists of arrays, and the
``*_from_numpy`` functions build the port's tensors on a chosen device
from such a tree — or from the reference's own objects, read by field
name.  The port never imports the reference to do this.

The PRNG key is a (2,) uint32 array in the reference and (2,) int32
holding the same bits in the port; the converters map one onto the
other.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.cep import engine as eng
from repro_torch.cep import runner
from repro_torch.core import overload as ovl
from repro_torch.core import utility as util
from repro_torch.device import resolve_device


def tree_to_numpy(x):
    """Tensors → arrays; NamedTuples/dataclasses → dicts; lists → lists."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: tree_to_numpy(v) for k, v in zip(x._fields, x)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: tree_to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, Mapping):
        return {k: tree_to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tree_to_numpy(v) for v in x]
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return np.asarray(x)


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _t(x, dev, dtype=None) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(np.array(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def latency_from_numpy(m, device=None) -> ovl.LatencyModel:
    dev = resolve_device(device)
    return ovl.LatencyModel(a=_t(_get(m, "a"), dev, torch.float32),
                            b=_t(_get(m, "b"), dev, torch.float32),
                            kind=_t(_get(m, "kind"), dev, torch.int32))


def model_from_numpy(m, device=None) -> eng.EngineModel:
    """An ``EngineModel`` on ``device`` from the reference's model."""
    dev = resolve_device(device)
    fields = {}
    for name in eng.EngineModel._fields:
        v = _get(m, name)
        fields[name] = (latency_from_numpy(v, dev)
                        if name in ("f_model", "g_model") else _t(v, dev))
    return eng.EngineModel(**fields)


def events_from_numpy(ev, device=None) -> eng.EventBatch:
    dev = resolve_device(device)
    return eng.EventBatch(*(_t(_get(ev, k), dev)
                            for k in eng.EventBatch._fields))


def carry_from_numpy(c, device=None) -> eng.Carry:
    dev = resolve_device(device)
    pms = eng.PMStore(*(_t(_get(_get(c, "pms"), k), dev)
                        for k in eng.PMStore._fields))
    rest = {k: _t(_get(c, k), dev) for k in eng.Carry._fields if k != "pms"}
    return eng.Carry(pms=pms, **rest)


def built_from_numpy(b, device=None) -> runner.BuiltModel:
    """A ``BuiltModel`` on ``device`` from the reference's BuiltModel."""
    dev = resolve_device(device)
    tables = [util.UtilityTable(
        table=_t(_get(t, "table"), dev), completion=_t(_get(t, "completion"),
                                                      dev),
        remaining=_t(_get(t, "remaining"), dev),
        bin_size=int(_get(t, "bin_size")), weight=float(_get(t, "weight")))
        for t in _get(b, "tables")]
    return runner.BuiltModel(
        T=[_t(x, dev) for x in _get(b, "T")],
        R=[_t(x, dev) for x in _get(b, "R")], tables=tables,
        ut_stacked=_t(_get(b, "ut_stacked"), dev, torch.float32),
        ut_bins=_t(_get(b, "ut_bins"), dev, torch.int32),
        f_model=latency_from_numpy(_get(b, "f_model"), dev),
        g_model=latency_from_numpy(_get(b, "g_model"), dev),
        max_rate=float(_get(b, "max_rate")),
        steady_n_pm=float(_get(b, "steady_n_pm")))
