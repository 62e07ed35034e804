"""NumPy bridge of the model zoo (the counterpart of ``cep/convert.py``).

``params_from_numpy`` turns the reference's parameters (``init_params``,
brought to NumPy) into the port's tensors, and ``cache_from_numpy`` its
KV cache, so both packages compute on the same numbers in the tests.
bfloat16 arrays (NumPy's ``ml_dtypes`` type, which ``torch.from_numpy``
refuses) pass through float32, which holds them exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device, dtype):
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    # A copy: the port writes its cache in place, never into the caller's
    # arrays.
    t = torch.from_numpy(np.array(a.astype(np.float32) if bf16 else a,
                                  copy=True, order="C"))
    if bf16:
        t = t.to(torch.bfloat16)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# Leaves a model keeps in float32 whatever its type, as the reference
# draws and computes them: the MoE router; a Mamba2 block's A_log, D and
# dt_bias (a key named "D" exists only in a Mamba2 block); and the SSM
# cache's recurrent "state" (no parameter bears that name).
FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias", "state")


def _tree(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree(v, device, None if k in FLOAT32_LEAVES else dtype)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, device, dtype) for v in tree)
    return _tensor(tree, device, dtype)


def params_from_numpy(tree, device=None, dtype: torch.dtype | None = None):
    """A nested dict of arrays as the port's tensors: the reference's
    parameters, or its cache (``cache_from_numpy``); floating leaves cast
    to ``dtype`` when it is given, integer ones (``pos``) and the
    ``FLOAT32_LEAVES`` (the MoE router, the SSM's A_log, D, dt_bias and
    state) kept as they are."""
    return _tree(tree, resolve_device(device), dtype)


cache_from_numpy = params_from_numpy


def to_numpy(tree):
    """Tensors of a nested dict/tuple as NumPy arrays (float32 for bf16)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
