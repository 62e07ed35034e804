"""repro_torch — the PyTorch/CUDA port of the pSPICE CEP operator.

A package of its own beside ``repro`` (the JAX reference).  It keeps the
reference's module layout (``cep``, ``core``, ``data``, ``eval``,
``kernels``, ``runtime``, and for the model zoo's serving path
``configs``, ``models``, ``serving``, ``launch``) so every module has an obvious
counterpart, and never imports ``jax`` or ``repro``.

Entry points take ``device=None``, which means ``"cuda"`` and raises
when no card is present; the CPU is used only when a caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
import importlib

__all__ = ["cep", "configs", "core", "data", "device", "dist", "eval", "fp",
           "kernels", "launch", "models", "prng", "runtime", "serving",
           "spans"]


def __getattr__(name: str):
    if name in __all__:
        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
