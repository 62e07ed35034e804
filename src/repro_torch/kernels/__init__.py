"""Hand-written CUDA kernels of the port and their PyTorch wrappers.

``ops`` is the engine's dispatch surface; ``nfa_transition`` and
``shed_select`` hold the wrappers, each beside its plain PyTorch
version; ``_build`` compiles ``repro_torch/csrc`` on first use.
"""
