"""Hand-written CUDA kernels of the port and their PyTorch wrappers.

``ops`` is the per-event engine's dispatch surface; ``nfa_transition``,
``shed_select`` and ``block_step`` (the event-block megakernel) hold the
wrappers, each beside its plain PyTorch version; ``_build`` compiles
``repro_torch/csrc`` on first use.
"""
