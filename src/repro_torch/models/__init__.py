"""The model zoo's serving path (port of ``repro.models``): config,
layers, the Mamba2 (SSD) blocks, transformer forward and the prefill/
decode of the cache, for the dense, MoE, SSM and hybrid families."""
