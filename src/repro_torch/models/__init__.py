"""The model zoo's dense serving path (port of ``repro.models``): config,
layers, transformer forward and the prefill/decode of the KV cache."""
