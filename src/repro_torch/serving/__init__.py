"""The pSPICE scheduler for LLM decoding (port of ``repro.serving``)."""
