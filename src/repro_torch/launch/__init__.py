"""Drivers of the port (port of ``repro.launch``): ``serve``."""
