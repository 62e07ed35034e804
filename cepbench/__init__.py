"""The benchmark of the PyTorch and CUDA port (``repro_torch``): CEP
tenants served by the streaming runtime on the card.  ``run.py`` runs one
cell once; see ``harness``."""
