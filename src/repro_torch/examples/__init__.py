"""Runnable twins of the reference's ``examples/`` scripts on the port:
``python -m repro_torch.examples.<name>``."""
