"""Hand-written CUDA kernels, their plain PyTorch versions and oracles.

CUDA sources live in ``csrc/`` and are built on first use (``build``).
"""
