"""repro_torch — the TCM mapper's kernel-autotuner path on PyTorch and CUDA.

A second package beside ``repro`` (the JAX reference).  It keeps its own
copy of the numpy mapper (``core``), plans Hopper SMEM tiles for every
matmul of a model (``core.autotile``, ``netmap.planner.model_tiles``) and
runs them on hand-written CUDA kernels (``kernels``), timed by ``measure``.
"""
