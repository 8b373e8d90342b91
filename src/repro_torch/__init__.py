"""repro_torch — the TCM mapper's kernel-autotuner path on PyTorch and CUDA.

A second package beside ``repro`` (the JAX reference).  It keeps its own
copy of the numpy mapper (``core``) and of the packages around it
(``netmap``, ``obs``, ``dse.roofline``), plans Hopper SMEM tiles for every
matmul of a model (``core.autotile``, ``netmap.planner.model_tiles``) and
runs them on hand-written CUDA kernels (``kernels``), timed by
``measure``; the online mapping service (``serve_map``) serves the same
tiles to the kernels.  Nothing imported here loads torch: search workers
import these modules.
"""
