"""repro_torch.dse — architecture design-space exploration.

Only the roofline floors are ported so far: the mapping service backstops
a truncated search's gap certificate with them
(``serve_map.service``).
"""
from .roofline import RooflineBound, einsum_bounds, workload_bounds

__all__ = ["RooflineBound", "einsum_bounds", "workload_bounds"]
