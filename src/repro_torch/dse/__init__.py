"""repro_torch.dse — architecture design-space exploration.

Co-searches architectures and mappings over a parameterized
:class:`~repro_torch.core.arch.ArchSpace`: roofline-ordered candidate points,
dominance pruning before search, cross-point incumbent seeding during
search, warm-start through the persistent mapping cache, and a Pareto
(objective vs area) frontier report.

  >>> from repro_torch.dse import explore_space, get_space, resolve_workload
  >>> report = explore_space(get_space("edge-small"),
  ...                        resolve_workload("QK,FFA"))
  >>> print(report.render())

CLI: ``python -m repro_torch.dse --space edge --workload QK [--network CONFIG]``.
"""
from .explore import (check_parity, explore_space, explore_space_network)
from .report import DSEReport, PointRow, pareto_keep
from .roofline import RooflineBound, einsum_bounds, workload_bounds
from .space import SPACES, get_space, resolve_workload

__all__ = [
    "check_parity", "explore_space", "explore_space_network",
    "DSEReport", "PointRow", "pareto_keep",
    "RooflineBound", "einsum_bounds", "workload_bounds",
    "SPACES", "get_space", "resolve_workload",
]
