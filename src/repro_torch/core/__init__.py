"""repro.core — the Turbo-Charged Mapper (TCM).

Public API:
  * Workload IR: ``Einsum``, ``TensorSpec``, helpers ``matmul`` etc.
  * Hardware IR: ``Arch``, ``MemLevel``, ``SpatialFanout``.
  * Mapping IR: ``Storage``, ``Loop``, ``render``.
  * The mapper: ``tcm_map`` (optimal search), ``evaluate`` (reference model),
    ``brute_force_optimum`` (validation oracle), baselines in ``baselines``.
"""
from .arch import (Arch, ArchAxis, ArchPoint, ArchSpace, ArchTemplate,
                   MemLevel, SpatialFanout, arch_area_mm2, arch_from_dict,
                   arch_key, arch_to_dict)
from .einsum import (Einsum, TensorSpec, batched_matmul, conv1d,
                     depthwise_conv1d, einsum_from_dict, einsum_to_dict,
                     matmul)
from .looptree import Loop, Storage, render, validate_structure
from .mapper import (MapperStats, MappingResult, tcm_map, tcm_map_best_arch,
                     unpruned_mapspace_log10)
from .model import CurriedModel
from .refmodel import EvalResult, evaluate
from .search import (ProcessPoolEngine, SearchEngine, SerialEngine, WorkResult,
                     WorkUnit, make_engine)

__all__ = [
    "Arch", "MemLevel", "SpatialFanout",
    "ArchAxis", "ArchPoint", "ArchSpace", "ArchTemplate",
    "arch_area_mm2", "arch_from_dict", "arch_key", "arch_to_dict",
    "Einsum", "TensorSpec", "matmul", "batched_matmul", "conv1d",
    "depthwise_conv1d", "einsum_from_dict", "einsum_to_dict",
    "Loop", "Storage", "render", "validate_structure",
    "tcm_map", "tcm_map_best_arch", "MapperStats", "MappingResult",
    "unpruned_mapspace_log10",
    "CurriedModel", "EvalResult", "evaluate",
    "SearchEngine", "SerialEngine", "ProcessPoolEngine", "WorkUnit",
    "WorkResult", "make_engine",
]
