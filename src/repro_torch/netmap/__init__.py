"""repro_torch.netmap — whole-network mapping pipeline.

Connects the per-einsum TCM mapper to real model configurations:
extract a model's per-layer einsums, dedup repeated shapes, batch-search
the unique set through the parallel search engine, serve repeats from a
persistent on-disk cache, and compose per-model energy/latency/EDP reports.
``model_tiles`` gives every matmul of a model its Hopper kernel tile.

    from repro_torch.configs import get_config
    from repro_torch.core.presets import tpu_v4i_like
    from repro_torch.netmap import MappingCache, map_network

    report = map_network(get_config("qwen1_5_0_5b"), tpu_v4i_like(),
                         mode="decode", batch=8, seq=1024,
                         cache=MappingCache())
    print(report.render())

CLI: ``python -m repro_torch.netmap --config qwen1_5_0_5b`` (see ``--help``).
"""
from .cache import (CACHE_VERSION, CacheHit, MappingCache, compute_group_key,
                    compute_key)
from .extract import (LayerEinsum, NetworkGraph, extract_einsums,
                      extract_graph)
from .planner import (FusionRow, LayerRow, NetworkReport, NoValidMappingError,
                      UniqueSearch, map_network, model_shapes, model_tiles)

__all__ = [
    "CACHE_VERSION", "CacheHit", "MappingCache", "compute_group_key",
    "compute_key",
    "LayerEinsum", "NetworkGraph", "extract_einsums", "extract_graph",
    "FusionRow", "LayerRow", "NetworkReport", "NoValidMappingError",
    "UniqueSearch", "map_network", "model_shapes", "model_tiles",
]
