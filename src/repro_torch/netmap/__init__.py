"""Model configuration -> per-layer einsums -> kernel tiles."""
from .extract import (LayerEinsum, NetworkGraph, extract_einsums,
                      extract_graph)
from .planner import model_shapes, model_tiles

__all__ = ["LayerEinsum", "NetworkGraph", "extract_einsums", "extract_graph",
           "model_shapes", "model_tiles"]
