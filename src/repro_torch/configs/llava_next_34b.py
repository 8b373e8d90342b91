"""llava-next-34b [hf:llava-hf]: yi-34b backbone (60L d=7168 56H kv=8
ff=20480 vocab=64000) + anyres patch-embedding frontend STUB: input_specs
provide precomputed patch embeddings (B, 576, 1152) per assignment."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000,
    frontend="patch", frontend_dim=1152,
)
