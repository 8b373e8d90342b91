"""seamless-m4t-medium [arXiv:2308.11596]: enc-dec transformer backbone,
12L enc + 12L dec, d=1024 16H (kv=16) ff=4096 vocab=256206.  The audio
frontend is a STUB: input_specs provide precomputed frame embeddings
(B, T, 80->proj) per assignment."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab=256206,
    is_encdec=True, enc_layers=12, dec_layers=12,
    frontend="frames", frontend_dim=80,
)
