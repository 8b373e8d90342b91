"""mamba2-130m [arXiv:2405.21060]: 24L d=768 attention-free SSD,
state N=128, vocab=50280.  d_inner = 2*d_model, headdim 64 -> 24 heads."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_heads=24, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True,
    supports_long_context=True,  # O(1) state per token
)
