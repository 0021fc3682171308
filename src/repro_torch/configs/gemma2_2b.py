"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 —
local(4096)/global alternating attention, logit softcap 30, attn softcap 50,
GeGLU, post-norms [arXiv:2408.00118; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256, attn_type="local_global", window=4096,
    logit_softcap=30.0, attn_softcap=50.0, act="geglu", tie_embeddings=True,
)
