"""whisper-base [audio]: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865 —
encoder-decoder; conv frontend STUBBED (input_specs feeds 1500 precomputed
frame embeddings) [arXiv:2212.04356; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, is_encdec=True, encoder_layers=6,
    frontend="audio", frontend_seq=1500, act="gelu", tie_embeddings=True,
)
