"""Model configuration shared by all assigned architectures (copy of
`repro/models/config.py`, plus `torch_dtype`)."""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's `dtype` string ("bfloat16",
    "float32")."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported model dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}") from None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # attention flavor
    attn_type: str = "full"     # full | local_global (gemma2 alternation)
    window: int = 4096
    logit_softcap: float = 0.0  # gemma2 final-logit softcap (0 = off)
    attn_softcap: float = 0.0   # gemma2 attention softcap
    rope_theta: float = 10000.0
    act: str = "swiglu"         # swiglu | geglu | gelu
    use_bias: bool = False
    tie_embeddings: bool = False
    parallel_block: bool = False  # command-r style attn||ffn
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_version: int = 1
    d_conv: int = 4
    expand: int = 2
    ssm_heads: int = 0          # mamba2 heads
    # hybrid (zamba2): one shared attention block applied every k blocks
    shared_attn_every: int = 0
    # encoder-decoder (whisper)
    is_encdec: bool = False
    encoder_layers: int = 0
    # modality frontend stub
    frontend: str = ""          # "" | audio | vision
    frontend_seq: int = 0       # precomputed embedding length
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # training
    remat: str = "dots"         # none | dots | full
    accum_steps: int = 1
    # perf knobs (section Perf hillclimbing)
    attn_tp: str = "packed"     # packed | auto (heads-aware) | off
    scan_dtype: str = "float32"  # mamba chunk-scan compute dtype
    scan_chunk: int = 64         # mamba chunk length

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test sized variant of the same family (CPU-runnable)."""
        base = dict(
            n_layers=min(self.n_layers, 2 if not self.is_encdec else 2),
            d_model=128,
            n_heads=max(min(self.n_heads, 4), 1),
            n_kv_heads=max(min(self.n_kv_heads, 2), 1),
            d_ff=256 if self.n_experts == 0 else 64,
            vocab=512,
            head_dim=32,
            window=64,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 8),
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            frontend_seq=min(self.frontend_seq, 16) if self.frontend_seq else 0,
            dtype="float32",
            name=self.name + "-smoke",
        )
        base.update(overrides)
        return replace(self, **base)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
