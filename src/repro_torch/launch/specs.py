"""input_specs(): `meta` tensors standing for every model input — shapes
and dtypes, zero allocation (the dry-run contract).  Port of
`repro/launch/specs.py`; where the reference has `ShapeDtypeStruct`s from
`jax.eval_shape`, the port has tensors on the `meta` device, stacked
leaves as one tensor with the leading layer axis.  The cache's `pos` (a
host int in the port's cache) stands as the reference's int32 scalar."""

from __future__ import annotations

import dataclasses

import torch

from ..models import model as MDL
from ..models.config import ModelConfig, ShapeConfig, torch_dtype
from ..train import step as STEP
from ..train.optim import Optimizer


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def effective_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Shape-dependent config tweaks (accumulation only applies to train)."""
    if shape.kind != "train":
        return dataclasses.replace(cfg, accum_steps=1)
    return cfg


def _frontend(cfg: ModelConfig, lead: tuple) -> dict:
    dt = torch_dtype(cfg.dtype)
    out = {}
    if cfg.family == "vlm":
        out["extra_embeds"] = _meta(lead + (cfg.frontend_seq, cfg.d_model), dt)
    if cfg.is_encdec:
        out["enc_frames"] = _meta(lead + (cfg.frontend_seq, cfg.d_model), dt)
    return out


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    a = cfg.accum_steps
    b = shape.global_batch
    s = shape.seq_len
    if b % a:
        raise ValueError(f"batch {b} does not split into {a} accumulation "
                         f"steps")
    lead = (a, b // a) if a > 1 else (b,)
    return dict(tokens=_meta(lead + (s,), torch.int32),
                labels=_meta(lead + (s,), torch.int32),
                **_frontend(cfg, lead))


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    return dict(tokens=_meta((b, s), torch.int32), **_frontend(cfg, (b,)))


def cache_specs_abstract(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    max_len = shape.seq_len + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    cache = MDL.make_cache(cfg, b, max_len, device="meta")
    cache["pos"] = _meta((), torch.int32)
    if cfg.is_encdec:
        cache["enc_out"] = _meta((b, cfg.frontend_seq, cfg.d_model),
                                 torch_dtype(cfg.dtype))
    return cache


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig):
    return _meta((shape.global_batch, 1), torch.int32)


def params_abstract(cfg: ModelConfig) -> dict:
    return STEP.params_shape(cfg)


def state_abstract(cfg: ModelConfig, opt: Optimizer) -> dict:
    return STEP.state_shape(cfg, opt)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, opt=None) -> dict:
    """Everything the step function needs, as `meta` tensors."""
    cfg = effective_config(cfg, shape)
    if shape.kind == "train":
        return dict(kind="train", cfg=cfg,
                    state=state_abstract(cfg, opt),
                    batch=train_batch_specs(cfg, shape))
    if shape.kind == "prefill":
        return dict(kind="prefill", cfg=cfg,
                    params=params_abstract(cfg),
                    batch=prefill_batch_specs(cfg, shape),
                    cache=cache_specs_abstract(cfg, shape))
    return dict(kind="decode", cfg=cfg,
                params=params_abstract(cfg),
                token=decode_token_specs(cfg, shape),
                cache=cache_specs_abstract(cfg, shape))
