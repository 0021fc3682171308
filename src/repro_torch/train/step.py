"""Serve step factories: prefill and greedy decode.  Port of the serving half
of `repro/train/step.py`; the train step, its gradient accumulation and
`init_state` come with the optimizer in the training slice (ROADMAP item
11b)."""

from __future__ import annotations

import torch

from ..models import model as MDL
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, cache):
        return MDL.prefill(params, cfg, batch["tokens"], cache,
                           extra_embeds=batch.get("extra_embeds"),
                           enc_frames=batch.get("enc_frames"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, token, cache):
        logits, cache = MDL.decode_step(params, cfg, token, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None] \
            .to(torch.int32)
        return next_tok, logits, cache
    return serve_step


def greedy(params, cfg: ModelConfig, batch: dict, cache: dict, steps: int):
    """Prefill `batch` into `cache`, then `steps` greedy decode steps, as
    the launcher serves a batch: the tokens [B, steps + 1] (int32) and the
    logits of each call (prefill's first)."""
    logits, cache = make_prefill_step(cfg)(params, batch, cache)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    toks, all_logits = [tok], [logits]
    decode = make_decode_step(cfg)
    for _ in range(steps):
        tok, logits, cache = decode(params, tok, cache)
        toks.append(tok)
        all_logits.append(logits)
    return torch.cat(toks, dim=1), all_logits
