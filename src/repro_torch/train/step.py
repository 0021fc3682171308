"""Train/serve step factories: gradient accumulation, optimizer application,
serve prefill/decode.  Port of `repro/train/step.py`.

The train state is `dict(params=<the LM module>, opt=<optimizer state>,
step=<int32 tensor>)`.  The optimizer sees the module's parameters as
`models.model.param_tree` gives them (the reference's tree, each stacked
leaf as its per-layer tensors), so its moments have the reference's tree
too.  `save_state`/`restore_state` carry a state through `ft` under the
reference's paths (`params/layers/...` stacked on a leading layer axis,
`opt/mu/...`, `opt/nu/...`, `opt/step`, `step`) with the reference's
shapes and dtypes: a checkpoint written by either package restores in the
other.  Stacking happens on the host at save time; a restore copies each
slice into the tensor the state holds.
"""

from __future__ import annotations

import torch

from ..ft import checkpoint as CKPT
from ..models import layers as L
from ..models import model as MDL
from ..models.config import ModelConfig
from .optim import Optimizer, leaf_shape, slices, tree_map, tree_tensors


def init_state(cfg: ModelConfig, opt: Optimizer, generator=None,
               device="cuda") -> dict:
    """A fresh state: `MDL.init_params(cfg, generator, device)`, the
    optimizer's state and a zero step count."""
    return _state(MDL.init_params(cfg, generator, device=device), opt)


def state_shape(cfg: ModelConfig, opt: Optimizer) -> dict:
    """The state's tree as `ft` saves it, as tensors on the `meta` device
    (shapes and dtypes only)."""
    model = MDL.LM(cfg, L.Init(torch.device("meta")))
    return _template(state_tree(_state(model, opt)))


def params_shape(cfg: ModelConfig) -> dict:
    """The parameters in the reference's tree, as stacked `meta`
    tensors."""
    return _template(MDL.param_tree(MDL.LM(cfg, L.Init(torch.device("meta")))))


def _state(model: MDL.LM, opt: Optimizer) -> dict:
    return dict(params=model, opt=opt.init(MDL.param_tree(model)),
                step=torch.zeros((), dtype=torch.int32,
                                 device=model.final_norm.device))


def state_tree(state: dict) -> dict:
    """`state` as the reference's tree, each stacked leaf as the list of
    the state's own per-layer tensors."""
    return dict(params=MDL.param_tree(state["params"]), opt=state["opt"],
                step=state["step"])


def _template(tree: dict) -> dict:
    return tree_map(lambda x: torch.empty(
        leaf_shape(x), dtype=slices(x)[0].dtype, device="meta"), tree)


def host_state(state: dict) -> dict:
    """The state as the reference's arrays, stacks stacked on the host (a
    bf16 leaf as `ft` saves it)."""
    return MDL.host_tree(state_tree(state), CKPT.to_numpy)


def save_state(ckpt_dir: str, step: int, state: dict,
               extra: dict | None = None, keep: int = 3) -> str:
    """`ft.save` of the state in the reference's layout (see the module
    docstring)."""
    return CKPT.save(ckpt_dir, step, host_state(state), extra=extra,
                     keep=keep)


def restore_state(ckpt_dir: str, state: dict):
    """Load the newest valid checkpoint under `ckpt_dir` into `state`'s
    tensors (in place).  Returns its manifest, or None when nothing
    restores (then `state` is untouched).  A bf16 leaf never restores
    (`ft`'s docstring), as in the reference."""
    dst = state_tree(state)
    tree, manifest = CKPT.restore(ckpt_dir, _template(dst), device="cpu")
    if tree is None:
        return None

    def put(d, s):
        if isinstance(d, list):
            for t, si in zip(d, s):
                t.copy_(si)
        else:
            d.copy_(s)

    with torch.no_grad():
        tree_map(put, dst, tree)
    return manifest


def make_train_step(cfg: ModelConfig, opt: Optimizer):
    """batch: dict(tokens, labels[, extra_embeds, enc_frames]) of tensors
    on the model's device.  With cfg.accum_steps > 1 the tensors carry a
    leading accumulation dim: the micro-batches' gradients are summed in
    f32 and scaled by 1/accum_steps, as the reference's `lax.scan` does.
    Returns (state, dict(loss, grad_norm)); the state's tensors are
    updated in place.  The step turns the model's gradients on
    (`init_params` makes its weights without them)."""

    def loss_for(model, mb):
        return MDL.loss_fn(model, cfg, mb["tokens"], mb["labels"],
                           extra_embeds=mb.get("extra_embeds"),
                           enc_frames=mb.get("enc_frames"))

    def train_step(state, batch):
        model = state["params"].requires_grad_(True)
        tree = MDL.param_tree(model)
        leaves = tree_tensors(tree)
        if cfg.accum_steps > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for j in range(cfg.accum_steps):
                mb = {k: v[j] for k, v in batch.items()}
                loss = loss_for(model, mb)
                for a, b in zip(gsum, torch.autograd.grad(loss, leaves)):
                    a.add_(b.float())
                lsum = lsum + loss.detach()
            inv = 1.0 / cfg.accum_steps
            grads = [g * inv for g in gsum]
            loss = lsum * inv
        else:
            loss = loss_for(model, batch)
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
        it = iter(grads)
        gtree = tree_map(
            lambda p: [next(it) for _ in p] if isinstance(p, list)
            else next(it), tree)
        _, new_opt, metrics = opt.update(gtree, state["opt"], tree)
        new_state = dict(params=model, opt=new_opt, step=state["step"] + 1)
        return new_state, dict(loss=loss, **metrics)

    return train_step


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
