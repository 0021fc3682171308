"""Unified decoder LM covering the attention families of the assigned
architectures.  Port of `repro/models/model.py`.

Families:
  dense        — llama-style pre-norm GQA + gated MLP (granite, command-r
                 [parallel block], internvl2 backbone)
  dense+gemma2 — alternating local/global attention, attn & logit softcaps,
                 post-norms
  moe          — router + sort-based capacity dispatch (granite-moe, grok)
  ssm          — mamba-1 stack (falcon-mamba)
  hybrid       — mamba-2 stack + ONE shared attention block applied every k
                 blocks (zamba2)
  audio        — whisper-style encoder-decoder (frontend stubbed)
  vlm          — dense backbone consuming precomputed patch embeds + tokens

The weights are one `LM` module whose layers are an `nn.ModuleList` of
per-layer modules (the reference stacks them under a scan).  Entry points
keep the reference's names and take the module where it takes the param
tree: init_params, params_from_reference, forward_train, loss_fn,
make_cache, prefill, decode_step.  The serving ones (prefill, decode_step)
run without autograd and write the KV cache in place at its position.
`param_tree` gives the module's parameters in the reference's tree, each
stacked leaf as the list of its per-layer tensors, and `host_tree` stacks
such a tree on the host into the reference's arrays.

Under autograd, `cfg.remat` maps onto `torch.utils.checkpoint` per layer,
as the reference's `_remat` wraps its scanned layer body: `none` keeps
every activation, `full` recomputes the whole layer in the backward, and
`dots` keeps the weight products (the `aten.mm` outputs of `L.mm`) and
recomputes the rest, as `checkpoint_dots_with_no_batch_dims` does (the
attention and expert einsums have batch dimensions and are recomputed).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import resolve_device
from . import layers as L
from . import mamba as M
from . import moe as X
from .config import ModelConfig, torch_dtype

SSM_FAMILIES = ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# modules and init
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One decoder layer of the attention families."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        d = cfg.d_model
        self.norm1 = init.zeros((d,))
        self.norm2 = init.zeros((d,))
        self.attn = L.Attention(cfg, init)
        if cfg.attn_type == "local_global":   # gemma2 post-norms
            self.post_norm1 = init.zeros((d,))
            self.post_norm2 = init.zeros((d,))
        if cfg.n_experts > 0:
            self.moe = X.MoE(cfg, init)
        else:
            self.mlp = L.MLP(cfg, init)


class SSMBlock(nn.Module):
    """One layer of the ssm (Mamba-1) and hybrid (Mamba-2) families."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.norm = init.zeros((cfg.d_model,))
        self.mamba = (M.Mamba if cfg.family == "ssm" else M.Mamba2)(cfg, init)


class EncoderBlock(nn.Module):
    """A whisper encoder layer; also zamba2's one shared attention block
    (`LM.shared_attn`)."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.norm1 = init.zeros((cfg.d_model,))
        self.norm2 = init.zeros((cfg.d_model,))
        self.attn = L.Attention(cfg, init)
        self.mlp = L.MLP(cfg, init)


class CrossBlock(nn.Module):
    """A decoder layer's cross-attention (whisper)."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.norm = init.zeros((cfg.d_model,))
        self.attn = L.Attention(cfg, init)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.embed = L.Embedding(cfg, init)
        block = SSMBlock if cfg.family in SSM_FAMILIES else Block
        self.layers = nn.ModuleList(block(cfg, init)
                                    for _ in range(cfg.n_layers))
        self.final_norm = init.zeros((cfg.d_model,))
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            self.shared_attn = EncoderBlock(cfg, init)
        if cfg.is_encdec:
            self.encoder = nn.ModuleList(EncoderBlock(cfg, init)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = init.zeros((cfg.d_model,))
            self.cross = nn.ModuleList(CrossBlock(cfg, init)
                                       for _ in range(cfg.n_layers))
        if cfg.frontend == "vision":
            # learned projection for the (stubbed) patch embeddings
            self.patch_proj = init.dense(cfg.d_model, cfg.d_model,
                                         torch_dtype(cfg.dtype))


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> LM:
    """The model with weights drawn on `device` (normals in f32, scaled,
    cast to `cfg.dtype` there: nothing is drawn on the host for a model on
    the card).  `generator` must live on that device; without one, a fresh
    generator seeded 0.  The port's draws are its own: weights equal to the
    reference's come through `params_from_reference`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return LM(cfg, L.Init(dev, generator))


_STACKED = ("layers", "encoder", "cross")


def leaves_with_path(tree, prefix=()):
    """(path of keys, leaf) of each leaf of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_with_path(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy


def params_from_reference(cfg: ModelConfig, tree, device="cuda") -> LM:
    """The port's module holding the reference's `init_params` tree: a
    nested dict of numpy arrays in which `layers`, `encoder` and `cross`
    carry a leading layer axis (the reference's vmapped stacks).  Every
    parameter must be set, with the reference's shape and dtype."""
    dev = resolve_device(device)
    model = LM(cfg, L.Init(dev))
    unset = {n for n, _ in model.named_parameters()}

    def put(name, a):
        p = model.get_parameter(name)
        t = _to_torch(a)
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{name}: reference {tuple(t.shape)} {t.dtype}, "
                             f"port {tuple(p.shape)} {p.dtype}")
        p.copy_(t)
        unset.discard(name)

    with torch.no_grad():
        for path, a in leaves_with_path(tree):
            if path[0] in _STACKED:
                for i in range(np.shape(a)[0]):
                    put(".".join((path[0], str(i)) + path[1:]), a[i])
            else:
                put(".".join(path), a)
    if unset:
        raise ValueError(f"the reference tree leaves {sorted(unset)} unset")
    return model


def param_tree(model: LM) -> dict:
    """The module's parameters (its own tensors) in the reference's
    `init_params` tree: nested dicts keyed as there, where a stacked leaf
    (`layers`, `encoder`, `cross`) is the list of its per-layer
    parameters in layer order."""
    tree = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        stacked = parts[0] in _STACKED
        path = (parts[0],) + tuple(parts[2:]) if stacked else tuple(parts)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if stacked:     # the ModuleList yields its layers in order
            node.setdefault(path[-1], []).append(p)
        else:
            node[path[-1]] = p
    return tree


def host_tree(tree, to_numpy) -> dict:
    """A tree of tensors and stacks (`param_tree`'s layout) as the
    reference's arrays: each tensor through `to_numpy`, each stack's
    slices stacked on the host along a leading axis."""
    if isinstance(tree, dict):
        return {k: host_tree(v, to_numpy) for k, v in tree.items()}
    if isinstance(tree, list):
        return np.stack([to_numpy(t) for t in tree])
    return to_numpy(tree)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _is_global_layer(cfg, i):
    # gemma2: alternate local (even) / global (odd)
    return (i % 2) == 1


def _window(cfg, i) -> int:
    if cfg.attn_type == "local_global" and not _is_global_layer(cfg, i):
        return cfg.window
    return 0


def _after_attn(pl_: Block, cfg, x, a, pc=None, enc=None):
    """The rest of a decoder layer once its self-attention output `a` is
    known: post-norm, the parallel block, residual, cross-attention
    (`pc` with `enc` = (enc_out, enc_positions, positions)), MLP or MoE."""
    if cfg.attn_type == "local_global":
        a = L.rms_norm(a, pl_.post_norm1, cfg.norm_eps)
    if cfg.parallel_block:
        m = L.mlp(pl_.mlp, cfg, L.rms_norm(x, pl_.norm2, cfg.norm_eps))
        return x + a + m, 0.0
    x = x + a
    if pc is not None:
        enc_out, enc_positions, positions = enc
        hh = L.rms_norm(x, pc.norm, cfg.norm_eps)
        x = x + L.attention(pc.attn, cfg, hh, positions,
                            cross_kv=_cross_kv(pc.attn, cfg, enc_out),
                            kv_positions=enc_positions)
    h = L.rms_norm(x, pl_.norm2, cfg.norm_eps)
    if cfg.n_experts > 0:
        m, aux = X.moe_block(pl_.moe, cfg, h)
    else:
        m, aux = L.mlp(pl_.mlp, cfg, h), 0.0
    if cfg.attn_type == "local_global":
        m = L.rms_norm(m, pl_.post_norm2, cfg.norm_eps)
    return x + m, aux


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


_SAVED_BY_DOTS = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_BY_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(f, cfg: ModelConfig):
    """`f` (one layer) under the reference's `_remat` rule, when autograd
    records: a checkpointed call for `full` and `dots`."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return f
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, f, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, f, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _decoder_layer(pl_: Block, pc, cfg, i, x, positions, rot, enc, h=None):
    """One decoder layer: (x, aux).  `h` is its first norm when the caller
    has it."""
    if h is None:
        h = L.rms_norm(x, pl_.norm1, cfg.norm_eps)
    a = L.attention(pl_.attn, cfg, h, positions, causal=True,
                    window=_window(cfg, i), rot=rot)
    # whisper: self-attn -> cross-attn -> FFN
    return _after_attn(pl_, cfg, x, a, pc, enc)


def _is_shared_site(cfg, i) -> bool:
    """Whether zamba2's shared attention block runs after layer `i`."""
    k = cfg.shared_attn_every
    return bool(k) and i % k == k - 1


def _ssm_layer(pl_: SSMBlock, shared, cfg, i, x, positions, rot, fill):
    """One ssm/hybrid layer and, at a shared site, the shared attention
    block: (x, its (conv, ssm) state, the shared block's rotated (k, v)
    when `fill` and the block ran)."""
    blk = M.mamba_block if cfg.family == "ssm" else M.mamba2_block
    h = L.rms_norm(x, pl_.norm, cfg.norm_eps)
    y, st = blk(pl_.mamba, cfg, h)
    x = x + y
    kv = None
    if shared is not None and _is_shared_site(cfg, i):
        h = L.rms_norm(x, shared.norm1, cfg.norm_eps)
        if fill:
            kv = L.project_kv(shared.attn, cfg, h, positions, rot)
        x = x + L.attention(shared.attn, cfg, h, positions, causal=True,
                            rot=rot)
        h = L.rms_norm(x, shared.norm2, cfg.norm_eps)
        x = x + L.mlp(shared.mlp, cfg, h)
    return x, st, kv


def _run_decoder(params: LM, cfg: ModelConfig, x, positions, *,
                 make_cache_out=False, enc_out=None, enc_positions=None):
    """Over the layers in order.  Returns (x, aux_loss, cache or None).

    cache (when make_cache_out): per-layer rotated (k, v); for the ssm and
    hybrid families (per-layer (conv, ssm) states, per-site shared (k, v))."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = [] if make_cache_out else None
    if cfg.family in SSM_FAMILIES:
        shared = getattr(params, "shared_attn", None)
        rot = (L.rope_rotation(positions, cfg.hd, cfg.rope_theta)
               if shared is not None else None)
        layer = _remat(_ssm_layer, cfg)
        sites = []
        for i, pl_ in enumerate(params.layers):
            x, st, kv = layer(pl_, shared, cfg, i, x, positions, rot,
                              make_cache_out)
            if make_cache_out:
                cache.append(st)
                if kv is not None:
                    sites.append(kv)
        return x, aux, (cache, sites) if make_cache_out else None
    enc = (enc_out, enc_positions, positions)
    rot = L.rope_rotation(positions, cfg.hd, cfg.rope_theta)
    layer = _remat(_decoder_layer, cfg)
    for i, pl_ in enumerate(params.layers):
        pc = params.cross[i] if cfg.is_encdec else None
        h = None
        if make_cache_out:
            h = L.rms_norm(x, pl_.norm1, cfg.norm_eps)
            cache.append(L.project_kv(pl_.attn, cfg, h, positions, rot))
        x, a2 = layer(pl_, pc, cfg, i, x, positions, rot, enc, h)
        aux = aux + a2
    return x, aux, cache


def _cross_kv(pa: L.Attention, cfg, enc_out):
    b, t, _ = enc_out.shape
    hd = cfg.hd
    k = L.mm(enc_out, pa.wk).reshape(b, t, cfg.n_kv_heads, hd)
    v = L.mm(enc_out, pa.wv).reshape(b, t, cfg.n_kv_heads, hd)
    return k, v


def run_encoder(params: LM, cfg: ModelConfig, frames):
    """Whisper encoder over (stubbed) frame embeddings [B, T, D]."""
    b, t, _ = frames.shape
    positions = _positions(b, t, frames.device)
    x = frames
    layer = _remat(_encoder_layer, cfg)
    for pl_ in params.encoder:
        x = layer(pl_, cfg, x, positions)
    return L.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _encoder_layer(pl_: EncoderBlock, cfg, x, positions):
    h = L.rms_norm(x, pl_.norm1, cfg.norm_eps)
    x = x + L.attention(pl_.attn, cfg, h, positions, causal=False)
    h = L.rms_norm(x, pl_.norm2, cfg.norm_eps)
    return x + L.mlp(pl_.mlp, cfg, h)


def _inputs(params: LM, cfg, tokens, extra_embeds, enc_frames):
    """Embedded tokens (behind the projected patches for a vlm), their
    positions, and the encoder's output with its positions (enc-dec)."""
    b = tokens.shape[0]
    x = L.embed(params.embed, cfg, tokens)
    if cfg.family == "vlm" and extra_embeds is not None:
        patches = L.mm(extra_embeds, params.patch_proj)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    positions = _positions(b, x.shape[1], x.device)
    enc_out = enc_positions = None
    if cfg.is_encdec:
        enc_out = run_encoder(params, cfg, enc_frames)
        enc_positions = _positions(b, enc_out.shape[1], x.device)
    return x, positions, enc_out, enc_positions


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward_train(params: LM, cfg: ModelConfig, tokens, extra_embeds=None,
                  enc_frames=None):
    """tokens: [B,S] -> logits [B,S,V] (f32), aux loss."""
    s = tokens.shape[1]
    x, positions, enc_out, enc_positions = _inputs(
        params, cfg, tokens, extra_embeds, enc_frames)
    x, aux, _ = _run_decoder(params, cfg, x, positions, enc_out=enc_out,
                             enc_positions=enc_positions)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.family == "vlm" and extra_embeds is not None:
        x = x[:, -s:]           # logits over the text positions only
    return L.lm_logits(params.embed, cfg, x), aux


def loss_fn(params: LM, cfg, tokens, labels, extra_embeds=None,
            enc_frames=None):
    logits, aux = forward_train(params, cfg, tokens,
                                extra_embeds=extra_embeds,
                                enc_frames=enc_frames)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return nll.mean() + 0.01 * aux


# ---------------------------------------------------------------------------
# serving: cache creation, prefill, decode
# ---------------------------------------------------------------------------


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """The serving state and the next position (a host int), which
    `prefill` and `decode_step` write in place: per-layer K/V buffers
    [L, B, max_len, Hkv, hd]; for ssm, per-layer conv and ssm states; for
    hybrid, also the shared block's K/V at each of its sites."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    f32 = torch.float32
    if cfg.family == "ssm":
        di = cfg.d_inner
        return dict(conv=zeros((cfg.n_layers, batch, cfg.d_conv - 1, di)),
                    ssm=zeros((cfg.n_layers, batch, di, cfg.ssm_state), f32),
                    pos=0)
    if cfg.family == "hybrid":
        di = cfg.d_inner
        nh = M.n_ssm_heads(cfg)
        k = cfg.shared_attn_every
        n_sites = (cfg.n_layers + k - 1) // k if k else 0
        c = dict(conv=zeros((cfg.n_layers, batch, cfg.d_conv - 1,
                             di + 2 * cfg.ssm_state)),
                 ssm=zeros((cfg.n_layers, batch, nh, di // nh,
                            cfg.ssm_state), f32),
                 pos=0)
        if n_sites:
            shape = (n_sites, batch, max_len, cfg.n_kv_heads, cfg.hd)
            c["shared_k"] = zeros(shape)
            c["shared_v"] = zeros(shape)
        return c
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return dict(k=zeros(shape), v=zeros(shape), pos=0)


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens, cache, extra_embeds=None,
            enc_frames=None):
    """Run the prompt, fill the cache, return (last-token logits, cache)."""
    x, positions, enc_out, enc_positions = _inputs(
        params, cfg, tokens, extra_embeds, enc_frames)
    s_eff = x.shape[1]
    x, _, kv = _run_decoder(params, cfg, x, positions, make_cache_out=True,
                            enc_out=enc_out, enc_positions=enc_positions)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, cfg, x[:, -1:])
    if cfg.family in SSM_FAMILIES:
        states, sites = kv
        for i, (conv, ssm) in enumerate(states):
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
        # prefill writes the leading s_eff positions of the site caches
        for site, (k, v) in enumerate(sites):
            cache["shared_k"][site, :, :s_eff] = k
            cache["shared_v"][site, :, :s_eff] = v
    else:
        for i, (k, v) in enumerate(kv):
            cache["k"][i, :, :s_eff] = k
            cache["v"][i, :, :s_eff] = v
    cache = dict(cache, pos=s_eff)
    if enc_out is not None:
        cache["enc_out"] = enc_out
    return logits, cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token, cache):
    """One token for the whole batch.  token: [B, 1]."""
    b = token.shape[0]
    x = L.embed(params.embed, cfg, token)
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    if cfg.family in SSM_FAMILIES:
        x = _decode_ssm(params, cfg, x, positions, cache)
        x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
        return L.lm_logits(params.embed, cfg, x), dict(cache, pos=pos + 1)
    t = cache["k"].shape[2]
    ar = torch.arange(t, device=x.device)
    kv_pos = torch.where(ar <= pos, ar, -1).expand(b, t)

    enc = None
    enc_out = cache.get("enc_out")
    if enc_out is not None:
        enc = (enc_out, _positions(b, enc_out.shape[1], x.device), positions)

    # the rotation and the masks are the same in every layer: once a step
    rot = L.rope_rotation(positions, cfg.hd, cfg.rope_theta)
    masks = {w: L._mask(positions, kv_pos, True, w)
             for w in {_window(cfg, i) for i in range(cfg.n_layers)}}
    for i, pl_ in enumerate(params.layers):
        h = L.rms_norm(x, pl_.norm1, cfg.norm_eps)
        kk, vv = L.project_kv(pl_.attn, cfg, h, positions, rot)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, pos] = kk[:, 0]
        vc[:, pos] = vv[:, 0]
        w = _window(cfg, i)
        a = L.attention(pl_.attn, cfg, h, positions, kv=(kc, vc),
                        kv_positions=kv_pos, window=w, rot=rot,
                        mask=masks[w])
        pc = params.cross[i] if cfg.is_encdec else None
        x, _ = _after_attn(pl_, cfg, x, a, pc, enc)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = L.lm_logits(params.embed, cfg, x)
    return logits, dict(cache, pos=pos + 1)


def _decode_ssm(params: LM, cfg: ModelConfig, x, positions, cache):
    """The ssm/hybrid layers on one token: each layer's conv and ssm state
    updated in place, and at each shared site the shared block's K/V
    written at `pos` and attended over the positions up to it."""
    blk = M.mamba_block if cfg.family == "ssm" else M.mamba2_block
    shared = getattr(params, "shared_attn", None)
    pos = cache["pos"]
    if shared is not None:
        b, t = x.shape[0], cache["shared_k"].shape[2]
        ar = torch.arange(t, device=x.device)
        kv_pos = torch.where(ar <= pos, ar, -1).expand(b, t)
        rot = L.rope_rotation(positions, cfg.hd, cfg.rope_theta)
        mask = L._mask(positions, kv_pos, True, 0)
    for i, pl_ in enumerate(params.layers):
        h = L.rms_norm(x, pl_.norm, cfg.norm_eps)
        y, (conv, ssm) = blk(pl_.mamba, cfg, h,
                             (cache["conv"][i], cache["ssm"][i]))
        cache["conv"][i] = conv
        cache["ssm"][i] = ssm
        x = x + y
        if shared is not None and _is_shared_site(cfg, i):
            site = i // cfg.shared_attn_every
            h = L.rms_norm(x, shared.norm1, cfg.norm_eps)
            kk, vv = L.project_kv(shared.attn, cfg, h, positions, rot)
            sk, sv = cache["shared_k"][site], cache["shared_v"][site]
            sk[:, pos] = kk[:, 0]
            sv[:, pos] = vv[:, 0]
            x = x + L.attention(shared.attn, cfg, h, positions, kv=(sk, sv),
                                kv_positions=kv_pos, rot=rot, mask=mask)
            h = L.rms_norm(x, shared.norm2, cfg.norm_eps)
            x = x + L.mlp(shared.mlp, cfg, h)
    return x
