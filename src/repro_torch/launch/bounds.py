"""Least times of the LLM steps on one NVIDIA H100: the larger of the
bytes a step must move over HBM and its operations at the card's peak
rates (NVIDIA's data sheet, SXM part, dense).  A bound counts what any
implementation must do, never more: each weight read once a pass, each
input read and each output written once.

What the operations count:
  - matmuls at the bf16 rate: 2 a weight a token a pass (forward; 6 in a
    train step, forward and backward) over the decoder's 2-D weights,
    except the depthwise `conv_w` and `a_log` (2-D, no matmul); an MoE
    layer's experts at top_k of n_experts; zamba2's shared attention
    block at each site it runs (`i % k == k - 1`), not at every layer;
    causal attention's scores and mix over the pairs each layer's mask
    keeps (gemma2's local layers: the window).  The encoder (whisper) and the
    patch projection (vlm) are not counted.
  - the Mamba scan at the f32 rate, as element-wise work: the depthwise
    conv (2 a tap a channel a token) and the sequential recurrence a
    token, channel and state (Mamba-1: discretize dt*A, exp, times h,
    B*(dt*u), add, the readout's multiply and add, 7; Mamba-2, whose decay
    is one scalar a head: 5), three passes in a train step.
What the bytes count: every weight once a pass (but of the token table
only the rows looked up), the KV rows written, a decode step's KV read up
to its position (a local layer's within its window), an ssm decode
step's conv and ssm states read and written (prefill writes them), the
last logits written in f32; a train
step's weights twice (forward and backward), its gradients written, read
and written by the clip, and AdamW's read of parameter, clipped gradient
and both f32 moments and write of parameter and moments.
"""

from __future__ import annotations

from ..models.config import ModelConfig

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # H100 SXM data sheet, dense bf16
F32_FLOPS = 67e12                # H100 SXM data sheet, f32, no tensor cores
F64_FLOPS = 34e12                # H100 SXM data sheet, f64, no tensor cores
NOT_MATMUL = ("conv_w", "a_log")
SCAN_OPS = {"ssm": 7, "hybrid": 5}   # f32 ops a token, channel and state


def shared_sites(cfg: ModelConfig) -> int:
    """Layers after which zamba2's shared block runs."""
    k = cfg.shared_attn_every
    return cfg.n_layers // k if cfg.family == "hybrid" and k else 0


def attention_layers(cfg: ModelConfig) -> int:
    """Attention layers a token passes through (each with its KV rows)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return shared_sites(cfg)
    return cfg.n_layers


def attention_windows(cfg: ModelConfig) -> list:
    """Each attention layer's window (0: the whole prefix)."""
    n = attention_layers(cfg)
    if cfg.attn_type == "local_global":   # gemma2: even layers local
        return [0 if i % 2 == 1 else cfg.window for i in range(n)]
    return [0] * n


def causal_pairs(P: int, window: int) -> int:
    """Query-key pairs a causal mask keeps over P positions."""
    if not window or P <= window:
        return P * (P + 1) // 2
    return window * (window + 1) // 2 + (P - window) * window


def decoder_matmul_weights(model, cfg: ModelConfig) -> int:
    """Weights a token multiplies in one pass of the decoder stack (no
    head)."""
    n = 0
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if (p.dim() < 2 or leaf in NOT_MATMUL
                or not name.startswith(("layers.", "cross.",
                                        "shared_attn."))):
            continue
        k = p.numel()
        if ".moe." in name and leaf != "router":
            k = k * cfg.top_k // cfg.n_experts
        if name.startswith("shared_attn."):
            k *= shared_sites(cfg)
        n += k
    return n


def _head_weights(model, cfg) -> int:
    return (model.embed.tok if cfg.tie_embeddings
            else model.embed.head).numel()


def _ssm_state_bytes(cfg: ModelConfig, B: int, elt: int) -> int:
    """A decode's conv and ssm states (`model.make_cache`) for B rows."""
    if cfg.family not in SCAN_OPS:
        return 0
    di, ds = cfg.d_inner, cfg.ssm_state
    ch = di if cfg.family == "ssm" else di + 2 * ds
    return cfg.n_layers * B * ((cfg.d_conv - 1) * ch * elt + di * ds * 4)


def scan_ops(cfg: ModelConfig, tokens: int) -> int:
    """The Mamba layers' element-wise f32 work on `tokens` tokens, one
    pass."""
    if cfg.family not in SCAN_OPS:
        return 0
    di, ds = cfg.d_inner, cfg.ssm_state
    ch = di if cfg.family == "ssm" else di + 2 * ds
    per = SCAN_OPS[cfg.family] * di * ds + 2 * cfg.d_conv * ch
    return tokens * cfg.n_layers * per


def _timed(moved: int, ops: int, eops: int) -> dict:
    b_ms = moved / HBM_BYTES_PER_S * 1e3
    o_ms = (ops / BF16_FLOPS + eops / F32_FLOPS) * 1e3
    return dict(ms=max(b_ms, o_ms), bytes=moved, ops=ops,
                elementwise_ops=eops, bytes_ms=b_ms, ops_ms=o_ms,
                by="bytes" if b_ms >= o_ms else "operations")


def llm_bounds(model, cfg: ModelConfig, B: int, P: int, pos: int) -> dict:
    """Least ms of a prefill of [B, P] and of one decode step at `pos`
    (the KV of `pos` positions read) of `model` (any device, `meta`
    included)."""
    elt = model.embed.tok.element_size()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    tok = model.embed.tok.numel() * elt
    body = decoder_matmul_weights(model, cfg)
    head = cfg.vocab * cfg.d_model
    wins = attention_windows(cfg)
    row = 2 * cfg.n_kv_heads * cfg.hd * elt      # a layer's K and V a token
    kv_row = len(wins) * row
    att = 2 * 2 * cfg.n_heads * cfg.hd           # a query-key pair
    state = _ssm_state_bytes(cfg, B, elt)
    kv_read = sum(min(pos, w or pos) for w in wins) * B * row

    def bound(tokens, kv_read, state_moved, ops):
        moved = (wbytes - tok + tokens * cfg.d_model * elt
                 + tokens * kv_row + kv_read + state_moved
                 + B * cfg.vocab * 4)
        return _timed(moved, ops, scan_ops(cfg, tokens))

    n = B * P
    prefill = bound(n, 0, state, 2 * n * body + 2 * B * head
                    + att * B * sum(causal_pairs(P, w) for w in wins))
    decode = bound(B, kv_read, 2 * state, 2 * B * (body + head)
                   + att * B * sum(min(pos + 1, w or pos + 1) for w in wins))
    return dict(prefill=prefill, decode=decode, weight_bytes=wbytes)


def train_bounds(model, cfg: ModelConfig, tokens: int, seq: int) -> dict:
    """Least ms of one AdamW train step of `model` on `tokens` tokens in
    sequences of `seq`."""
    tok = model.embed.tok
    n = sum(p.numel() for p in model.parameters())
    e = tok.element_size()
    wbytes = n * e
    mat = decoder_matmul_weights(model, cfg) + _head_weights(model, cfg)
    reads = 2 * (wbytes - tok.numel() * e + tokens * cfg.d_model * e)
    grads = 3 * wbytes
    adamw = n * (2 * e + e + 16)
    att = 3 * 2 * 2 * cfg.n_heads * cfg.hd * (tokens // seq) * \
        sum(causal_pairs(seq, w) for w in attention_windows(cfg))
    out = _timed(reads + grads + adamw, 6 * mat * tokens + att,
                 3 * scan_ops(cfg, tokens))
    return dict(out, params=n, matmul_params=mat)

