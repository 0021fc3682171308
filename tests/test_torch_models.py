"""The port's LLM models (`repro_torch.models`, `repro_torch.train.step`)
against the JAX package on the CPU.

Both packages run on the same weights: the reference's `init_params` tree
carried into the port's module by `params_from_reference`.  Inputs come from
numpy seeds.  At f32, torch's CPU matmuls and XLA's agree to rounding, so
logits are held to `ATOL_F32` absolute (the largest gap measured over these
cases is 5.3e-6, granite-8b's forward, with logits up to 4.5 in magnitude)
and greedy tokens must be equal.  The one bf16 case is held to `RTOL_BF16`
of the largest logit (measured: 1.2e-2 in its forward).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config, list_archs
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JX
from repro.train import step as JSTEP
from repro_torch.configs import get_config, list_archs as port_archs
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models import moe as X
from repro_torch.models.config import torch_dtype
from repro_torch.train import step as STEP

ARCHS = list_archs()
ATOL_F32 = 1e-4      # f32 logits, port against reference
RTOL_BF16 = 3e-2     # bf16 logits, relative to the largest |logit|
ATOL_ATTN = 2e-5     # the reference's own flash-against-dense tolerance
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _case(arch: str, **overrides):
    """(reference cfg, port cfg, reference params, port module) for the
    reduced config, the port holding the reference's weights."""
    cfg = ref_config(arch).reduced(**overrides)
    tcfg = get_config(arch).reduced(**overrides)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    model = MDL.params_from_reference(tcfg, _np_tree(params), device=CPU)
    return cfg, tcfg, params, model


def _inputs(cfg, B, S, seed=0):
    """Tokens and the frontend stubs as numpy arrays."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    kw = {}
    if cfg.family == "vlm":
        kw["extra_embeds"] = rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        kw["enc_frames"] = rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return tokens, kw


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _close(got: torch.Tensor, want, atol=ATOL_F32):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    assert port_archs() == ARCHS
    for a, b in ((get_config(arch), ref_config(arch)),
                 (get_config(arch).reduced(), ref_config(arch).reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.hd == b.hd and a.d_inner == b.d_inner
    assert get_config(arch.replace("_", "-")) == get_config(arch)


def test_torch_dtype_and_unported_families():
    """The dtype map, and the ssm and hybrid families (no config in
    `configs/` has them) building with their caches on the CPU."""
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        torch_dtype("float16")
    base = get_config("granite_8b").reduced()
    for family, kw in (("ssm", dict(ssm_state=8)),
                       ("hybrid", dict(ssm_state=8, ssm_heads=4,
                                       shared_attn_every=2, n_layers=3))):
        cfg = dataclasses.replace(base, family=family, **kw)
        model = MDL.init_params(cfg, device=CPU)
        assert len(model.layers) == cfg.n_layers
        assert hasattr(model, "shared_attn") == (family == "hybrid")
        cache = MDL.make_cache(cfg, 1, 4, device=CPU)
        assert cache["pos"] == 0 and cache["ssm"].dtype == torch.float32
        assert cache["conv"].shape[:3] == (cfg.n_layers, 1, cfg.d_conv - 1)
        if family == "hybrid":   # ceil(3 / 2) sites
            assert cache["shared_k"].shape == (2, 1, 4, cfg.n_kv_heads,
                                               cfg.hd)


def test_params_from_reference_checks_the_tree():
    cfg, tcfg, params, model = _case("granite_8b")
    tree = _np_tree(params)
    names = {n for n, _ in model.named_parameters()}
    assert "layers.1.attn.wq" in names and "embed.head" in names
    torch.testing.assert_close(model.layers[1].mlp.w_gate,
                               torch.from_numpy(tree["layers"]["mlp"]
                                                ["w_gate"][1]))
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        MDL.params_from_reference(tcfg, tree, device=CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    cfg, tcfg, params, model = _case(arch)
    tokens, kw = _inputs(cfg, 2, 24)
    want, want_aux = jax.jit(JM.forward_train, static_argnums=1)(
        params, cfg, jnp.asarray(tokens), **_j(kw))
    got, got_aux = MDL.forward_train(model, tcfg, torch.from_numpy(tokens),
                                     **_t(kw))
    assert got.shape == (2, 24, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=1e-5)
    labels = np.roll(tokens, -1, axis=1)
    want_loss = JM.loss_fn(params, cfg, jnp.asarray(tokens),
                           jnp.asarray(labels), **_j(kw))
    got_loss = MDL.loss_fn(model, tcfg, torch.from_numpy(tokens),
                           torch.from_numpy(labels), **_t(kw))
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=1e-5)


def _max_len(cfg, S, steps):
    return S + steps + 1 + (cfg.frontend_seq if cfg.family == "vlm" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    """Prefill, then 4 greedy decode steps: equal tokens at every step and
    logits within ATOL_F32."""
    cfg, tcfg, params, model = _case(arch)
    B, S, steps = 2, 12, 4
    tokens, kw = _inputs(cfg, B, S, seed=1)
    j_pre = jax.jit(JSTEP.make_prefill_step(cfg))
    j_dec = jax.jit(JSTEP.make_decode_step(cfg))
    jl, jc = j_pre(params, dict(tokens=jnp.asarray(tokens), **_j(kw)),
                   JM.make_cache(cfg, B, _max_len(cfg, S, steps)))
    tl, tc = STEP.make_prefill_step(tcfg)(
        model, dict(tokens=torch.from_numpy(tokens), **_t(kw)),
        MDL.make_cache(tcfg, B, _max_len(cfg, S, steps), device=CPU))
    _close(tl, jl)
    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    t_dec = STEP.make_decode_step(tcfg)
    for _ in range(steps):
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        jt, jl, jc = j_dec(params, jt, jc)
        tt, tl, tc = t_dec(model, tt, tc)
        _close(tl, jl)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert tc["pos"] == int(jc["pos"])
    _close(tc["k"][:, :, :tc["pos"]], jc["k"][:, :, :int(jc["pos"])])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's own property on the port alone: decode's logits for
    the last token equal the full forward's there (2e-2 relative)."""
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = MDL.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    B, S = 2, 21
    tokens, kw = _inputs(cfg, B, S, seed=2)
    tokens, kw = torch.from_numpy(tokens), _t(kw)
    full, _ = MDL.forward_train(model, cfg, tokens, **kw)
    cache = MDL.make_cache(cfg, B, _max_len(cfg, S, 3), device=CPU)
    _, cache = MDL.prefill(model, cfg, tokens[:, :S - 1], cache, **kw)
    lg, cache = MDL.decode_step(model, cfg, tokens[:, S - 1:S], cache)
    rel = float((full[:, -1] - lg[:, 0]).abs().max()) \
        / (float(full[:, -1].abs().max()) + 1e-9)
    assert rel < 2e-2, rel


def _attn_case(arch, key, S, B, **cfg_overrides):
    cfg = dataclasses.replace(ref_config(arch).reduced(), **cfg_overrides)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **cfg_overrides)
    p = JL.init_attention(jax.random.PRNGKey(key), cfg)
    tp = L.Attention(tcfg, L.Init(CPU))
    for n, a in _np_tree(p).items():
        getattr(tp, n).copy_(torch.from_numpy(a))
    rng = np.random.default_rng(key)
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    return cfg, tcfg, p, tp, x, pos


@pytest.mark.parametrize("arch,window,softcap", [
    ("granite_8b", 0, 0.0), ("gemma2_2b", 13, 50.0)])
def test_flash_equals_dense_attention(monkeypatch, arch, window, softcap):
    """The reference's flash tests on the port: chunks patched small (q 32
    or 16, kv 16: padded, several chunks), flash equal to dense within the
    reference's 2e-5, and dense equal to the reference's."""
    over = dict(attn_softcap=softcap) if softcap else {}
    S, B = (96, 2) if not window else (80, 1)
    cfg, tcfg, p, tp, x, pos = _attn_case(arch, 3 + bool(window), S, B,
                                          **over)
    want = JL.attention(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                        causal=True, window=window)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())
    dense = L.attention(tp, tcfg, tx, tpos, causal=True, window=window)
    _close(dense, want, atol=ATOL_ATTN)
    monkeypatch.setattr(L, "FLASH_THRESHOLD", 1)
    monkeypatch.setattr(L, "FLASH_Q_CHUNK", 16 if window else 32)
    monkeypatch.setattr(L, "FLASH_KV_CHUNK", 16)
    flash = L.attention(tp, tcfg, tx, tpos, causal=True, window=window)
    torch.testing.assert_close(flash, dense, atol=ATOL_ATTN, rtol=0)


def test_norms_match_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    _close(L.rms_norm(tx, tw, 1e-5), JL.rms_norm(x, w, 1e-5), atol=1e-5)
    _close(L.layer_norm(tx, tw, tb, 1e-5), JL.layer_norm(x, w, b, 1e-5),
           atol=1e-5)


def test_rope_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1000, 1040), (2, 40))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       10000.0)
    _close(got, want, atol=1e-5)
    assert np.array_equal(L.rope_freqs(32, 10000.0),
                          JL.rope_freqs(32, 10000.0))


def _moe_case(T=24, seed=7, **overrides):
    cfg = ref_config("granite_moe_1b_a400m").reduced(**overrides)
    tcfg = get_config("granite_moe_1b_a400m").reduced(**overrides)
    p = _np_tree(JX.init_moe(jax.random.PRNGKey(seed), cfg))
    tp = X.MoE(tcfg, L.Init(CPU))
    for n, a in p.items():
        getattr(tp, n).copy_(torch.from_numpy(a))
    x = np.random.default_rng(seed).standard_normal(
        (2, T // 2, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, p, tp, x


def _moe_both(cfg, tcfg, p, tp, x):
    want, want_aux = JX.moe_block(jax.tree.map(jnp.asarray, p), cfg,
                                  jnp.asarray(x))
    got, got_aux = X.moe_block(tp, tcfg, torch.from_numpy(x))
    _close(got, want, atol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    return np.asarray(want), got, float(got_aux)


def _loads(cfg, p, x):
    """Assignments per expert, as the reference routes them."""
    probs = jax.nn.softmax(x.reshape(-1, cfg.d_model) @ p["router"], -1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    return np.bincount(np.asarray(idx).ravel(), minlength=cfg.n_experts)


def _capacity(cfg, T):
    K, E = cfg.top_k, cfg.n_experts
    return max(int(math.ceil(T * K / E * cfg.capacity_factor)),
               min(T * K, 16), 1)


@pytest.mark.parametrize("capacity_factor,drops", [(8.0, False),
                                                   (1.25, True)])
def test_moe_matches_reference(capacity_factor, drops):
    """granite-moe reduced (E=8, K=2) at B=2, S=24: capacity 16 drops
    assignments (an expert gets 17 or more); capacity factor 8 drops none."""
    cfg, tcfg, p, tp, x = _moe_case(T=48, capacity_factor=capacity_factor)
    assert (_loads(cfg, p, x).max() > _capacity(cfg, 48)) == drops
    _moe_both(cfg, tcfg, p, tp, x)


def _routed(first, second, d, E):
    """A router and tokens for which token t picks experts first[t], then
    second[t] (each token a scaled basis vector of its own)."""
    T = len(first)
    router = np.zeros((d, E), np.float32)
    x = np.zeros((T, d), np.float32)
    for t in range(T):
        x[t, t] = 1.0 + 0.01 * t
        router[t, first[t]] = 6.0
        router[t, second[t]] = 3.0
    return router, x.reshape(1, T, d)


@pytest.mark.parametrize("last_expert_drops", [True, False])
def test_moe_collision_row_follows_reference(last_expert_drops):
    """The reference's gather writes every dropped assignment's zeros to row
    E*C-1, which is also the last expert's rank C-1 slot.  XLA on the CPU
    applies duplicate indices in update order: when the last expert itself
    overflows, its dropped assignments come last and that kept token's
    row ends as zeros (its expert-7 term is lost); when only earlier
    experts overflow, the kept token wins.  The port reproduces both."""
    cfg, tcfg, p, tp, _ = _moe_case()
    E, T = cfg.n_experts, 24
    C = _capacity(cfg, T)
    assert C == 16
    if last_expert_drops:        # expert 7 first for all 24 tokens
        first, second = [E - 1] * T, [t % (E - 1) for t in range(T)]
    else:                        # expert 7 exactly full; expert 0 overflows
        first = [E - 1] * 16 + [0] * 8
        second = [0] * 16 + [1] * 8
    p["router"], x = _routed(first, second, cfg.d_model, E)
    tp.router.copy_(torch.from_numpy(p["router"]))
    loads = _loads(cfg, p, x)
    assert (loads[E - 1] > C) == last_expert_drops and loads.max() > C
    want, got, _ = _moe_both(cfg, tcfg, p, tp, x)
    # token 15 holds expert 7's rank C-1 slot: its output with expert 7's
    # term and without it
    one = dataclasses.replace(cfg, n_experts=E, top_k=1)
    xt = jnp.asarray(x[:, 15:16])
    only_second = dict(p, router=np.where(
        np.arange(E) == second[15], 10.0, -10.0).astype(np.float32)[None]
        .repeat(cfg.d_model, 0))
    second_term, _ = JX.moe_block(jax.tree.map(jnp.asarray, only_second),
                                  one, xt)
    probs = jax.nn.softmax(jnp.asarray(x[0, 15]) @ p["router"])
    g2 = float(probs[second[15]] / (probs[E - 1] + probs[second[15]]))
    lost = np.allclose(want[0, 15], g2 * np.asarray(second_term)[0, 0],
                       atol=1e-6)
    assert lost == last_expert_drops


def test_moe_aux_loss_matches_reference():
    cfg, tcfg, p, tp, x = _moe_case(T=32)
    _, _, aux = _moe_both(cfg, tcfg, p, tp, x)
    assert aux >= 0.99   # E * sum f*p >= 1 by Cauchy-Schwarz


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25] * 4], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = X.top_k(torch.from_numpy(probs), 3)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


def test_bf16_forward_and_decode_match_reference():
    """granite-8b reduced in bf16 (its own dtype): logits within RTOL_BF16
    of the largest |logit| in forward_train, prefill and two decode steps,
    with equal greedy tokens."""
    cfg, tcfg, params, model = _case("granite_8b", dtype="bfloat16")
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    tokens, _ = _inputs(cfg, 2, 16, seed=3)

    def rel(got, want):
        want = np.asarray(want, np.float32)
        return float(np.abs(got.float().numpy() - want).max()
                     / np.abs(want).max())

    want, _ = jax.jit(JM.forward_train, static_argnums=1)(
        params, cfg, jnp.asarray(tokens))
    got, _ = MDL.forward_train(model, tcfg, torch.from_numpy(tokens))
    assert rel(got, want) < RTOL_BF16
    jl, jc = jax.jit(JSTEP.make_prefill_step(cfg))(
        params, dict(tokens=jnp.asarray(tokens)), JM.make_cache(cfg, 2, 20))
    tl, tc = STEP.make_prefill_step(tcfg)(
        model, dict(tokens=torch.from_numpy(tokens)),
        MDL.make_cache(tcfg, 2, 20, device=CPU))
    assert tc["k"].dtype == torch.bfloat16
    assert rel(tl, jl) < RTOL_BF16
    j_dec, t_dec = jax.jit(JSTEP.make_decode_step(cfg)), \
        STEP.make_decode_step(tcfg)
    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = torch.from_numpy(np.asarray(jt))
    for _ in range(2):
        jt, jl, jc = j_dec(params, jt, jc)
        tt, tl, tc = t_dec(model, tt, tc)
        assert rel(tl, jl) < RTOL_BF16
        assert np.array_equal(tt.numpy(), np.asarray(jt))


def test_init_params_draws_on_the_device_from_its_generator():
    cfg = get_config("granite_8b").reduced()
    a = MDL.init_params(cfg, torch.Generator().manual_seed(4), device=CPU)
    b = MDL.init_params(cfg, torch.Generator().manual_seed(4), device=CPU)
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
        assert not x.requires_grad
    assert float(a.layers[0].norm1.abs().sum()) == 0.0
    assert abs(float(a.embed.tok.std()) - 0.02) < 2e-3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MDL.init_params(cfg)
