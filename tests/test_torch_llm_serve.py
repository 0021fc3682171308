"""The port's serving launcher (`repro_torch.launch.serve`) on the CPU
against the JAX package's serve steps.

`main([... "--reduced", "--device", "cpu"])` serves its requests through
the session table behind the front-end and returns its model, prompts and
generated tokens.  The model's weights are carried into the reference's
tree, and the reference's jitted prefill and greedy decode steps
(`repro/train/step.py`) on the same prompts must generate the same tokens,
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs
from repro.models import model as JM
from repro.train import step as JSTEP
from repro_torch.launch import serve as LS
from repro_torch.models import model as MDL

ARGS = ["--reduced", "--device", "cpu", "--requests", "8", "--batch", "4",
        "--prompt-len", "8", "--tokens", "4", "--frontend-threads", "4"]


def _reference_tree(model) -> dict:
    """The port's weights as the reference's `init_params` tree (per-layer
    modules stacked along a leading axis)."""
    return jax.tree.map(jnp.asarray, MDL.host_tree(
        MDL.param_tree(model), lambda t: t.detach().numpy()))


def _reference_generate(cfg, params, prompts, batch, tokens) -> np.ndarray:
    prefill = jax.jit(JSTEP.make_prefill_step(cfg))
    decode = jax.jit(JSTEP.make_decode_step(cfg))
    max_len = prompts.shape[1] + tokens + 1
    kw = {}
    if cfg.family == "vlm":
        kw["extra_embeds"] = jnp.zeros((batch, cfg.frontend_seq,
                                        cfg.d_model), jnp.float32)
        max_len += cfg.frontend_seq
    if cfg.is_encdec:
        kw["enc_frames"] = jnp.zeros((batch, cfg.frontend_seq, cfg.d_model),
                                     jnp.float32)
    out = []
    for i in range(0, len(prompts), batch):
        cache = JM.make_cache(cfg, batch, max_len)
        logits, cache = prefill(
            params, dict(tokens=jnp.asarray(prompts[i:i + batch]), **kw),
            cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        outs = [np.asarray(tok)]
        for _ in range(tokens - 1):
            tok, logits, cache = decode(params, tok, cache)
            outs.append(np.asarray(tok))
        out.append(np.concatenate(outs, axis=1))
    return np.concatenate(out)


@pytest.mark.parametrize("arch", list_archs())
def test_served_tokens_equal_reference_steps(arch, capsys):
    rep = LS.main(["--arch", arch] + ARGS)
    out = capsys.readouterr().out
    assert "[serve] " in out and "8 requests x 4 tokens" in out
    cfg = rep["cfg"]
    assert rep["prompts"].shape == (8, 8)
    assert rep["generated"].shape == (8, 4)
    assert rep["logits_finite"]
    assert ((rep["generated"] >= 0) & (rep["generated"] < cfg.vocab)).all()
    # every session went through the front-end's batcher, none shed
    st = rep["frontend"]
    assert st["n_batches"] > 0 and st["shed_ops"] == 0
    assert st["accepted_ops"] >= 8 * 4     # admit and evict: get + write
    # each session resolves to the KV slot its admit handed out
    for b in rep["slots"]:
        assert np.array_equal(b["resolved"], b["admitted"])
    ref_cfg = get_config(arch).reduced()
    want = _reference_generate(ref_cfg, _reference_tree(rep["model"]),
                               rep["prompts"], 4, 4)
    assert np.array_equal(rep["generated"], want)


def test_sessions_resolve_to_their_admitted_slots():
    """The hook sees each batch's table before its evictions: the facade
    read there, the launcher's own lookup and the admits agree, and a
    batch's slots are distinct."""
    seen = []

    def on_lookup(sessions, ids):
        seen.append((np.asarray(ids),) + sessions.index.lookup(ids))

    rep = LS.main(["--arch", "granite-8b"] + ARGS, on_lookup=on_lookup)
    assert len(rep["slots"]) == len(seen) == 2
    for b, (ids, vals, found) in zip(rep["slots"], seen):
        assert np.array_equal(b["ids"], ids)
        assert found.all() and np.array_equal(vals, b["admitted"])
        assert np.array_equal(b["resolved"], b["admitted"])
        assert len(set(b["admitted"].tolist())) == len(ids)


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        LS.main(["--reduced"])
