"""The port's examples on the CPU against the JAX package.

Each ported DILI example's `main` runs at 20,000 keys with `--device cpu`; the
facts it prints (found counts and correctness, average range hits, the
epoch, mean probes) must equal what the reference's facade and baselines
give on the same keys, called in-process here (the reference's sharded
engine on its one JAX device, the port's on 8 shards: results are the
same on every engine and shard count).  The LLM serving example's session
table must end with the host DILI's stats that the reference's session
table gives for the same admits, lookups and evicts.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from repro.api import IndexConfig, LearnedIndex
from repro.core import search as JS
from repro.core.baselines import BinS, RMI
from repro.data.datasets import generate
from repro.serve.sessions import SessionTable

ROOT = Path(__file__).resolve().parents[1]
N_KEYS = 20_000


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, capsys, *argv) -> str:
    capsys.readouterr()
    _example(name).main(["--device", "cpu", "--keys", str(N_KEYS), *argv])
    return capsys.readouterr().out


def _quickstart_facts() -> list:
    """The quickstart's steps through the reference, as the lines the
    port's example must print."""
    keys = generate("logn", N_KEYS, seed=1)
    vals = np.arange(len(keys), dtype=np.int64)
    ix = LearnedIndex.build(keys, vals, config=IndexConfig(
        engine="local", sample_stride=4))
    rng = np.random.default_rng(0)
    q = keys[rng.integers(0, len(keys), 8192)]
    _, found = ix.lookup(q)
    assert found.all()
    starts = rng.integers(0, len(keys) - 101, 1024)
    _, _, cnt = ix.range(keys[starts], keys[starts + 100], max_hits=128)
    new = np.setdiff1d(np.unique(rng.uniform(keys[0], keys[-1], 1000)), keys)
    ix.upsert(new, 10_000_000 + np.arange(len(new)))
    ix.delete(keys[5])
    _, f2 = ix.lookup(new)
    _, fdel = ix.lookup(keys[5])
    lines = [f"bulk load: {len(keys):,} keys in ",
             "batched lookup: 8192/8192 found; ",
             f"range: 1024 x 100-key windows, avg hits "
             f"{float(cnt.mean()):.1f}\n",
             f"after {len(new)} upserts + 1 delete (pre-flush): new keys "
             f"found = {bool(f2.all())}, deleted hidden = {not fdel[0]}\n"]
    ix.flush()
    _, f2 = ix.lookup(new)
    lines.append(f"after flush: new keys found = {bool(f2.all())}; "
                 f"epoch = {ix.epoch}\n")
    qd = jnp.asarray(q)
    for B in (BinS, RMI):
        _, fb, pr = B.lookup(B.device(B.build(keys, vals)), qd)
        lines.append(f"{B.name}: found={bool(np.asarray(fb).all())}, "
                     f"avg probes={float(np.asarray(pr).mean()):.1f}\n")
    _, _, nodes, probes = JS.search_batch(ix.snapshot, qd, with_stats=True)
    lines.append(f"DILI: avg nodes={float(np.asarray(nodes).mean()):.2f}, "
                 f"avg probes={float(np.asarray(probes).mean()):.2f}\n")
    return lines


def test_quickstart_facts_equal_reference(capsys):
    out = _run("quickstart_torch", capsys)
    for line in _quickstart_facts():
        assert line in out, (line, out)


def _distributed_facts() -> list:
    keys = generate("books", N_KEYS, seed=2)
    rng = np.random.default_rng(1)
    qi = rng.integers(0, len(keys), 8192)
    q = keys[qi]
    lines = []
    for strategy in ("gather", "a2a"):
        ix = LearnedIndex.build(keys, config=IndexConfig(
            engine="sharded", sample_stride=4, lookup_strategy=strategy))
        v, f = ix.lookup(q)
        lines.append(f"{strategy:7s}: found {int(f.sum())}/{len(f)} "
                     f"correct={np.array_equal(v[f], qi[f])}  ")
        if strategy != "gather":
            continue
        new = np.setdiff1d(np.unique(rng.uniform(keys[0], keys[-1], 2000)),
                           keys)[:1024]
        ix.upsert(new, 5_000_000 + np.arange(len(new)))
        ix.delete(keys[qi[:256]])
        _, fn = ix.lookup(new)
        _, fd = ix.lookup(np.unique(keys[qi[:256]]))
        lines.append(f"         upserts visible={bool(fn.all())}, "
                     f"deletes hidden={not fd.any()}  (pre-merge)\n")
        ix.flush()
        lines.append(f"         after flush: epoch={ix.epoch}  "
                     f"stats={ix.stats()['pending_writes']} pending\n")
        starts = rng.integers(0, len(keys) - 101, 4096)
        ix2 = LearnedIndex.build(keys, config=IndexConfig(
            engine="sharded", sample_stride=4))
        _, _, counts = ix2.range(keys[starts], keys[starts + 100],
                                 max_hits=128)
        lines.append(f"range  : {len(starts)} x 100-key windows, "
                     f"avg hits {float(counts.mean()):.1f}  ")
    return lines


def test_distributed_facts_equal_reference(capsys):
    out = _run("distributed_index_torch", capsys)
    assert "shards: 8\n" in out
    for line in _distributed_facts():
        assert line in out, (line, out)


def _serve_llm_facts(requests: int, batch: int, tokens: int) -> list:
    """The example's session traffic through the reference's table."""
    sessions = SessionTable(n_slots=batch + 4)
    rid = 1000.0
    for _ in range(0, requests, batch):
        ids = []
        for _ in range(batch):
            rid += 1.0
            sessions.admit(rid)
            ids.append(rid)
        _, found = sessions.lookup_batch(ids)
        assert found.all()
        for i in ids:
            sessions.evict(i)
    return [f"[serve] {requests} requests, {requests * tokens} generated "
            f"tokens in ",
            f"[serve] session-table stats: {sessions.dili.stats()}\n"]


def test_serve_llm_facts_equal_reference(capsys):
    capsys.readouterr()
    _example("serve_llm_torch").main(["--device", "cpu", "--requests", "16",
                                      "--batch", "8", "--tokens", "4"])
    out = capsys.readouterr().out
    for line in _serve_llm_facts(16, 8, 4):
        assert line in out, (line, out)


def test_train_lm_store_and_batches_equal_reference():
    """The training example's corpus (`build_store` at the `cpu` preset)
    and its `StorePipeline` batches, bit for bit against the reference's
    example."""
    ref, port = _example("train_lm"), _example("train_lm_torch")
    jstore, jkeys = ref.build_store(ref.build_cfg("cpu"))
    store, keys = port.build_store(port.build_cfg("cpu"), device="cpu")
    assert np.array_equal(keys, jkeys)
    assert np.array_equal(store.arena, jstore.arena)
    jp = ref.StorePipeline(jstore, jkeys, seq_len=64, batch=4)
    tp = port.StorePipeline(store, keys, seq_len=64, batch=4)
    for step in (0, 1, 9):
        a, b = jp.batch_at(step), tp.batch_at(step)
        for k in ("tokens", "labels"):
            assert np.array_equal(a[k], b[k])
    store.index.close()


def test_train_lm_fails_and_resumes(tmp_path, capsys):
    """`--fail-at-step 3` exits 42 after the step-2 checkpoint; the rerun
    resumes there and ends on the uninterrupted run's losses and weights,
    exactly (the CPU's ops are deterministic)."""
    import pytest
    import torch
    mod = _example("train_lm_torch")
    args = ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2"]
    full = mod.main(args + ["--ckpt-dir", str(tmp_path / "full")])
    cut = args + ["--ckpt-dir", str(tmp_path / "cut")]
    capsys.readouterr()
    with pytest.raises(SystemExit) as ex:
        mod.main(cut + ["--fail-at-step", "3"])
    assert ex.value.code == 42
    assert "SIMULATED NODE FAILURE at step 3" in capsys.readouterr().out
    again = mod.main(cut)
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert again["start"] == 2 and again["losses"] == full["losses"][2:]
    for a, b in zip(again["state"]["params"].parameters(),
                    full["state"]["params"].parameters()):
        assert torch.equal(a, b)
