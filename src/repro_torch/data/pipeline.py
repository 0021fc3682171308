"""Deterministic, checkpointable token pipeline.  Port of
`repro/data/pipeline.py` (numpy, copied).

Batches come either from a synthetic stream (seeded, position-addressable so
a restore resumes mid-epoch exactly) or from a DILI-backed RecordStore
(documents looked up by key, packed/padded to seq_len).  Batches are numpy
arrays, as in the reference; the trainer uploads them.  With the port's
`RecordStore` on the card, each `StorePipeline.batch_at` is one launch of
the lookup kernel's f64/i64 instance.
"""

from __future__ import annotations

import numpy as np


class SyntheticLM:
    """position-addressable synthetic corpus: batch(i) is pure in (seed, i).

    The "language" has learnable structure (token t+1 depends on token t via
    a fixed random permutation + noise) so tiny models visibly learn."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 noise: float = 0.1):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        for t in range(1, self.seq_len + 1):
            nxt = self.perm[toks[:, t - 1]]
            noise = rng.random(self.batch) < self.noise
            toks[:, t] = np.where(noise,
                                  rng.integers(0, self.vocab, self.batch),
                                  nxt)
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:])


class StorePipeline:
    """Samples document keys per step (deterministic), fetches via the DILI
    record store, packs to fixed [batch, seq_len]."""

    def __init__(self, store, keys: np.ndarray, seq_len: int, batch: int,
                 seed: int = 0):
        self.store = store
        self.keys = np.asarray(keys)
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        picks = self.keys[rng.integers(0, len(self.keys), self.batch)]
        offs, lens, found = self.store.lookup(picks)
        if not found.all():
            raise LookupError(f"pipeline lookup missed keys "
                              f"{picks[~found]}")
        out = np.zeros((self.batch, self.seq_len + 1), np.int32)
        for i, (o, l) in enumerate(zip(offs, lens)):
            l = min(int(l), self.seq_len + 1)
            out[i, :l] = self.store.arena[o:o + l]
        return dict(tokens=out[:, :-1], labels=out[:, 1:])
