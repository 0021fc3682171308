"""DILI-indexed record store: the training data pipeline's random-access path.

Variable-length records (token sequences) are stored in one flat token arena.
A `repro_torch.api.LearnedIndex` maps document key -> doc ordinal; a
sidecar table maps ordinal -> (offset, length).  Batched `lookup` runs the
engine's batched device search — the paper's technique IS the pipeline's
index — and new documents are overlay upserts (visible immediately) that
fold through DILI's Algorithm-7 insert on `publish()`/merge.  Port of
`repro/data/record_store.py`; the index lives on `device` (CUDA unless
asked otherwise).
"""

from __future__ import annotations

import numpy as np

from ..api import IndexConfig, LearnedIndex, manual_merge_policy


class RecordStore:
    def __init__(self, doc_keys: np.ndarray, docs: list[np.ndarray],
                 sample_stride: int = 4,
                 config: IndexConfig | None = None, device="cuda"):
        order = np.argsort(doc_keys)
        doc_keys = np.asarray(doc_keys, np.float64)[order]
        docs = [np.asarray(docs[i], np.int32) for i in order]
        self.arena = (np.concatenate(docs) if docs
                      else np.zeros(0, np.int32))
        lens = np.array([len(d) for d in docs], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
        self.lengths = lens
        ordinals = np.arange(len(docs), dtype=np.int64)
        # ingest-controlled pipeline: merges happen at publish(), not on a
        # write-pressure trigger mid-epoch
        cfg = config or IndexConfig(sample_stride=sample_stride,
                                    merge=manual_merge_policy())
        self.index = LearnedIndex.build(doc_keys, ordinals, config=cfg,
                                        device=device)

    @property
    def dili(self):
        """The host writer (introspection)."""
        return self.index.host

    # -- write path ---------------------------------------------------------

    def add(self, key: float, tokens: np.ndarray) -> None:
        self.offsets = np.append(self.offsets, len(self.arena))
        self.lengths = np.append(self.lengths, len(tokens))
        self.arena = np.concatenate([self.arena,
                                     np.asarray(tokens, np.int32)])
        self.index.upsert(float(key), len(self.offsets) - 1)

    def publish(self) -> None:
        """Fold pending adds through the host tree (snapshot republish)."""
        self.index.flush()

    # -- read path ----------------------------------------------------------

    def lookup(self, keys) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched: returns (offsets, lengths, found)."""
        v, f = self.index.lookup(keys)
        ords = np.where(f, v, 0)
        return self.offsets[ords], self.lengths[ords], f

    def fetch(self, key: float, pad_to: int = 0) -> np.ndarray | None:
        off, ln, f = self.lookup(np.array([key]))
        if not f[0]:
            return None
        seq = self.arena[off[0]: off[0] + ln[0]]
        if pad_to and len(seq) < pad_to:
            seq = np.pad(seq, (0, pad_to - len(seq)))
        return seq
