"""Training data pipeline.

Two sources, one interface (`batches(step) -> dict of host arrays`):

* ``SyntheticCorpus`` -- deterministic structured token streams (zipf
  unigram mixture with per-document topic drift), seeded by (seed, step)
  so every host generates its own shard without coordination and restart
  at step k reproduces the exact stream (checkpoint/restart determinism).
* ``ByteCorpus`` -- byte-level tokenization of real files with document
  packing and EOS separators; used by the examples to train on source
  trees and by the SEARS integration tests (the corpus doubles as dedup
  workload).

Batches are *global*; ``host_slice`` carves this host's rows for
multi-host running (by process index, data-parallel outermost).

A copy of the JAX reference's ``repro/data/pipeline.py``, which is numpy
only: the same seed and step give the same arrays in both packages.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0


class SyntheticCorpus:
    """Deterministic synthetic LM stream (restart-reproducible)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # zipf-ish unigram table, fixed per corpus
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks ** 1.1)
        self._probs /= self._probs.sum()
        self._topic_shift = base.integers(0, v, size=64)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = rng.choice(V, size=(B, S), p=self._probs)
        topic = self._topic_shift[rng.integers(0, 64, size=(B, 1))]
        toks = (toks + topic) % V
        return {"tokens": toks.astype(np.int32)}


class ByteCorpus:
    """Byte-level tokens from files, packed into fixed-length rows."""

    EOS = 0

    def __init__(self, cfg: DataConfig, paths: list[str]):
        self.cfg = cfg
        parts = []
        for p in sorted(paths):
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    raw = np.frombuffer(f.read(), dtype=np.uint8)
                # byte tokens shifted +1 so EOS=0 is unambiguous
                parts.append(raw.astype(np.int32) + 1)
                parts.append(np.array([self.EOS], np.int32))
        if not parts:
            raise ValueError("empty corpus")
        self._tokens = np.concatenate(parts)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = cfg.global_batch, cfg.seq_len
        n = self._tokens.shape[0]
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, max(1, n - S - 1), size=B)
        rows = np.stack([np.resize(self._tokens[s:s + S], S) for s in starts])
        return {"tokens": np.minimum(rows, cfg.vocab_size - 1).astype(np.int32)}


def host_slice(batch: dict[str, np.ndarray], process_index: int,
               process_count: int) -> dict[str, np.ndarray]:
    """This host's rows of the global batch (data-parallel outermost)."""
    def sl(x):
        B = x.shape[0]
        per = B // process_count
        return x[process_index * per:(process_index + 1) * per]
    return {k: sl(v) for k, v in batch.items()}
