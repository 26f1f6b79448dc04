"""Deterministic synthetic LM data pipeline.

Properties a 1000-node deployment needs, reproduced at laptop scale:

* **step-addressable determinism**: batch(step) is a pure function of
  (seed, step, host), so any host can reproduce any step — this is what
  makes checkpoint-restart and elastic re-sharding exact (no data loss or
  duplication on restart);
* **per-host slicing**: each host materializes only its shard of the
  global batch (``host_id``/``n_hosts``);
* **skip-ahead**: stragglers (or a restart) jump to an arbitrary step in
  O(1) — no sequential scan through the stream.

The token stream itself is a seeded Zipf-ish mixture with local n-gram
structure (so losses move during the example runs, unlike uniform noise).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    stub_frontend: bool = False          # vlm/audio: emit embeddings
    d_model: int = 0
    mrope: bool = False

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """batch(step) -> dict of numpy arrays for this host's slice."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # a fixed bigram transition table gives the stream learnable structure
        self._hot = base.integers(0, v, size=(min(v, 4096),), dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 1009 + cfg.host_id
        )
        b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
        # Zipf-flavored unigram + deterministic bigram continuation
        z = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        toks = np.minimum(z - 1, v - 1)
        follow = rng.random((b, s)) < 0.5
        prev = np.roll(toks, 1, axis=1)
        toks = np.where(follow, self._hot[prev % len(self._hot)] % v, toks)
        toks[:, 0] = rng.integers(0, v, size=b)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1                       # no target for the last token
        out: Dict[str, np.ndarray] = {
            "tokens": toks.astype(np.int32),
            "labels": labels.astype(np.int32),
        }
        if cfg.stub_frontend:
            emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
            out = {"embeds": emb, "labels": labels.astype(np.int32)}
        if cfg.mrope:
            pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
            out["positions"] = np.broadcast_to(pos[None], (3, b, s)).copy()
        return out


def make_iterator(
    cfg: DataConfig, start_step: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Resumable iterator; ``start_step`` implements restart/skip-ahead."""
    ds = SyntheticLM(cfg)
    step = start_step
    while True:
        yield ds.batch(step)
        step += 1
