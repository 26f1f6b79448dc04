"""The general traffic generator: every mix is a data file of
``bench/traffic/<name>.json`` that this module reads.

A mix's ``kind`` names its runner, ``bench/kinds/<kind>.py``, whose
docstring lists the mix's other keys: ``"train"`` (training steps over
the synthetic stream below) or ``"prefill"`` (prompts whose first token
is served).

Inputs depend on ``(seed, step)`` or ``(seed, request)`` alone, so the
reference draws the same ones again.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> Dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _mix(*words: int) -> int:
    """A 63-bit seed from whole numbers of any size."""
    return int(np.random.SeedSequence([int(w) % (1 << 64) for w in words])
               .generate_state(1, np.uint64)[0]) >> 1


# ---------------------------------------------------------------------------
# Training: a seeded copy of the synthetic LM stream the launcher trains on
# ---------------------------------------------------------------------------

class SyntheticLM:
    """``batch(step)``: a Zipf-flavoured unigram with a fixed bigram
    continuation (so the loss has structure to learn), every row of every
    step drawn anew; labels are the next token, the last one -1."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int):
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed = _mix(seed, 0x5EED)
        base = np.random.default_rng(self.seed)
        self._hot = base.integers(0, vocab, size=(min(vocab, 4096),),
                                  dtype=np.int64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(_mix(self.seed, step))
        b, s, v = self.batch, self.seq_len, self.vocab
        toks = np.minimum(rng.zipf(1.3, size=(b, s)) - 1, v - 1)
        follow = rng.random((b, s)) < 0.5
        prev = np.roll(toks, 1, axis=1)
        toks = np.where(follow, self._hot[prev % len(self._hot)] % v, toks)
        toks[:, 0] = rng.integers(0, v, size=b)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        return {"tokens": toks.astype(np.int64),
                "labels": labels.astype(np.int64)}


# ---------------------------------------------------------------------------
# Prefill: uniform prompts, one generator state a request
# ---------------------------------------------------------------------------

def prompts(mix: Dict, vocab: int, seed: int, call: int, device,
            generator=None):
    """Token ids ``[batch, seq_len]`` of call ``call`` (negative calls are
    the warm-up's), drawn on ``device``."""
    import torch

    gen = generator if generator is not None else \
        torch.Generator(device=device)
    gen.manual_seed(_mix(seed, 0x9F, call))
    return torch.randint(0, vocab, (mix["batch"], mix["seq_len"]),
                         generator=gen, device=device, dtype=torch.int64)
