"""The assigned input-shape grid and meta-tensor input specs.

The port of :mod:`repro.configs.shapes`.  ``ShapeSpec``, ``SHAPES``,
``SUBQUADRATIC``, ``skip_reason`` and ``grid_cells`` are pinned copies of
the reference's; ``input_specs`` gives the same keys and shapes as tensors
on the ``meta`` device (no allocation) in place of ``ShapeDtypeStruct``.

Four shapes per LM arch (40 cells):

* ``train_4k``     seq 4096  × global_batch 256   -> train_step
* ``prefill_32k``  seq 32768 × global_batch 32    -> prefill (serve)
* ``decode_32k``   KV 32768  × global_batch 128   -> serve_step (1 new token)
* ``long_500k``    KV 524288 × global_batch 1     -> serve_step, sub-quadratic
                   archs only

Skips:
* encoder-only (hubert) has no autoregressive step -> decode/long are SKIP;
* pure full-attention archs skip ``long_500k`` (no sub-quadratic mechanism).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.models.common import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs with a sub-quadratic long-context mechanism (may run long_500k)
SUBQUADRATIC = frozenset({
    "mamba2-780m",        # constant-state SSM
    "zamba2-1.2b",        # hybrid (mamba body, periodic attn)
    "gemma3-27b",         # 5:1 sliding-window:global
    "mixtral-8x7b",       # SWA 4096 bounds the window
    "deepseek-v2-236b",   # MLA latent cache (576/token/layer)
})


def skip_reason(arch: str, cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; otherwise the documented reason."""
    spec = SHAPES[shape]
    if not cfg.causal and spec.kind == "decode":
        return "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return "pure full attention: unbounded full KV at 500k (no sub-quadratic mechanism)"
    return None


def grid_cells():
    """All 40 (arch, shape) cells in deterministic order."""
    from repro_torch.configs import ARCH_IDS

    return [(a, s) for a in ARCH_IDS for s in SHAPES]


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------

# The reference's int32 ids and labels are int64 here (the port's
# embedding lookup and loss gather index with int64); positions stay int32
# (what the port builds for RoPE and M-RoPE), embeddings bf16.
ID_DTYPE = torch.int64
POS_DTYPE = torch.int32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _pos_spec(cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    if cfg.mrope_sections is not None:
        return _meta((3, b, s), POS_DTYPE)
    return _meta((b, s), POS_DTYPE)


def input_specs(cfg: ModelConfig, shape,
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors for every model input of a (config, shape) cell.

    ``train``/``prefill``: token (or stub-frontend embedding) batch;
    ``decode``: one new token per sequence (the KV cache is a separate
    argument, ``decoder.init_cache`` at ``seq_len``).  ``batch_override``
    cuts the global batch (a cell sized to fit fewer devices).  ``shape``
    is a name of :data:`SHAPES` or a :class:`ShapeSpec`.
    """
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    b = batch_override or spec.global_batch
    s = spec.seq_len
    stub_frontend = cfg.family in ("vlm", "audio")
    out: Dict[str, torch.Tensor] = {}
    if spec.kind in ("train", "prefill"):
        if stub_frontend:
            out["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        else:
            out["tokens"] = _meta((b, s), ID_DTYPE)
        out["positions"] = _pos_spec(cfg, b, s)
        if spec.kind == "train":
            out["labels"] = _meta((b, s), ID_DTYPE)
    else:  # decode: one token step against a seq_len-deep cache
        out["tokens"] = _meta((b,), ID_DTYPE)
        out["pos"] = _meta((), POS_DTYPE)
    return out
