"""Analytic per-device HBM traffic & residency model.

The port of :mod:`repro.launch.estimates`: the same traffic and residency
arithmetic (``C_ACT``, ``_cache_bytes_global``, ``estimate``), cell for cell.
The one device constant is the card's own memory: ``total_memory`` of CUDA
device 0 when a card is present, else the H100 80GB's 80 GiB; ``fits`` and
its ``as_dict`` key (``fits_<size>GiB``) are against that size.

Traffic model (per device, per step; bytes):

train (ZeRO-3 / FSDP + TP):
  weights   3 · P·bw_c / TP     gathered copy written once, read fwd + bwd
  optimizer 28 · P/chips · 4    p,m,v read+write in fp32 (+grad read)
  acts      C_act · L · tok_dev · d · 2 · 2   saved activations w+r (bf16)
  logits    3 · tok_dev · V/TP · 4

prefill:
  weights   P_active·2 / TP
  acts      C_act · L · tok_dev · d · 2 · 2 (+ KV write)

decode (per token):
  weights   P_active·2 / TP     every active weight read once per step
  cache     full KV slice read once (+ 1-token write)

``C_act`` = 8 effective transfers of d-wide tensors per layer per token
(≈4 saved tensors under the dots-saveable remat policy, written + read).

Residency model (per device, bytes): what must be simultaneously resident —
params + grads + optimizer (train, fp32, fully sharded over all chips) or
params bf16/TP (serve), + KV cache slice + one layer's activation working
set.

Example (glm4-9b's decode_32k cell cut to 16 sequences, one card)::

    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.estimates import estimate
    spec = dataclasses.replace(SHAPES["decode_32k"], global_batch=16)
    estimate(get_config("glm4-9b"), spec, n_chips=1, tp=1, param_bytes=2)
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.common import ModelConfig

H100_HBM_BYTES = 80 * 1024 ** 3     # H100 80GB (NVIDIA data sheet)
C_ACT = 8.0


@functools.lru_cache(maxsize=None)
def hbm_per_chip() -> int:
    """Device memory of one card: CUDA device 0's, else the H100's."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_HBM_BYTES


def fits_key() -> str:
    return f"fits_{hbm_per_chip() / 1024 ** 3:.0f}GiB"


def _cache_bytes_global(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Total KV/state cache bytes across the fleet (bf16, fp32 SSM state)."""
    from repro_torch.models.common import layer_plan

    plan = layer_plan(cfg)
    total = 0.0
    for kind in plan.kinds:
        if kind.mixer in ("attn", "attn_local", "shared_attn"):
            if cfg.mla is not None:
                per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            else:
                per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
            total += batch * seq * per_tok * 2
        elif kind.mixer == "mamba":
            s = cfg.ssm
            di = s.d_inner(cfg.d_model)
            nh = s.n_heads(cfg.d_model)
            total += batch * (nh * s.head_dim * s.d_state * 4
                              + (s.d_conv - 1) * (di + 2 * s.n_groups * s.d_state) * 2)
    return total


@dataclass
class MemEstimate:
    traffic_bytes: float
    residency_bytes: float
    fits: bool
    detail: Dict[str, float]

    def as_dict(self):
        return {
            "traffic_bytes": self.traffic_bytes,
            "residency_bytes": self.residency_bytes,
            fits_key(): self.fits,
            "detail": self.detail,
        }


def estimate(cfg: ModelConfig, spec: ShapeSpec, n_chips: int, tp: int,
             param_bytes: int = 4) -> MemEstimate:
    """``param_bytes``: 4 = fp32 masters, 2 = bf16 weights (+ fp32 m/v)."""
    p_total = float(cfg.param_count())
    p_active = float(cfg.active_param_count())
    d: Dict[str, float] = {}

    if spec.kind == "train":
        tok_dev = spec.global_batch * spec.seq_len / n_chips
        d["weights"] = 3.0 * p_total * 2.0 / tp
        # p r+w (2·pb) + m,v r+w (16, fp32) + grad read (pb)
        d["optimizer"] = p_total / n_chips * (16.0 + 3.0 * param_bytes)
        d["acts"] = C_ACT * cfg.n_layers * tok_dev * cfg.d_model * 2.0 * 2.0
        d["logits"] = 3.0 * tok_dev * cfg.vocab_size / tp * 4.0
        traffic = sum(d.values())
        resident = (
            # p + grad (param dtype) + m + v (fp32), fully sharded
            p_total / n_chips * (2.0 * param_bytes + 8.0)
            + p_total * 2.0 / tp / max(1, cfg.n_layers) * 2  # 2 gathered layers
            + d["acts"] / 4.0                  # saved checkpoints (resident once)
            + tok_dev * cfg.vocab_size / tp * 4.0
        )
    elif spec.kind == "prefill":
        tok_dev = spec.global_batch * spec.seq_len / n_chips
        d["weights"] = p_active * 2.0 / tp
        d["acts"] = C_ACT * cfg.n_layers * tok_dev * cfg.d_model * 2.0
        d["kv_write"] = _cache_bytes_global(cfg, spec.global_batch, spec.seq_len) / n_chips
        traffic = sum(d.values())
        resident = (
            p_total * 2.0 / tp / max(1, cfg.n_layers) * 2
            + p_total * 2.0 / n_chips
            + d["kv_write"]
            + 4.0 * tok_dev * cfg.d_model * 2.0
        )
    else:  # decode
        d["weights"] = p_active * 2.0 / tp
        cache = _cache_bytes_global(cfg, spec.global_batch, spec.seq_len) / n_chips
        d["cache_read"] = cache
        traffic = sum(d.values())
        resident = p_total * 2.0 / n_chips + cache * 1.05
    return MemEstimate(
        traffic_bytes=traffic,
        residency_bytes=resident,
        fits=resident < hbm_per_chip(),
        detail=d,
    )
