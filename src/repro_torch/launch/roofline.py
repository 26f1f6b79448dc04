"""Roofline terms and collective ring costs for one H100.

The framework-free half of :mod:`repro.launch.hlo_analysis`: the three
per-step roofline times (``roofline_terms``), the useful-FLOPs yardstick
(``model_flops``) and the ring-algorithm wire bytes of collectives
(``CollectiveStats``, ``collective_bytes``).  The reference reads the
collectives out of optimized HLO text; here they are a list of records
``(op, dtype, shape, group_size)``, each the collective's result, in its
true dtype.  (The reference's ``tpu_bf16_bytes`` corrects for XLA's CPU
backend widening bf16 collectives to f32; records carry no such widening,
so it has no counterpart.)  The records come from
:func:`repro_torch.dist.comm.recording`, the dry run's counting pass
(:mod:`.op_count`).

Constants are one H100 SXM's (NVIDIA data sheet): 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, NVLink 450 GB/s each way (all 18 links together).

Example::

    from repro_torch.launch.roofline import collective_bytes, roofline_terms
    st = collective_bytes([("all-reduce", torch.bfloat16, (4096, 4096), 8)])
    roofline_terms(2.0e12, 40e9, st.total_bytes)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

PEAK_FLOPS = 989e12          # dense bf16 per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink bytes/s per card, each way

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

Record = Tuple[str, torch.dtype, Sequence[int], int]


def _shape_bytes(dtype: torch.dtype, shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


@dataclass
class CollectiveStats:
    """Per-device *wire* bytes under the standard ring-algorithm cost model:

    all-reduce: 2·S·(g-1)/g   (reduce-scatter + all-gather phases)
    all-gather: S_out·(g-1)/g
    reduce-scatter: S_in·(g-1)/g = S_out·(g-1)
    all-to-all: S·(g-1)/g
    collective-permute: S
    """

    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def as_dict(self) -> Dict:
        return {
            "total_bytes": self.total_bytes,
            "total_count": self.total_count,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
        }


def collective_bytes(records: Iterable[Record]) -> CollectiveStats:
    """Ring-model wire bytes of every ``(op, dtype, result shape,
    group_size)`` record; ``op`` one of :data:`COLLECTIVES`."""
    st = CollectiveStats()
    for kind, dtype, shape, g in records:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}")
        size = _shape_bytes(dtype, shape)
        g = max(1, int(g))
        ring = (g - 1) / g
        if kind == "all-reduce":
            b = 2.0 * size * ring
        elif kind == "all-gather":
            b = size * ring
        elif kind == "reduce-scatter":
            b = size * (g - 1)
        elif kind == "all-to-all":
            b = size * ring
        else:  # collective-permute
            b = float(size)
        st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0.0) + b
        st.count_by_kind[kind] = st.count_by_kind.get(kind, 0) + 1
    return st


def roofline_terms(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_bytes_per_device: float,
) -> Dict[str, float]:
    """The three per-step roofline times (seconds) and the dominant term."""
    t_compute = flops_per_device / PEAK_FLOPS
    t_memory = hbm_bytes_per_device / HBM_BW
    t_collective = collective_bytes_per_device / LINK_BW
    dom = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    bound = max(t_compute, t_memory, t_collective)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dom,
        "bound_s": bound,
        # fraction of the bound that is useful compute = roofline fraction
        "compute_fraction": (t_compute / bound) if bound > 0 else 0.0,
    }


def model_flops(param_count: int, tokens: int, active_param_count: Optional[int] = None) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) — the useful-FLOPs yardstick."""
    n = active_param_count if active_param_count is not None else param_count
    return 6.0 * float(n) * float(tokens)
