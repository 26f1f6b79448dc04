"""Frozen work arithmetic: the operations and bytes each op needs, and the
card's published peaks.

The yardstick of every roofline share and of ``mfu``.  It counts what the
algorithm needs at the call's shapes, whatever implements it: each input
byte read once, each output byte written once, and the products on the
pairs a causal mask leaves visible.  A whole model's FLOPs are its
family's (``bench/families/<name>.py``), counted from these.  Imports
nothing.
"""
from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, n_bytes: float,
            flops_per_s: float = PEAK_BF16_FLOPS) -> float:
    """Least time the card could take: the larger of the two bounds."""
    return max(flops / flops_per_s, n_bytes / HBM_BYTES_PER_S)


def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query row, key) pairs one head sees; a causal prefill has sq ==
    skv and sees the lower triangle with its diagonal."""
    if causal:
        if sq != skv:
            raise ValueError("causal pairs counted for a prefill only "
                             f"(sq {sq} != skv {skv})")
        return sq * (sq + 1) // 2
    return sq * skv


def attention_work(b: int, sq: int, skv: int, hq: int, hkv: int, dk: int,
                   dv: int, elem: int, *, causal: bool = True,
                   backward: bool = False, lse: bool = False
                   ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call ``[b, sq, hq, dk] x [b, skv,
    hkv, dk|dv]``.

    Forward: S = Q K^T and P V on the visible pairs, 2 P (dk + dv); q, k,
    v, the positions read, out (and the rows' fp32 lse when written) out.
    Backward: S, dP, dV, dQ, dK, 2 P (3 dk + 2 dv); q, k, v, out, dout,
    lse and the positions read, dq, dk, dv written.
    """
    pairs = b * hq * visible_pairs(sq, skv, causal)
    q, k, v = b * sq * hq * dk, b * skv * hkv * dk, b * skv * hkv * dv
    out = b * sq * hq * dv
    rows = b * sq * hq
    positions = 4 * b * (sq + skv)
    if not backward:
        flops = 2.0 * pairs * (dk + dv)
        n_bytes = (q + k + v + out) * elem + positions + (4 * rows if lse
                                                          else 0)
        return flops, float(n_bytes)
    flops = 2.0 * pairs * (3 * dk + 2 * dv)
    n_bytes = (2 * (q + k + v) + 2 * out) * elem + 4 * rows + positions
    return flops, float(n_bytes)


def ssd_forward_flops(b: int, s: int, h: int, p: int, n: int,
                      chunk: int) -> float:
    """The chunked scan's products: C B^T once a chunk (one group), and a
    head's intra-chunk (C B^T * decay) x, its state and its output from
    the entering state, plus the decay mask."""
    nc = -(-s // chunk)
    tri = chunk * (chunk + 1) / 2
    per_head = 2 * tri * p + 4 * chunk * p * n + 3 * tri
    return float(b * nc * (2 * tri * n + h * per_head))


def ssd_work(b: int, s: int, h: int, p: int, n: int, chunk: int,
             elem: int, *, backward: bool = False, h0: bool = False,
             dfinal: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one SSD call: x ``[b, s, h, p]``, dt ``[b, s,
    h]`` and a ``[h]`` in fp32, B and C ``[b, s, 1, n]``.

    Forward: x, B, C, dt, a (and h0) read, y and the fp32 final state
    written.  Backward (twice the forward's products): x, dy, B, C, dt, a
    (h0, dfinal) read, dx, dB, dC, ddt, da (dh0) written.
    """
    x, bc = b * s * h * p, b * s * n
    dt, state = b * s * h, b * h * p * n
    flops = ssd_forward_flops(b, s, h, p, n, chunk)
    if not backward:
        n_bytes = (2 * x + 2 * bc) * elem + 4 * (dt + h + state
                                                  + (state if h0 else 0))
        return flops, float(n_bytes)
    n_bytes = (3 * x + 4 * bc) * elem + 4 * (2 * dt + 2 * h) \
        + 4 * state * ((2 if h0 else 0) + (1 if dfinal else 0))
    return 2.0 * flops, float(n_bytes)
