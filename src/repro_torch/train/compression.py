"""Error-feedback int8 gradient compression for the data-parallel axis.

The port of :mod:`repro.train.compression`'s tensor math: per tensor and
step, ``g_corr = g + residual``, ``scale = max|g_corr| / 127``, ``q =
round(g_corr / scale)`` in int8, and the residual ``g_corr - q * scale``
carried into the next step.  :func:`compressed_psum` is the int8
all-reduce over a data-parallel process group.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from .tree import leaves, tree_map, unflatten


class Compressed(NamedTuple):
    q: torch.Tensor          # int8 payload
    scale: torch.Tensor      # f32 scalar per tensor


def compress(g: torch.Tensor, residual: torch.Tensor
             ) -> Tuple[Compressed, torch.Tensor]:
    g_corr = g.float() + residual
    amax = torch.max(torch.abs(g_corr))
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(g_corr / scale), -127, 127).to(torch.int8)
    new_residual = g_corr - q.float() * scale
    return Compressed(q, scale), new_residual


def decompress(c: Compressed) -> torch.Tensor:
    return c.q.float() * c.scale


def init_residuals(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_tree(grads: Any, residuals: Any) -> Tuple[Any, Any]:
    """Tree version; returns (compressed tree, new residual tree)."""
    outs = [compress(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def decompress_tree(comp: Any) -> Any:
    """The inverse of :func:`compress_tree`'s first output: each
    :class:`Compressed` back to an fp32 tensor."""
    if isinstance(comp, Compressed):
        return decompress(comp)
    if isinstance(comp, dict):
        return {k: decompress_tree(v) for k, v in comp.items()}
    if isinstance(comp, (list, tuple)):
        return type(comp)(decompress_tree(v) for v in comp)
    raise TypeError(f"not a compressed tree node: {type(comp)}")


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8-on-the-wire mean of ``g`` over ``group`` (the data-parallel
    process group; None: the world).  Returns ``(mean, new residual)``.

    Each rank quantizes its gradient (with error feedback), the ranks
    agree on the largest scale, the int8 payloads are summed in an int32
    accumulator and the mean is rebuilt with that scale: the reference's
    arithmetic, op for op.
    """
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32,
                     device=g.device)
    c, new_res = compress(g, residual)
    scale = c.scale.clone()
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(decompress(c) / scale), -127, 127).to(
        torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    return total.float() * scale / n, new_res
