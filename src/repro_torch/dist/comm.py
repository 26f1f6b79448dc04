"""Collectives of the port's mesh paths, by mesh axis name.

The reference writes its sharded bodies inside ``shard_map``:
``jax.lax.axis_index(a)``, ``psum`` and a tiled ``all_to_all`` over named
axes.  The port runs the same bodies as explicit per-rank code over a
:class:`torch.distributed.device_mesh.DeviceMesh`, and this module is
that translation: :func:`rank` is ``axis_index`` (over one axis or
several, major to minor), :func:`group` the process group of the ranks
that share every other coordinate, and the collectives below run over it.

Autograd.  The model's mesh paths run under autograd in training, and a
collective's backward depends on what is replicated around it.  The three
differentiable forms are Megatron's region operators; each assumes that
what comes after it is computed identically on every rank of the group:

* :func:`all_reduce` — sum in the forward, the identity in the backward
  (a partial sum whose consumers are replicated: each rank's gradient is
  already that of its own part);
* :func:`region_input` — the identity in the forward, a sum of the
  gradients in the backward (an input every rank holds whole, of which
  each rank uses a part: the parts' gradients add up);
* :func:`all_gather` — gather along a dim in the forward, this rank's
  slice of the gradient in the backward.

:func:`all_to_all` (tiled, dim 0) is its own inverse and differentiates by
running it on the gradient.  A group of one rank still runs its
collectives, so a world of one exercises the code path it shares with a
larger mesh.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[None, str, Sequence[str]]


def axes_of(axes: Axes) -> Tuple[str, ...]:
    """``None`` -> ``()``, a name -> ``(name,)``, a sequence -> a tuple."""
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def size(mesh, axes: Axes) -> int:
    """Ranks along ``axes`` (their sizes multiplied; 1 for none).  ``mesh``
    may also be a mapping of axis name to size."""
    if isinstance(mesh, Mapping):
        sizes = dict(mesh)
    else:
        sizes = {a: int(mesh.size(i))
                 for i, a in enumerate(mesh.mesh_dim_names)}
    n = 1
    for a in axes_of(axes):
        n *= int(sizes[a])
    return n


def rank(mesh, axes: Axes) -> int:
    """This rank's coordinate along ``axes``, linearized major to minor:
    the reference's ``axis_index`` over a tuple of axis names."""
    names = list(mesh.mesh_dim_names)
    r = 0
    for a in axes_of(axes):
        r = r * int(mesh.size(names.index(a))) + int(mesh.get_local_rank(a))
    return r


def group(mesh, axes: Axes):
    """The process group spanning ``axes`` (the ranks that share every
    other coordinate), its ranks in :func:`rank` order."""
    names = axes_of(axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def _gather_list(t: torch.Tensor, grp) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(grp))]
    dist.all_gather(parts, t.contiguous(), group=grp)
    return parts


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        out = t.clone()
        dist.all_reduce(out, group=grp)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RegionInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.grp)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp, dim):
        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.at = dist.get_group_rank(grp, dist.get_rank())
        return torch.cat(_gather_list(t, grp), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.at * ctx.n, ctx.n).contiguous(), \
            None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=grp)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.grp)
        return out, None


def all_reduce(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes`` (``psum``); the backward is the identity."""
    if not axes_of(axes):
        return t
    return _AllReduce.apply(t, group(mesh, axes))


def region_input(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The identity; the backward sums the gradients over ``axes``."""
    if not axes_of(axes):
        return t
    return _RegionInput.apply(t, group(mesh, axes))


def all_gather(t: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in :func:`rank` order
    (the minor axis gathered first); the backward takes this rank's
    slice."""
    for a in reversed(axes_of(axes)):
        t = _AllGather.apply(t, group(mesh, a), dim)
    return t


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tiled all-to-all over ``axis`` along dim 0 (``jax.lax.all_to_all(t,
    axis, 0, 0, tiled=True)``): block ``j`` of ``t`` goes to rank ``j``,
    and block ``j`` of the result came from rank ``j``."""
    return _AllToAll.apply(t, group(mesh, axis))


def all_reduce_(tensors: Sequence[torch.Tensor], mesh, axes: Axes, *,
                bucket: int = 1 << 26) -> None:
    """Sum each tensor over ``axes`` in place, outside autograd: same-dtype
    tensors are packed into flat buckets of up to ``bucket`` elements, one
    collective each (a gradient tree in a few calls, not one per leaf)."""
    if not axes_of(axes):
        return
    grp = group(mesh, axes)
    by_type: dict = {}
    for t in tensors:
        by_type.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_type.values():
        i = 0
        while i < len(ts):
            j, n = i, 0
            while j < len(ts) and (j == i or n + ts[j].numel() <= bucket):
                n += ts[j].numel()
                j += 1
            flat = torch.cat([t.reshape(-1) for t in ts[i:j]])
            dist.all_reduce(flat, group=grp)
            at = 0
            for t in ts[i:j]:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()
            i = j


def broadcast_(t: torch.Tensor, mesh, axes: Axes, src: int) -> None:
    """Overwrite ``t`` on every rank of ``axes`` with the tensor of the
    rank at coordinate ``src`` there."""
    if not axes_of(axes):
        return
    grp = group(mesh, axes)
    dist.broadcast(t, group=grp, src=dist.get_global_rank(grp, src))
