"""AdamW + schedule + global clip, over the port's parameter trees.

The port of :mod:`repro.train.optimizer`.  ``m`` and ``v`` mirror the
parameter tree in fp32.  :func:`update` works in place: it writes the new
parameters, ``m`` and ``v`` into the tensors it is given and returns them
(the reference returns new trees; updating in place keeps one copy of the
fp32 masters and the two moments on the card instead of two).  The
arithmetic is the reference's, op for op, in fp32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from .tree import leaves, leaves_with_paths, tree_map, unflatten


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"       # "cosine" | "linear" | "const"


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor            # int32 scalar, on the parameters' device


def init(params: Any) -> OptState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    device = leaves(params)[0].device
    return OptState(m=zeros, v=tree_map(torch.clone, zeros),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup, then cosine / linear decay to ``min_lr_frac``; an fp32
    scalar on ``step``'s device."""
    dev = step.device
    step = step.float()
    warm = torch.minimum(_f32(1.0, dev),
                         (step + 1.0) / max(1, cfg.warmup_steps))
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(_f32(math.pi, dev) * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * t
    else:
        decay = _f32(1.0, dev)
    return cfg.lr * warm * decay


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.float())) for g in leaves(tree)])))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


_NO_DECAY_SUBSTR = ("norm", "ln_", "bias", "A_log", "dt_bias", "D")


def decay_mask(params: Any, body: range = range(0)) -> Any:
    """1.0 for the leaves AdamW decays, 0.0 for the rest, as the
    reference's ``_decay_mask`` reads its own tree: no decay for a leaf
    whose name holds a no-decay substring or that has at most one dim.

    The reference stacks its scanned body layers over a leading group
    axis, so there a leaf of a body layer has one dim more than here.
    ``body`` is the range of ``params["layers"]`` indices in the body
    (``layer_plan``'s ``prefix`` to ``suffix_start``); their leaves count
    that dim.  So a body Mamba layer's ``conv_b`` (``[conv_dim]`` here,
    ``[n_groups, conv_dim]`` there) is decayed, as in the reference, and
    the same leaf of an unrolled suffix layer is not.
    """
    def mask(path, p):
        stacked = len(path) > 1 and path[0] == "layers" and path[1] in body
        ndim = p.dim() + (1 if stacked else 0)
        nodecay = any(t in str(path[-1]) for t in _NO_DECAY_SUBSTR) \
            or ndim <= 1
        return 0.0 if nodecay else 1.0

    return unflatten(params, [mask(path, p)
                              for path, p in leaves_with_paths(params)])


def update(cfg: OptConfig, params: Any, grads: Any, state: OptState, *,
           body: range = range(0)
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns ``(params, state, metrics)``:
    the same tensors, updated, and ``{"grad_norm", "lr"}``.  ``body`` as
    for :func:`decay_mask`."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    b1, b2 = cfg.betas
    cnt = state.count + 1
    lr = schedule_lr(cfg, state.count)
    c1 = 1.0 - _f32(b1, cnt.device) ** cnt.float()
    c2 = 1.0 - _f32(b2, cnt.device) ** cnt.float()
    with torch.no_grad():
        for p, g, m, v, dk in zip(leaves(params), leaves(grads),
                                  leaves(state.m), leaves(state.v),
                                  leaves(decay_mask(params, body))):
            g32 = g.float()
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * torch.square(g32))
            step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            step = step + cfg.weight_decay * dk * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
    return params, OptState(state.m, state.v, cnt), \
        {"grad_norm": gn, "lr": lr}
