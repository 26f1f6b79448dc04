"""The train step: loss, grads, microbatching, optimizer update.

The port of :mod:`repro.train.train_step`.  ``make_train_step`` closes over
the configs and returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``; PyTorch runs it eagerly (no jit), and gradient
accumulation over microbatches is a Python loop.  The optimizer updates
the fp32 masters and their moments in place (:mod:`.optimizer`).

On a mesh (``ctx.mesh``) the batch is the global one and each rank runs
its shard of it (:func:`repro_torch.models.decoder.loss_fn`).  The ranks'
gradients are summed over the batch axes before the clip and AdamW, which
makes them the gradients of the global batch's mean loss: every rank then
takes the single-device update of the whole batch.  Global chunked MoE
expert weights (``init_params(model_size=)``) are also summed over the
model axis, where each chunk's gradient lives on the rank that owns it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.dist import comm
from repro_torch.models import decoder
from repro_torch.models.common import ModelConfig, layer_plan

from . import optimizer as opt
from .tree import leaves, leaves_with_paths, tree_map, unflatten


@dataclass(frozen=True)
class TrainConfig:
    opt: opt.OptConfig = field(default_factory=opt.OptConfig)
    microbatches: int = 1           # gradient-accumulation factor


def body_layers(cfg: ModelConfig) -> range:
    """The layer indices the reference stacks into its scanned body."""
    plan = layer_plan(cfg)
    return range(plan.prefix, plan.suffix_start)


def _grad_fn(cfg: ModelConfig, ctx: decoder.RunCtx) -> Callable:
    """``(params, batch) -> (loss, aux, grads)``: the loss of the fp32
    masters cast to the compute dtype once, before the stack, so the
    gradients flow back through the cast into fp32 grads of the masters
    (a leaf the loss does not reach gets zeros, as jax gives)."""
    cdt = cfg.compute_dtype()

    def grads_of(params, batch) -> Tuple[torch.Tensor, Dict, Any]:
        masters = tree_map(
            lambda a: a.detach().requires_grad_(True)
            if a.is_floating_point() else a, params)
        params_c = tree_map(
            lambda a: a.to(cdt) if a.is_floating_point() else a, masters)
        loss, aux = decoder.loss_fn(cfg, ctx, params_c, batch)
        flat = leaves(masters)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
            unflatten(params, grads)

    return grads_of


def _split(batch: Dict[str, torch.Tensor], mb: int) -> list:
    """The batch's leading dim cut into ``mb`` microbatches; M-RoPE's
    ``positions`` ``[3, B, S]`` along its batch axis, 1."""
    def cut(k, x):
        axis = 1 if k == "positions" and x.dim() == 3 else 0
        return torch.chunk(x, mb, dim=axis)

    parts = {k: cut(k, v) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(mb)]


def _sum_over_mesh(ctx: decoder.RunCtx, grads, rows: int) -> None:
    """Sum each rank's gradients over the axes the batch is cut over (in
    place); global expert chunks also over the model axis."""
    comm.all_reduce_(leaves(grads), ctx.mesh, ctx.batch_shard_axes(rows))
    if ctx.model_size > 1:
        chunks = [g for path, g in leaves_with_paths(grads)
                  if "experts" in path and g.shape[0] == ctx.model_size]
        comm.all_reduce_(chunks, ctx.mesh, ctx.model_axis)


def make_train_step(cfg: ModelConfig, ctx: decoder.RunCtx,
                    tcfg: TrainConfig = TrainConfig()) -> Callable:
    grads_of = _grad_fn(cfg, ctx)
    body = body_layers(cfg)

    def train_step(params, opt_state, batch):
        if tcfg.microbatches <= 1:
            loss, _, grads = grads_of(params, batch)
        else:
            g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss_sum = 0.0
            for mb_batch in _split(batch, tcfg.microbatches):
                l, _, g = grads_of(params, mb_batch)
                g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
                loss_sum = loss_sum + l
            inv = 1.0 / tcfg.microbatches
            grads = tree_map(lambda g: g * inv, g_acc)
            loss = loss_sum * inv
        if ctx.mesh is not None:
            rows = decoder._rows(batch) // max(1, tcfg.microbatches)
            _sum_over_mesh(ctx, grads, rows)
        params, opt_state, om = opt.update(tcfg.opt, params, grads,
                                           opt_state, body=body)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_eval_step(cfg: ModelConfig, ctx: decoder.RunCtx) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        _, aux = decoder.loss_fn(cfg, ctx, params, batch)
        return aux

    return eval_step
