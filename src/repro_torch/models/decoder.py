"""Decoder stack: train forward and loss, prefill and decode.

The port of :mod:`repro.models.decoder`.  Where the reference
scans stacked layer groups with ``lax.scan``, the port runs a Python loop
over per-layer parameter dicts (:mod:`.common` explains the layout), and a
cache is a list with one dict per layer: ``{"attn": {"k", "v"}}`` (MLA:
``{"attn": {"c_kv", "k_pe"}}``) or ``{"mamba": {"conv", "ssm"}}``; every
leaf has the batch at dim 0.  Group ``g`` of position ``j`` in the
reference's ``init_cache`` tree is layer ``prefix + g * period + j`` here.
PyTorch runs eagerly; there is no jit.

Dispatch differs from the reference in one place: on a CUDA tensor every
attention goes to the flash kernel, decode's Sq = 1 included, where the
reference sends Sq = 1 to its plain path (its TPU tiling needs 8 query
rows).  Both compute the same function.

Every registered architecture runs: dense GQA (gemma3's local/global
pattern with its dual rotary theta, QK and post-block norms; minitron's
partial rotary; qwen2-vl's M-RoPE over ``[3, B, S]`` positions and
``embeds`` from its stub frontend), MLA, MoE, Mamba2 and zamba2's hybrid
stack, whose ``shared_attn`` layers all read the one
``params["shared_attn"]`` block and each keep their own KV cache and
their own MLP; an encoder (hubert, ``causal=False``) runs ``forward``
over ``embeds``.

Training: :func:`forward` and :func:`loss_fn` are differentiable (on CUDA
the kernels' backward recomputes their plain versions,
:mod:`repro_torch.kernels.ops`); ``RunCtx.remat`` checkpoints each body
group of ``plan.period`` layers, as the reference wraps its scanned group
body.  :func:`prefill` and :func:`decode_step` run without autograd.  Not
ported yet: the mesh (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device

from .attention import Index, gqa_attention, init_attn_cache, mla_attention
from .common import LayerKind, ModelConfig, layer_plan, mlp_apply, rms_norm
from .moe import moe_apply
from .ssm import init_ssm_cache, mamba2_block

Params = Dict[str, Any]
Cache = List[Dict[str, Dict[str, torch.Tensor]]]

_USE_KERNEL = ("auto", "kernel", "ref")
_REMAT = ("none", "full", "dots")


@dataclass(frozen=True)
class RunCtx:
    """Execution context: the device, the kernel policy and remat.

    ``use_kernel``: ``"auto"`` runs the hand-written kernels on CUDA and
    their plain versions on the CPU; ``"kernel"`` insists on the kernels
    (raises on the CPU); ``"ref"`` runs the plain versions on any device,
    as the reference's ``use_kernel="ref"`` does.  ``remat``: ``"none"``,
    ``"full"`` (each body group's activations recomputed in the backward)
    or ``"dots"`` (only its matrix products without batch dims kept).
    """

    device: Any = "cuda"
    use_kernel: str = "auto"
    remat: str = "none"

    def __post_init__(self):
        if self.use_kernel not in _USE_KERNEL:
            raise ValueError(f"use_kernel must be one of {_USE_KERNEL}, got "
                             f"{self.use_kernel!r}")
        if self.remat not in _REMAT:
            raise ValueError(f"remat must be one of {_REMAT}, got "
                             f"{self.remat!r}")
        dev = resolve_device(self.device)
        if self.use_kernel == "kernel" and dev.type != "cuda":
            raise ValueError("use_kernel='kernel' runs the CUDA kernels, "
                             f"which need a CUDA device, not {dev}")
        object.__setattr__(self, "device", dev)


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def _cast(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def block_apply(
    cfg: ModelConfig,
    ctx: RunCtx,
    kind: LayerKind,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    shared_p: Optional[Params] = None,
    cache: Optional[Dict[str, Any]] = None,
    cache_index: Optional[Index] = None,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One layer.  ``shared_p`` is ``params["shared_attn"]``, the block a
    ``shared_attn`` layer runs (the reference's ``shared_attn_p``); the
    layer's own ``p`` holds its MLP and ``ln_mlp``."""
    eps, gm = cfg.norm_eps, cfg.gemma_norm
    # parameters may be stored in another type; compute in cfg.dtype
    p = _cast(p, cfg.compute_dtype())
    new_cache: Dict[str, Any] = {}

    if kind.mixer in ("attn", "attn_local"):
        h = rms_norm(x, p["ln_attn"], eps, gemma=gm)
        fn = mla_attention if cfg.mla is not None else gqa_attention
        a, c = fn(
            p["attn"], h, cfg, positions, is_global=(kind.mixer == "attn"),
            cache=None if cache is None else cache.get("attn"),
            cache_index=cache_index, return_cache=return_cache,
            use_kernel=ctx.use_kernel)
        if gm and "ln_post_attn" in p:
            a = rms_norm(a, p["ln_post_attn"], eps, gemma=gm)
        x = x + a
        if return_cache:
            new_cache["attn"] = c
    elif kind.mixer == "mamba":
        h = rms_norm(x, p["ln_mix"], eps, gemma=gm)
        y, c = mamba2_block(
            p["mamba"], h, cfg,
            cache=None if cache is None else cache.get("mamba"),
            return_cache=return_cache, use_kernel=ctx.use_kernel)
        x = x + y
        if return_cache:
            new_cache["mamba"] = c
    elif kind.mixer == "shared_attn":
        shared_p = _cast(shared_p, cfg.compute_dtype())
        h = rms_norm(x, shared_p["ln_attn"], eps, gemma=gm)
        a, c = gqa_attention(
            shared_p["attn"], h, cfg, positions, is_global=True,
            cache=None if cache is None else cache.get("attn"),
            cache_index=cache_index, return_cache=return_cache,
            use_kernel=ctx.use_kernel)
        x = x + a
        if return_cache:
            new_cache["attn"] = c
    else:
        raise ValueError(kind.mixer)

    if kind.ffn == "dense":
        h = rms_norm(x, p["ln_mlp"], eps, gemma=gm)
        f = mlp_apply(p["mlp"], h, cfg.mlp_act)
        if gm and "ln_post_mlp" in p:
            f = rms_norm(f, p["ln_post_mlp"], eps, gemma=gm)
        x = x + f
    elif kind.ffn == "moe":
        h = rms_norm(x, p["ln_mlp"], eps, gemma=gm)
        x = x + moe_apply(p["moe"], h, cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

# matrix products with no batch dims: what jax's
# dots_with_no_batch_dims_saveable keeps (x @ W runs as aten.mm on 2-D views)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, remat: str):
    """``fn`` under the remat policy: ``"full"`` keeps none of its
    activations and recomputes them in the backward; ``"dots"`` keeps the
    matrix products with no batch dims (a selective checkpoint)."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        return lambda *a: ckpt.checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                _save_dots))
    raise ValueError(remat)


def stack_apply(
    cfg: ModelConfig,
    ctx: RunCtx,
    params: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    caches: Optional[Cache] = None,
    cache_index: Optional[Index] = None,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Every layer in order; the per-layer caches in, the new ones out.

    The body groups (``plan.period`` layers each, the reference's scanned
    ``group_body``) run under ``ctx.remat``; the prefix and suffix layers
    run unwrapped, as in the reference.
    """
    plan = layer_plan(cfg)
    kinds, layers = plan.kinds, params["layers"]
    shared_p = params.get("shared_attn")

    def run(lo: int, hi: int, x: torch.Tensor):
        ncs = []
        for i in range(lo, hi):
            x, nc = block_apply(
                cfg, ctx, kinds[i], layers[i], x, positions,
                shared_p=shared_p,
                cache=None if caches is None else caches[i],
                cache_index=cache_index, return_cache=return_cache)
            ncs.append(nc)
        return x, ncs

    group = _remat_wrap(run, ctx.remat)
    new_caches: Cache = []
    x, ncs = run(0, plan.prefix, x)
    new_caches += ncs
    for g in range(plan.n_groups):
        lo = plan.prefix + g * plan.period
        x, ncs = group(lo, lo + plan.period, x)
        new_caches += ncs
    x, ncs = run(plan.suffix_start, len(kinds), x)
    new_caches += ncs
    return x, (new_caches if return_cache else None)


# ---------------------------------------------------------------------------
# Model-level entry points
# ---------------------------------------------------------------------------

def embed_in(cfg: ModelConfig, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token ids -> embeddings, or pass through stub-frontend features."""
    dtype = cfg.compute_dtype()
    if "embeds" in batch:
        x = batch["embeds"].to(dtype)
    else:
        x = params["embed"][batch["tokens"].long()].to(dtype)
    if cfg.gemma_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(cfg: ModelConfig, ctx: RunCtx, params: Params,
              x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps,
                 gemma=cfg.gemma_norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _positions(batch, x: torch.Tensor) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    return positions


def forward(cfg: ModelConfig, ctx: RunCtx, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward -> logits [B, S, V]; differentiable (autograd
    records it where a parameter requires grad)."""
    x = embed_in(cfg, params, batch)
    x, _ = stack_apply(cfg, ctx, params, x, _positions(batch, x))
    return lm_logits(cfg, ctx, params, x)


def loss_fn(cfg: ModelConfig, ctx: RunCtx, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token (or masked-frame) cross entropy; labels < 0 ignored.

    Returns ``(loss, {"loss", "ntokens"})``, fp32 scalars.
    """
    logits = forward(cfg, ctx, params, batch).float()
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (lse - picked) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    return loss, {"loss": loss, "ntokens": mask.sum()}


def _layer_cache(cfg: ModelConfig, kind: LayerKind, batch: int, max_len: int,
                 dtype: torch.dtype, device) -> Dict[str, Any]:
    if kind.mixer in ("attn", "attn_local", "shared_attn"):
        return {"attn": init_attn_cache(cfg, batch, max_len, dtype, device)}
    if kind.mixer == "mamba":
        return {"mamba": init_ssm_cache(cfg, batch, dtype, device)}
    raise ValueError(kind.mixer)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> Cache:
    """Zeroed per-layer caches (attention rings of ``max_len``)."""
    dev = resolve_device(device)
    return [_layer_cache(cfg, kind, batch, max_len, dtype, dev)
            for kind in layer_plan(cfg).kinds]


@torch.no_grad()
def prefill(cfg: ModelConfig, ctx: RunCtx, params: Params,
            batch: Dict[str, torch.Tensor], max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt, return (last-position logits [B, V], cache).

    The returned cache holds exactly the prompt (length S); the caller
    copies it into longer rings to decode.
    """
    x = embed_in(cfg, params, batch)
    x, caches = stack_apply(cfg, ctx, params, x, _positions(batch, x),
                            return_cache=True)
    logits = lm_logits(cfg, ctx, params, x[:, -1:, :])
    return logits[:, 0, :], caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, ctx: RunCtx, params: Params, caches: Cache,
                tokens: torch.Tensor, pos: Index
                ) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step over a pre-allocated cache; logits [B, V].

    A scalar ``pos`` steps all sequences in lockstep; a ``[B]`` vector is
    the continuous-batching path (each sequence at its own depth).  The
    attention rings of ``caches`` are written in place.
    """
    dtype = cfg.compute_dtype()
    if tokens.dim() == 1:
        x = params["embed"][tokens.long()[:, None]].to(dtype)
        if cfg.gemma_norm:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    else:
        x = tokens.to(dtype)
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if pos.dim() == 0:
        positions = pos.reshape(1, 1).expand(b, 1)
    else:
        positions = pos[:, None]
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, b, 1)
    x, new_caches = stack_apply(cfg, ctx, params, x, positions,
                                caches=caches, cache_index=pos,
                                return_cache=True)
    logits = lm_logits(cfg, ctx, params, x)
    return logits[:, 0, :], new_caches


class Decoder(nn.Module):
    """Holds a model's parameters on one device and runs the entry points.

    ``params`` is the port's layout (:func:`.common.init_params` or
    :func:`.common.params_from_numpy`); the tensors become frozen
    ``nn.Parameter``s.
    """

    def __init__(self, cfg: ModelConfig, params: Params,
                 ctx: Optional[RunCtx] = None):
        super().__init__()
        self.cfg = cfg
        self.ctx = ctx if ctx is not None else RunCtx()
        self.params = _to_module(params)

    def tree(self) -> Params:
        """The parameters as the plain nested dict the functions take."""
        return _from_module(self.params)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return forward(self.cfg, self.ctx, self.tree(), batch)

    def prefill(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Cache]:
        return prefill(self.cfg, self.ctx, self.tree(), batch)

    def decode_step(self, caches: Cache, tokens: torch.Tensor, pos: Index
                    ) -> Tuple[torch.Tensor, Cache]:
        return decode_step(self.cfg, self.ctx, self.tree(), caches, tokens,
                           pos)

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return init_cache(self.cfg, batch, max_len, self.cfg.compute_dtype(),
                          self.ctx.device)


def _to_module(tree) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList([_to_module(t) for t in tree])
    mod = nn.Module()
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            mod.add_module(k, _to_module(v))
        else:
            mod.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return mod


def _from_module(mod: nn.Module):
    if isinstance(mod, nn.ModuleList):
        return [_from_module(m) for m in mod]
    out = {k: p for k, p in mod.named_parameters(recurse=False)}
    out.update({k: _from_module(m) for k, m in mod.named_children()})
    return out
