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
body.  :func:`prefill` and :func:`decode_step` run without autograd.

The mesh (``RunCtx.mesh``, a ``DeviceMesh``).  The entry points keep the
reference's contract, global in and global out: :func:`forward`,
:func:`loss_fn`, :func:`prefill` and :func:`decode_step` take the global
batch, run this rank's shard of it over the batch axes (real data
parallelism; ``RunCtx.batch_shard_axes``) and return the global result;
caches are this rank's blocks (:func:`init_cache` with ``mesh``).  On the
model axis the MoE layers run the sharded expert paths
(:func:`repro_torch.models.moe.moe_apply`, experts in the chunked layout
of ``init_params(model_size=)``), GQA decode keeps this rank's kv heads
and a head count that the axis does not divide runs sequence-parallel
(:mod:`.attention`); the rest of the dense stack computes replicated over
the model axis, its parameters whole on every model rank (GSPMD's tensor
parallelism of the dense projections is ROADMAP queue 1 item 9b).  On a
seq axis a decode attends over this rank's chunk of every ring.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.dist import comm
from repro_torch.dist import sharding as shd

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
    """Execution context: the device, the kernel policy, remat and the mesh.

    ``use_kernel``: ``"auto"`` runs the hand-written kernels on CUDA and
    their plain versions on the CPU; ``"kernel"`` insists on the kernels
    (raises on the CPU); ``"ref"`` runs the plain versions on any device,
    as the reference's ``use_kernel="ref"`` does.  ``remat``: ``"none"``,
    ``"full"`` (each body group's activations recomputed in the backward)
    or ``"dots"`` (only its matrix products without batch dims kept).
    ``mesh`` (None: one device), ``batch_axes``, ``model_axis``,
    ``capacity_factor`` (the sharded MoE's) and ``seq_axis`` (shard the
    KV rings over it) are the reference's fields.
    """

    device: Any = "cuda"
    use_kernel: str = "auto"
    remat: str = "none"
    mesh: Any = None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    capacity_factor: float = 1.25
    seq_axis: Optional[str] = None

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
        object.__setattr__(self, "batch_axes", tuple(self.batch_axes))

    def _size(self, axis: Optional[str]) -> int:
        if self.mesh is None or axis is None:
            return 1
        return shd.mesh_shape(self.mesh).get(axis, 1)

    @property
    def model_size(self) -> int:
        return self._size(self.model_axis)

    @property
    def seq_size(self) -> int:
        """Ranks along the seq axis (1 when the mesh has none)."""
        return self._size(self.seq_axis)

    @property
    def seq_sharded(self) -> bool:
        """Whether the KV rings are cut along the seq axis (the mesh has
        ``seq_axis``, of any size, one included)."""
        return self.mesh is not None and self.seq_axis is not None and \
            self.seq_axis in shd.mesh_shape(self.mesh)

    def seq_spec(self, seqlen: int) -> Optional[str]:
        """Seq-axis name if the mesh divides ``seqlen``, else None (the
        divisibility guard of :mod:`repro_torch.dist.sharding`)."""
        s = self.seq_size
        return self.seq_axis if s > 1 and seqlen % s == 0 else None

    def shard_act(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """This rank's block of ``x``, which every rank of the named axes
        holds whole (the per-rank form of the reference's sharding
        constraint); ``x`` itself off a mesh."""
        if self.mesh is None:
            return x
        return shd.local_shard(x, spec, self.mesh)

    def batch_shard_axes(self, batch: int) -> Optional[Tuple[str, ...]]:
        """The batch axes a global batch of ``batch`` rows is cut over
        (:func:`repro_torch.dist.sharding._divisible_batch_axes`; None:
        every rank runs all of it)."""
        if self.mesh is None:
            return None
        names = shd.mesh_shape(self.mesh)
        return shd._divisible_batch_axes(
            batch, [a for a in self.batch_axes if a in names], self.mesh)


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
            use_kernel=ctx.use_kernel, ctx=ctx)
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
            use_kernel=ctx.use_kernel, ctx=ctx)
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
        x = x + moe_apply(p["moe"], h, cfg, mesh=ctx.mesh,
                          batch_axes=ctx.batch_axes,
                          model_axis=ctx.model_axis,
                          capacity_factor=ctx.capacity_factor,
                          batch_local=True)
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


# ---------------------------------------------------------------------------
# The mesh: this rank's rows of a global batch, and the rows gathered back
# ---------------------------------------------------------------------------

def _batch_dim(key: str, t: torch.Tensor) -> int:
    """M-RoPE positions ``[3, B, S]`` carry the batch at dim 1."""
    return 1 if key == "positions" and t.dim() == 3 else 0


def _rows(batch: Dict[str, torch.Tensor]) -> int:
    """The global batch size (tokens, embeds and labels: batch at dim 0)."""
    for k in ("tokens", "embeds", "labels"):
        if k in batch:
            return batch[k].shape[0]
    raise ValueError(f"no batch dim to read in {sorted(batch)}")


def shard_batch(ctx: RunCtx, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (``batch_pspecs``' rule over
    ``ctx.batch_axes``); the batch itself off a mesh or where no batch axis
    divides it."""
    if ctx.mesh is None:
        return batch
    out = {}
    for k, t in batch.items():
        bdim = _batch_dim(k, t)
        axes = ctx.batch_shard_axes(t.shape[bdim]) if t.dim() > bdim \
            else None
        out[k] = (shd.local_shard(t, (None,) * bdim + (axes,), ctx.mesh)
                  if axes else t)
    return out


def gather_rows(ctx: RunCtx, t: torch.Tensor, batch: int) -> torch.Tensor:
    """The global ``[batch, ...]`` tensor from every rank's rows (the
    inverse of :func:`shard_batch` at dim 0)."""
    axes = ctx.batch_shard_axes(batch)
    return comm.all_gather(t, ctx.mesh, axes, 0) if axes else t


def forward(cfg: ModelConfig, ctx: RunCtx, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward -> logits [B, S, V]; differentiable (autograd
    records it where a parameter requires grad)."""
    local = shard_batch(ctx, batch)
    x = embed_in(cfg, params, local)
    x, _ = stack_apply(cfg, ctx, params, x, _positions(local, x))
    logits = lm_logits(cfg, ctx, params, x)
    return logits if ctx.mesh is None else \
        gather_rows(ctx, logits, _rows(batch))


def loss_parts(cfg: ModelConfig, ctx: RunCtx, params: Params,
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum of the token losses, tokens counted)`` of ``batch`` as it is
    given (no sharding); labels < 0 are ignored."""
    x = embed_in(cfg, params, batch)
    x, _ = stack_apply(cfg, ctx, params, x, _positions(batch, x))
    logits = lm_logits(cfg, ctx, params, x).float()
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    return ((lse - picked) * mask).sum(), mask.sum()


def loss_fn(cfg: ModelConfig, ctx: RunCtx, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token (or masked-frame) cross entropy; labels < 0 ignored.

    Returns ``(loss, {"loss", "ntokens"})``, fp32 scalars.  On a mesh each
    rank sums its rows' losses over the global token count and the parts
    are summed over the batch axes (:func:`repro_torch.dist.comm.
    all_reduce`): every rank returns the global loss, and its gradient on
    a rank is that of the rank's own part, which the train step sums.
    """
    if ctx.mesh is None:
        nll, count = loss_parts(cfg, ctx, params, batch)
        loss = nll / torch.clamp(count, min=1.0)
        return loss, {"loss": loss, "ntokens": count}
    axes = ctx.batch_shard_axes(_rows(batch))
    nll, count = loss_parts(cfg, ctx, params, shard_batch(ctx, batch))
    total = comm.all_reduce(count.detach(), ctx.mesh, axes)
    loss = comm.all_reduce(nll / torch.clamp(total, min=1.0), ctx.mesh, axes)
    return loss, {"loss": loss, "ntokens": total}


def _layer_cache(cfg: ModelConfig, kind: LayerKind, batch: int, max_len: int,
                 dtype: torch.dtype, device) -> Dict[str, Any]:
    if kind.mixer in ("attn", "attn_local", "shared_attn"):
        return {"attn": init_attn_cache(cfg, batch, max_len, dtype, device)}
    if kind.mixer == "mamba":
        return {"mamba": init_ssm_cache(cfg, batch, dtype, device)}
    raise ValueError(kind.mixer)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda",
               mesh=None) -> Cache:
    """Zeroed per-layer caches (attention rings of ``max_len``).

    With ``mesh``, this rank's blocks of them under
    :func:`repro_torch.dist.sharding.cache_pspecs`: the batch over the
    batch axes, kv heads over the model axis and, on a seq mesh, each ring
    cut into seq chunks (``max_len`` must divide over the seq axis).
    """
    if mesh is not None:
        ssize = shd.MeshAxes.for_mesh(mesh).seq_size(mesh)
        if max_len % ssize:
            raise ValueError(f"max_len {max_len} does not divide over the "
                             f"seq axis ({ssize} ranks)")
        whole = init_cache(cfg, batch, max_len, dtype, "meta")
        specs = shd.cache_pspecs(cfg, mesh, whole, batch)
        dev = resolve_device(device)
        return [{m: {k: torch.zeros(shd.local_shape(leaf.shape,
                                                    specs[i][m][k], mesh),
                                    dtype=leaf.dtype, device=dev)
                     for k, leaf in leaves.items()}
                 for m, leaves in layer.items()}
                for i, layer in enumerate(whole)]
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    return [_layer_cache(cfg, kind, batch, max_len, dtype, dev)
            for kind in layer_plan(cfg).kinds]


@torch.no_grad()
def prefill(cfg: ModelConfig, ctx: RunCtx, params: Params,
            batch: Dict[str, torch.Tensor], max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt, return (last-position logits [B, V], cache).

    The returned cache holds exactly the prompt (length S; on a mesh this
    rank's block of it); the caller copies it into longer rings to decode.
    """
    local = shard_batch(ctx, batch)
    x = embed_in(cfg, params, local)
    x, caches = stack_apply(cfg, ctx, params, x, _positions(local, x),
                            return_cache=True)
    logits = lm_logits(cfg, ctx, params, x[:, -1:, :])[:, 0, :]
    if ctx.mesh is not None:
        logits = gather_rows(ctx, logits, _rows(batch))
    return logits, caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, ctx: RunCtx, params: Params, caches: Cache,
                tokens: torch.Tensor, pos: Index
                ) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step over a pre-allocated cache; logits [B, V].

    A scalar ``pos`` steps all sequences in lockstep; a ``[B]`` vector is
    the continuous-batching path (each sequence at its own depth).  The
    attention rings of ``caches`` are written in place.  On a mesh,
    ``tokens`` and ``pos`` are global, ``caches`` this rank's blocks, and
    the logits global.
    """
    dtype = cfg.compute_dtype()
    b_global = tokens.shape[0]
    if ctx.mesh is not None:
        local = {"tokens": tokens}
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            local["pos"] = pos
        local = shard_batch(ctx, local)
        tokens, pos = local["tokens"], local.get("pos", pos)
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
    logits = lm_logits(cfg, ctx, params, x)[:, 0, :]
    if ctx.mesh is not None:
        logits = gather_rows(ctx, logits, b_global)
    return logits, new_caches


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
                          self.ctx.device, mesh=self.ctx.mesh)


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
