"""Dispatch points: CUDA tensors -> kernel, CPU tensors -> plain twin.

Counterparts of :func:`repro.kernels.ops.validate_transactions`
(and :func:`certify_drain`, the port's fused form of a certification drain),
:func:`repro.kernels.ops.settle_lease_batch`,
:func:`repro.kernels.ops.attention`, :func:`repro.kernels.ops.ssd` and
:func:`repro.kernels.ops.moe_combine`.  There is no backend probing: the
device of the tensors decides.  A CUDA tensor launches the kernel or
raises; only a tensor that lies on the CPU takes the plain twin.

One difference from the reference's dispatch: on a CUDA tensor
:func:`attention` launches the flash kernel for every query length,
decode's Sq = 1 included.  The reference sends Sq = 1 to its plain path
(``repro/models/attention.py:120``) because its TPU tiling needs at least
8 query rows; both compute the same function.

Gradients.  The kernels compute forwards only, as the reference's Pallas
kernels do (the reference differentiates through its plain functions
alone).  On CUDA tensors :func:`attention` and :func:`ssd` run the kernel
inside a ``torch.autograd.Function`` whose backward recomputes the plain
version (``ref.sdpa_ref`` / ``ref.ssd_ref``) from the saved inputs and
returns its input gradients: the gradients are those of the plain version,
at the cost of one more forward of it per backward.
:data:`backward_recomputes` counts those recomputes by kernel variant.  On
the CPU the plain version runs, and autograd differentiates it natively.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import flash_attention as _flash
from . import ref
from . import ssd_scan as _ssd
from .lease_validate import DrainStaging, lease_drain, lease_validate

# backward recomputes through the plain versions since the count was last
# reset, by the variant whose forward ran (the kernels line's names)
backward_recomputes = {f"flash_attention.{v}": 0 for v in _flash.VARIANTS}
backward_recomputes.update({f"ssd_scan.{v}": 0 for v in _ssd.VARIANTS})


def _recompute_grads(ctx, plain, inputs, grads_out):
    """Input gradients of ``plain(*inputs)`` for ``grads_out`` (None where
    an output got no gradient): the plain version is run again on detached
    copies of the saved inputs with autograd on."""
    need = ctx.needs_input_grad[:len(inputs)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if t is not None else None
                  for t, n in zip(inputs, need)]
        outs = plain(*leaves)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wanted, [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and wanted else [None] * len(wanted))
    return [next(got) if t is not None and t.requires_grad else None
            for t in leaves]


class _Attention(torch.autograd.Function):
    """The flash kernel forward; the backward of ``ref.sdpa_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, opts):
        ctx.save_for_backward(q, k, v, q_positions, kv_positions)
        ctx.opts = opts
        ctx.variant = _flash.variant(q.dtype, q.shape[1], q.shape[2],
                                     k.shape[2], q.shape[3], v.shape[3])
        return _flash.flash_attention(q, k, v, q_positions=q_positions,
                                      kv_positions=kv_positions, **opts)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, qp, kp = ctx.saved_tensors
        backward_recomputes[f"flash_attention.{ctx.variant}"] += 1

        def plain(q, k, v):
            return (ref.sdpa_ref(q, k, v, q_positions=qp, kv_positions=kp,
                                 **ctx.opts),)

        return (*_recompute_grads(ctx, plain, (q, k, v), (grad_out,)),
                None, None, None)


class _SSD(torch.autograd.Function):
    """The SSD kernel forward; the backward of ``ref.ssd_ref`` (y in x's
    type, as the kernel returns it)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, h0)
        ctx.chunk = chunk
        ctx.variant = _ssd.variant(x.dtype, x.shape[3], b_mat.shape[3], chunk)
        return _ssd.ssd_scan(x, dt, a, b_mat, c_mat, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        saved = ctx.saved_tensors
        backward_recomputes[f"ssd_scan.{ctx.variant}"] += 1

        def plain(x, dt, a, b_mat, c_mat, h0):
            y, final = ref.ssd_ref(x, dt, a, b_mat, c_mat, chunk=ctx.chunk,
                                   h0=h0)
            return y.to(x.dtype), final

        return (*_recompute_grads(ctx, plain, saved, (grad_y, grad_final)),
                None)


def settle_lease_batch(head_req, head_proc, head_active, qlen, fresh_blocked,
                       wait_req, wait_cc, proc: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One lease settle per delivery instant for the sharded lease manager.

    Returns ``(owner[C], free[C], enabled[B])``.  The reference has no
    Pallas kernel for this op (it is jit'd jnp), so on every device it runs
    as the torch ops of :func:`ref.lease_settle_ref` on the tensors' device.
    """
    return ref.lease_settle_ref(head_req, head_proc, head_active, qlen,
                                fresh_blocked, wait_req, wait_cc, proc)


def moe_combine(back, tok_slot, gate_slot, *, tp: int, capacity: int,
                t_out: int) -> torch.Tensor:
    """Partial-activation psum + gated scatter closing the MoE a2a combine
    leg: sums the ``tp`` f-slice partials per expert-group slot, then
    scatters the gated rows to their tokens.  The reference has no Pallas
    kernel for it (its jnp oracle is the dispatch on every backend), so on
    every device it runs as the torch ops of :func:`ref.moe_combine_ref`.
    """
    return ref.moe_combine_ref(back, tok_slot, gate_slot, tp=tp,
                               capacity=capacity, t_out=t_out)


def validate_transactions(
    store_versions: torch.Tensor, read_items: torch.Tensor,
    read_versions: torch.Tensor, write_locks: Optional[torch.Tensor] = None,
    write_items: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched TL2 certification — the simulator's single dispatch point.

    All inputs are int32 tensors on one device.  Write locks default to
    none (all zeros) and write items to one all--1 column.  Returns
    ``ok[B]`` bool on the same device.
    """
    b = read_items.shape[0]
    dev = store_versions.device
    if write_locks is None:
        write_locks = torch.zeros_like(store_versions)
    if write_items is None:
        write_items = torch.full((b, 1), -1, dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        return lease_validate(store_versions, read_items, read_versions,
                              write_locks, write_items)
    return ref.lease_validate_ref(store_versions, read_items, read_versions,
                                  write_locks > 0, write_items)


def certify_drain(table: torch.Tensor, staging: DrainStaging,
                  item_cc: Optional[torch.Tensor] = None) -> np.ndarray:
    """One certification drain: flush the packed dirty pairs into ``table``
    and certify the packed transactions; returns ``ok[B]``, a view into
    ``staging`` that the next drain overwrites.

    A CUDA table goes to the ``drain`` kernel (one launch, one wait); a CPU
    table to :func:`ref.lease_drain_ref` over tensors that share the
    staging area's memory, whose verdicts land where the kernel's would.
    """
    if table.device.type == "cuda":
        return lease_drain(table, staging, item_cc)
    v = staging.views
    t = torch.from_numpy
    classes = item_cc is not None
    v.ok[:] = ref.lease_drain_ref(
        table, t(v.dirty_idx), t(v.dirty_ver), item_cc,
        t(v.owners) if classes else None, v.node, t(v.read_items),
        t(v.read_versions), t(v.write_items) if classes else None).numpy()
    return v.ok


def attention(q, k, v, *, q_positions, kv_positions, causal=True,
              sliding_window=None, logit_softcap=0.0, scale=None,
              plain=False, return_lse=False):
    """GQA attention ``[B, Sq, Hq, Dk] x [B, Skv, Hkv, Dk|Dv]``.

    CUDA tensors go to the flash kernel at every Sq (differentiable, by
    recompute of the plain version); CPU tensors, and any tensor when
    ``plain`` is set, to :func:`ref.sdpa_ref`.  Positions are
    handed to the kernel as contiguous int32 (the model broadcasts them).
    Where q, k and v differ in dtype (a float32 model over a bf16 KV
    ring), the kernel takes all three in the widest and the output is
    cast back to q's, as the plain version computes in fp32 and returns
    q's dtype.

    ``return_lse`` returns ``(out, lse)`` with each row's fp32 log-sum-exp
    ``[B, Sq, Hq]`` (the seq-sharded decode's combine).  It is a forward
    for decode: on CUDA it launches ``decode_split`` outside the autograd
    Function, and shapes that take another variant raise.
    """
    opts = dict(causal=causal, sliding_window=sliding_window,
                logit_softcap=logit_softcap, scale=scale)
    if return_lse and q.device.type == "cuda" and not plain:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError("the log-sum-exp output has no "
                                      "backward; call it under no_grad")
        wide = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                   v.dtype)
        out, lse = _flash.flash_attention(
            q.to(wide), k.to(wide), v.to(wide),
            q_positions=q_positions.to(torch.int32).contiguous(),
            kv_positions=kv_positions.to(torch.int32).contiguous(),
            return_lse=True, **opts)
        return out.to(q.dtype), lse
    if q.device.type == "cuda" and not plain:
        if not q.dtype == k.dtype == v.dtype:
            wide = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                       v.dtype)
            return attention(q.to(wide), k.to(wide), v.to(wide),
                             q_positions=q_positions,
                             kv_positions=kv_positions, causal=causal,
                             sliding_window=sliding_window,
                             logit_softcap=logit_softcap,
                             scale=scale).to(q.dtype)
        return _Attention.apply(
            q, k, v, q_positions.to(torch.int32).contiguous(),
            kv_positions.to(torch.int32).contiguous(), opts)
    return ref.sdpa_ref(q, k, v, q_positions=q_positions,
                        kv_positions=kv_positions, return_lse=return_lse,
                        **opts)


def ssd(x, dt, a, b_mat, c_mat, *, chunk=256, h0=None, plain=False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan; returns ``(y [B, S, H, P], final_state [B, H, P, N])``.

    S is zero-padded up to a multiple of ``chunk`` (as the reference's ref
    branch does, ``repro/models/ssm.py:216-227``) and ``y`` is cut back to
    S; padded steps have ``dt = 0``, so they leave the state unchanged.
    CUDA tensors go to the SSD kernel (``n_groups == 1``; anything else
    raises; differentiable, by recompute of the plain version); CPU
    tensors, and any tensor when ``plain`` is set, to :func:`ref.ssd_ref`.
    The padding is torch ops outside the kernel's Function, so gradients
    pass through it.
    """
    s = x.shape[1]
    pad = (-s) % chunk
    x, dt, b_mat, c_mat = (ref.pad_seq(t, pad) for t in (x, dt, b_mat, c_mat))
    if x.device.type == "cuda" and not plain:
        y, final = _SSD.apply(x, dt, a, b_mat, c_mat, h0, chunk)
    else:
        y, final = ref.ssd_ref(x, dt, a, b_mat, c_mat, chunk=chunk, h0=h0)
    return y[:, :s], final
