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

Gradients.  The reference differentiates through its plain functions
alone (its Pallas kernels are forwards).  Here, where a gradient will flow
from CUDA tensors, :func:`attention` and :func:`ssd` run the forward kernel
inside a ``torch.autograd.Function`` whose backward launches the
hand-written backward kernels (``flash_attention.flash_attention_backward``
from the saved output and rows' log-sum-exp; ``ssd_scan.ssd_scan_backward``
from the saved inputs; each on the tensor cores (``tc``) at bf16's model
shapes, else on the CUDA cores): the gradients of the plain version,
accumulated in fp32 and rounded once, with no plain version and no
recompute on the card.  Their plain versions, ``ref.sdpa_bwd_ref`` and
``ref.ssd_bwd_ref`` (``tc``'s roundings: ``ref.sdpa_bwd_tc_ref``,
``ref.ssd_bwd_tc_ref``), serve the tests.  On the CPU the plain forward runs, and autograd
differentiates it natively.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.regions import region

from . import flash_attention as _flash
from . import ref
from . import ssd_scan as _ssd
from .lease_validate import DrainStaging, lease_drain, lease_validate

def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _Attention(torch.autograd.Function):
    """The flash kernel forward (which also writes the rows' lse) and the
    flash backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, opts):
        out, lse = _flash.flash_attention(q, k, v, q_positions=q_positions,
                                          kv_positions=kv_positions,
                                          return_lse=True, **opts)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, grad_out):
        with region("repro.attention.bwd"):
            q, k, v, out, lse, qp, kp = ctx.saved_tensors
            dq, dk, dv = _flash.flash_attention_backward(
                q, k, v, out, lse, grad_out.contiguous(), q_positions=qp,
                kv_positions=kp, **ctx.opts)
        return dq, dk, dv, None, None, None


class _SSD(torch.autograd.Function):
    """The SSD kernel forward and the SSD backward kernels (y in x's type,
    as the kernel returns it)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, h0)
        ctx.chunk = chunk
        return _ssd.ssd_scan(x, dt, a, b_mat, c_mat, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        with region("repro.ssd.bwd"):
            x, dt, a, b_mat, c_mat, h0 = ctx.saved_tensors
            dy = (torch.zeros_like(x) if grad_y is None
                  else grad_y.contiguous())
            dfinal = None if grad_final is None else grad_final.contiguous()
            dx, ddt, da, db, dc, dh0 = _ssd.ssd_scan_backward(
                x, dt, a, b_mat, c_mat, h0, dy, dfinal, chunk=ctx.chunk)
        return dx, ddt, da, db, dc, None if h0 is None else dh0, None


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

    CUDA tensors go to the flash kernel at every Sq (differentiable:
    where a gradient will flow, inside :class:`_Attention`, whose backward
    launches the backward kernels); CPU tensors, and any tensor when
    ``plain`` is set, to :func:`ref.sdpa_ref`.  Positions are
    handed to the kernel as contiguous int32 (the model broadcasts them).
    Where q, k and v differ in dtype (a float32 model over a bf16 KV
    ring), the kernel takes all three in the widest and the output is
    cast back to q's, as the plain version computes in fp32 and returns
    q's dtype.

    ``return_lse`` returns ``(out, lse)`` with each row's fp32 log-sum-exp
    ``[B, Sq, Hq]`` (the seq-sharded paths' combine), from every kernel
    variant.  It is a forward: on CUDA it raises where a gradient would
    flow (the lse output has no backward).
    """
    with region("repro.attention"):
        opts = dict(causal=causal, sliding_window=sliding_window,
                    logit_softcap=logit_softcap, scale=scale)
        if return_lse and q.device.type == "cuda" and not plain:
            if _wants_grad(q, k, v):
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
                wide = torch.promote_types(
                    torch.promote_types(q.dtype, k.dtype), v.dtype)
                return attention(q.to(wide), k.to(wide), v.to(wide),
                                 q_positions=q_positions,
                                 kv_positions=kv_positions, causal=causal,
                                 sliding_window=sliding_window,
                                 logit_softcap=logit_softcap,
                                 scale=scale).to(q.dtype)
            qp = q_positions.to(torch.int32).contiguous()
            kp = kv_positions.to(torch.int32).contiguous()
            if _wants_grad(q, k, v):
                return _Attention.apply(q, k, v, qp, kp, opts)
            return _flash.flash_attention(q, k, v, q_positions=qp,
                                          kv_positions=kp, **opts)
        return ref.sdpa_ref(q, k, v, q_positions=q_positions,
                            kv_positions=kv_positions,
                            return_lse=return_lse, **opts)


def ssd(x, dt, a, b_mat, c_mat, *, chunk=256, h0=None, plain=False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan; returns ``(y [B, S, H, P], final_state [B, H, P, N])``.

    S is zero-padded up to a multiple of ``chunk`` (as the reference's ref
    branch does, ``repro/models/ssm.py:216-227``) and ``y`` is cut back to
    S; padded steps have ``dt = 0``, so they leave the state unchanged.
    CUDA tensors go to the SSD kernel (``n_groups == 1``; anything else
    raises; differentiable: where a gradient will flow, inside
    :class:`_SSD`, whose backward launches the backward kernels); CPU
    tensors, and any tensor when ``plain`` is set, to :func:`ref.ssd_ref`.
    The padding is torch ops outside the kernel's Function, so gradients
    pass through it.
    """
    with region("repro.ssd"):
        s = x.shape[1]
        pad = (-s) % chunk
        x, dt, b_mat, c_mat = (ref.pad_seq(t, pad)
                               for t in (x, dt, b_mat, c_mat))
        if x.device.type == "cuda" and not plain:
            if _wants_grad(x, dt, a, b_mat, c_mat, h0):
                y, final = _SSD.apply(x, dt, a, b_mat, c_mat, h0, chunk)
            else:
                y, final = _ssd.ssd_scan(x, dt, a, b_mat, c_mat, chunk=chunk,
                                         h0=h0)
        else:
            y, final = ref.ssd_ref(x, dt, a, b_mat, c_mat, chunk=chunk, h0=h0)
        return y[:, :s], final
