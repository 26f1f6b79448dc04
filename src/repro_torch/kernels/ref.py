"""Plain PyTorch twins of the kernel-path ops.

Twins of :func:`repro.kernels.ref.lease_settle_ref` and
:func:`repro.kernels.ref.lease_validate_ref` (bitwise targets: int32 ids at
the boundary, -1 padding, the same clip semantics; torch's indexing
widens the int32 ids itself); :func:`lease_drain_ref`, the
certification drain composed as the reference's cluster composes it
(flush, per-item locks from the class owners, ``lease_validate_ref``); and
twins of the model stack's float
oracles: :func:`sdpa_ref` (``repro.models.attention.attn_mask`` /
``_sdpa_ref``) and :func:`ssd_ref` (``repro.models.ssm.ssd_chunked``); and
:func:`moe_combine_ref` (``repro.kernels.ref.moe_combine_ref``).  Beside the
plain versions, twins of the kernels' own arithmetic: the ``tc`` backwards'
bf16 roundings (:func:`sdpa_bwd_tc_ref`, :func:`ssd_bwd_tc_ref`) and the
flash ``simt`` kernels' split-TF32 products (:func:`tf32_split`,
:func:`sdpa_x3_ref`, :func:`sdpa_bwd_x3_ref`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def lease_settle_ref(
    head_req: torch.Tensor,       # [C] int32, -1 when the queue is empty
    head_proc: torch.Tensor,      # [C] int32
    head_active: torch.Tensor,    # [C] int32
    qlen: torch.Tensor,           # [C] int32
    fresh_blocked: torch.Tensor,  # [C] bool: head newly blocked this instant
    wait_req: torch.Tensor,       # [B, K] int32, -1 padded (waiting groups)
    wait_cc: torch.Tensor,        # [B, K] int32, -1 padded
    proc: int,                    # the settling replica
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One lease-settle over a replica's packed conflict-queue heads.

    Returns ``(owner[C] int32, free[C] bool, enabled[B] bool)``: head
    ownership (-1 unowned), the blocked-and-drained frees among the
    ``fresh_blocked`` heads, and Algorithm 1's ``isEnabled`` per waiting
    group (every LOR heads its queue, matched by req_id).
    """
    c = head_req.shape[0]
    occupied = qlen > 0
    owner = torch.where(occupied, head_proc,
                        torch.full_like(head_proc, -1)).to(torch.int32)
    free = occupied & fresh_blocked & (head_proc == proc) & (head_active == 0)
    valid = wait_cc >= 0
    # lint: allow(id-dtype): widened once for the two lookups below (an
    # int32 index is widened by advanced indexing at each)
    cc = wait_cc.clamp(0, max(c - 1, 0)).long()
    at_head = occupied[cc] & (head_req[cc] == wait_req)
    enabled = torch.where(valid, at_head, torch.ones_like(at_head)).all(dim=1)
    return owner, free, enabled


def lease_validate_ref(
    store_versions: torch.Tensor,                 # [n_items] int32
    read_items: torch.Tensor,                     # [B, R] int32, -1 padded
    read_versions: torch.Tensor,                  # [B, R] int32
    write_locks: Optional[torch.Tensor] = None,   # [n_items] bool
    write_items: Optional[torch.Tensor] = None,   # [B, W] int32, -1 padded
) -> torch.Tensor:
    """TL2 certification: read versions unchanged AND write set unlocked.

    An item is clipped to ``[0, n_items - 1]``; a negative slot always
    passes.  Returns ``ok[B]`` bool.
    """
    n = store_versions.shape[0]
    valid = read_items >= 0
    cur = store_versions[read_items.clamp(0, n - 1)]
    ok = torch.where(valid, cur == read_versions,
                     torch.ones_like(valid)).all(dim=1)
    if write_locks is not None and write_items is not None:
        wvalid = write_items >= 0
        locked = write_locks[write_items.clamp(0, n - 1)]
        ok &= torch.where(wvalid, ~locked, torch.ones_like(wvalid)).all(dim=1)
    return ok


def lease_drain_ref(
    versions_dev: torch.Tensor,            # [n_items] int32, updated in place
    dirty_idx: torch.Tensor,               # [n_dirty] int32 items
    dirty_ver: torch.Tensor,               # [n_dirty] int32 their versions
    item_cc: Optional[torch.Tensor],       # [n_items] int32 item -> class
    owners: Optional[torch.Tensor],        # [n_classes] int32, -1 unowned
    node: int,                             # the certifying replica
    read_items: torch.Tensor,              # [B, R] int32, -1 padded
    read_versions: torch.Tensor,           # [B, R] int32
    write_items: Optional[torch.Tensor],   # [B, W] int32, -1 padded
) -> torch.Tensor:
    """One certification drain: flush, then certify against the flushed table.

    Scatters the dirty pairs into ``versions_dev`` (callers pass each
    item's current version, so a repeated item carries one value), then
    certifies as :func:`lease_validate_ref` with a write item locked when
    ``owner = owners[item_cc[item]]`` is ``>= 0`` and ``!= node`` (the
    cluster's per-item lock rule, applied to the write slots only); a
    class outside ``owners`` fails closed (the slot counts as locked), as
    in the kernel.  Without ``item_cc`` every write check passes.  Returns
    ``ok[B]`` bool.
    """
    if dirty_idx.numel():
        versions_dev[dirty_idx.long()] = dirty_ver
    ok = lease_validate_ref(versions_dev, read_items, read_versions)
    if item_cc is not None and write_items is not None:
        n, n_classes = versions_dev.shape[0], owners.shape[0]
        valid = write_items >= 0
        cc = item_cc[write_items.clamp(0, n - 1)]
        known = (cc >= 0) & (cc < n_classes)
        owner = owners[cc.clamp(0, max(n_classes - 1, 0))]
        locked = ~known | ((owner >= 0) & (owner != node))
        ok &= torch.where(valid, ~locked, torch.ones_like(valid)).all(dim=1)
    return ok


# --- MoE combine oracle --------------------------------------------------------

def moe_combine_ref(
    back: torch.Tensor,        # [ep * tp * capacity, d] returned partials
    tok_slot: torch.Tensor,    # [ep * capacity] int32, t_out when empty
    gate_slot: torch.Tensor,   # [ep * capacity] f32, 0 when empty
    *,
    tp: int,
    capacity: int,
    t_out: int,
) -> torch.Tensor:
    """Combine leg of the tp-aware MoE a2a: the partial-activation psum.

    Each expert-group slot came back as ``tp`` f-slice partials (one per
    chunk rank, contiguous blocks of ``capacity`` rows per rank); gate each
    partial, sum over the tp blocks, and scatter the rows to their owning
    token rows.  An empty slot (token ``t_out``) is dropped, as the
    reference's ``mode="drop"`` drops it; callers make no negative token.
    """
    d = back.shape[-1]
    gate = gate_slot.reshape(-1, 1, capacity, 1).to(back.dtype)
    gated = (back.reshape(-1, tp, capacity, d) * gate).sum(dim=1)
    rows = tok_slot
    keep = (rows >= 0) & (rows < t_out)
    # empty slots land in an overflow row that is cut off: no shape
    # depends on the slots' contents
    out = torch.zeros((t_out + 1, d), dtype=back.dtype, device=back.device)
    out.index_add_(0, torch.where(keep, rows, t_out), gated.reshape(-1, d))
    return out[:t_out]


# --- attention (twin of repro.models.attention.attn_mask / _sdpa_ref) ---------

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attn_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
              sliding_window: Optional[int]) -> torch.Tensor:
    """Boolean ``[B, Sq, Skv]`` mask (True = attend)."""
    dq = q_pos[:, :, None]
    dk = kv_pos[:, None, :]
    m = torch.ones((q_pos.shape[0], q_pos.shape[1], kv_pos.shape[1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= dk <= dq
    if sliding_window is not None:
        m &= dk > dq - sliding_window
    return m


def _sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, scale: float,
              logit_softcap: float = 0.0, return_lse: bool = False):
    """Grouped-query attention in fp32 with a full score matrix; with
    ``return_lse`` also each row's fp32 log-sum-exp ``[B, Sq, Hq]`` of its
    masked scores (hidden ones at ``NEG_INF``)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if logit_softcap > 0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1)                   # [b, h, g, q]
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, hq)


def sdpa_ref(q, k, v, *, q_positions, kv_positions, causal=True,
             sliding_window=None, logit_softcap=0.0, scale=None,
             return_lse=False):
    """Plain version of the flash kernel (``repro.kernels.ref.sdpa_ref``);
    ``return_lse`` adds the rows' log-sum-exp, as the kernel's
    ``decode_split`` returns it."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask = attn_mask(q_positions, kv_positions, causal, sliding_window)
    return _sdpa_ref(q, k, v, mask, scale, logit_softcap, return_lse)


def sdpa_bwd_ref(q, k, v, out, lse, dout, *, q_positions, kv_positions,
                 causal=True, sliding_window=None, logit_softcap=0.0,
                 scale=None):
    """Plain version of the flash backward kernels: ``(dq, dk, dv)`` of
    :func:`sdpa_ref` for the output gradient ``dout``, from the forward's
    output and rows' log-sum-exp, with full ``[Sq, Skv]`` matrices in fp32.

    The kernels' phases: ``D = rowsum(dout * out)``; ``P = exp(S - lse)``
    on the visible keys (0 on hidden ones), ``S`` the scaled and capped
    scores; ``dV = P^T dout``; ``dP = dout V^T``; ``dS = P (dP - D)``,
    times ``1 - tanh^2`` under a softcap; ``dQ = dS K scale``, ``dK =
    dS^T Q scale``.  Each gradient is rounded once to its input's dtype.
    It equals the autograd gradient of :func:`sdpa_ref` on every query
    row that sees at least one key; a row that sees none gets none.
    """
    b, sq, hq, dk = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = scale if scale is not None else dk ** -0.5
    mask = attn_mask(q_positions, kv_positions, causal, sliding_window)
    qf = q.float().reshape(b, sq, hkv, g, dk)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(b, sq, hkv, g, dv)
    delta = (do * out.float().reshape(b, sq, hkv, g, dv)).sum(-1)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if logit_softcap > 0:
        t = torch.tanh(s / logit_softcap)
        s = logit_softcap * t
    rows = lse.float().reshape(b, sq, hkv, g).permute(0, 2, 3, 1)[..., None]
    p = torch.where(mask[:, None, None], torch.exp(s - rows),
                    torch.zeros((), device=q.device))
    dv_ = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if logit_softcap > 0:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk_ = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return (dq.reshape(b, sq, hq, dk).to(q.dtype), dk_.to(k.dtype),
            dv_.to(v.dtype))


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero: half a TF32 ulp added to the bits, the 13
    below the TF32 mantissa cleared (``hopper::tf32_rna``)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` in fp32 as its two TF32 parts ``(big, small)``, as the
    split-TF32 kernels take an fp32 operand (``csrc/flash_mma.cuh``):
    ``big`` is ``x`` rounded as ``cvt.rna.tf32.f32`` rounds (to nearest,
    ties away from zero), ``small`` the same rounding of ``x - big``; ``big
    + small`` keeps ~22 of fp32's 24 bits.  A bf16 value is exact in TF32:
    its ``small`` is 0."""
    x = x.float()
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def _x3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` of fp32 operands as the split-TF32 kernels take
    it: the three products of the parts, the two small terms first, summed
    in fp32 (the small-by-small term dropped)."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    return (torch.einsum(eq, a_big, b_small) + torch.einsum(eq, a_small, b_big)
            + torch.einsum(eq, a_big, b_big))


def sdpa_x3_ref(q, k, v, *, q_positions, kv_positions, causal=True,
                sliding_window=None, logit_softcap=0.0, scale=None,
                return_lse=False):
    """Plain version of the ``simt`` flash forward's arithmetic
    (``csrc/flash_simt.cuh``): :func:`sdpa_ref` with ``S = Q K^T`` and ``P
    V`` each taken as split-TF32 products (:func:`tf32_split`), ``P`` the
    unnormalised ``exp(S - max)`` in fp32, the sum divided once at the end;
    with ``return_lse`` each row's fp32 log-sum-exp too."""
    b, sq, hq, dk = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else dk ** -0.5
    mask = attn_mask(q_positions, kv_positions, causal, sliding_window)
    qg = q.float().reshape(b, sq, hkv, g, dk)
    s = _x3("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if logit_softcap > 0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                         # [b, h, g, q, 1]
    out = _x3("bhgqk,bkhd->bqhgd", p, v.float()) / l.permute(0, 3, 1, 2, 4)
    out = out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l))[..., 0]                        # [b, h, g, q]
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, hq)


def sdpa_bwd_x3_ref(q, k, v, out, lse, dout, *, q_positions, kv_positions,
                    causal=True, sliding_window=None, logit_softcap=0.0,
                    scale=None):
    """Plain version of the ``simt`` flash backward's arithmetic
    (``csrc/flash_backward.cuh``): :func:`sdpa_bwd_ref`'s phases with every
    product (``S``, ``dP``, ``dV = P^T dO``, ``dQ = dS K``, ``dK = dS^T
    Q``) taken as split-TF32 products of fp32 operands, ``P`` and ``dS``
    included (:func:`tf32_split`); ``D = rowsum(dO O)`` plain.  Each
    gradient rounded once to its input's dtype."""
    b, sq, hq, dk = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = scale if scale is not None else dk ** -0.5
    mask = attn_mask(q_positions, kv_positions, causal, sliding_window)
    qf = q.float().reshape(b, sq, hkv, g, dk)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(b, sq, hkv, g, dv)
    delta = (do * out.float().reshape(b, sq, hkv, g, dv)).sum(-1)
    s = _x3("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if logit_softcap > 0:
        t = torch.tanh(s / logit_softcap)
        s = logit_softcap * t
    rows = lse.float().reshape(b, sq, hkv, g).permute(0, 2, 3, 1)[..., None]
    p = torch.where(mask[:, None, None], torch.exp(s - rows),
                    torch.zeros((), device=q.device))
    dv_ = _x3("bhgqk,bqhgd->bkhd", p, do)
    dp = _x3("bqhgd,bkhd->bhgqk", do, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if logit_softcap > 0:
        ds = ds * (1 - t * t)
    dq = _x3("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk_ = _x3("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return (dq.reshape(b, sq, hq, dk).to(q.dtype), dk_.to(k.dtype),
            dv_.to(v.dtype))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and back to fp32, as a kernel rounds a tile
    before a tensor-core product."""
    return t.to(torch.bfloat16).float()


def sdpa_bwd_tc_ref(q, k, v, out, lse, dout, *, q_positions, kv_positions,
                    causal=True, sliding_window=None, logit_softcap=0.0,
                    scale=None):
    """Plain version of the ``tc`` flash backward
    (``csrc/flash_backward_tc.cuh``): :func:`sdpa_bwd_ref`'s phases with
    the kernel's roundings.  ``P`` and ``dS`` are formed in fp32 and each
    rounded once to bf16 before its products (``dV = P^T dO``, ``dK =
    dS^T Q``, ``dQ = dS K``), which sum in fp32: over each q head's rows,
    then over the heads of a GQA group in order.  bf16 inputs; each
    gradient rounded once to bf16.
    """
    b, sq, hq, dk = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = scale if scale is not None else dk ** -0.5
    mask = attn_mask(q_positions, kv_positions, causal, sliding_window)
    qf = q.float().reshape(b, sq, hkv, g, dk)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(b, sq, hkv, g, dv)
    delta = (do * out.float().reshape(b, sq, hkv, g, dv)).sum(-1)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if logit_softcap > 0:
        t = torch.tanh(s / logit_softcap)
        s = logit_softcap * t
    rows = lse.float().reshape(b, sq, hkv, g).permute(0, 2, 3, 1)[..., None]
    p = torch.where(mask[:, None, None], torch.exp(s - rows),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if logit_softcap > 0:
        ds = ds * (1 - t * t)
    p, ds = _bf16(p), _bf16(ds)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk_ = torch.zeros((b, skv, hkv, dk), device=q.device)
    dv_ = torch.zeros((b, skv, hkv, dv), device=q.device)
    for j in range(g):
        dv_ += torch.einsum("bhqk,bqhd->bkhd", p[:, :, j], do[:, :, :, j])
        dk_ += torch.einsum("bhqk,bqhd->bkhd", ds[:, :, j], qf[:, :, :, j])
    return (dq.reshape(b, sq, hq, dk).to(q.dtype), (dk_ * scale).to(k.dtype),
            dv_.to(v.dtype))


# --- SSD (twin of repro.models.ssm.segsum / ssd_chunked) ------------------------

def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum log_a[..., j+1..i] (-inf j>i)."""
    l = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, float("-inf"))


def _wd(ref: torch.Tensor) -> torch.dtype:
    """The SSD plain versions' working type: fp32, or fp64 for fp64
    inputs (an fp64 evaluation, the truth the fp32 ones are held to)."""
    return torch.float64 if ref.dtype == torch.float64 else torch.float32


def _chunks(x, dt, a, mat, chunk: int):
    """Per-chunk views in the working type (:func:`_wd`): x
    ``[B,nc,L,H,P]``, dt ``[B,nc,L,H]``, the group matrix repeated to every
    head ``[B,nc,L,H,N]``, and the log decay per step and its cumsum over
    the chunk ``[B,nc,L,H]``."""
    bsz, s, h, p = x.shape
    g, n = mat.shape[2], mat.shape[3]
    assert s % chunk == 0, f"seq {s} not a multiple of chunk {chunk}"
    nc = s // chunk
    wd = _wd(x)
    xr = x.reshape(bsz, nc, chunk, h, p).to(wd)
    dtr = dt.reshape(bsz, nc, chunk, h).to(wd)
    me = mat.reshape(bsz, nc, chunk, g, n).to(wd).repeat_interleave(
        h // g, dim=3)
    da = dtr * a.to(wd)[None, None, None, :]               # log decay per step
    return xr, dtr, me, da, torch.cumsum(da, dim=2)


def ssd_states(x, dt, a, b_mat, chunk: int, h0=None):
    """Phase 1 of the chunked scan: each chunk's own state, passed along.

    Returns the fp32 states *entering* each chunk ``[B, nc, H, P, N]`` and
    the final fp32 state ``[B, H, P, N]``.  Plain twin of the ``tc``
    variant's ``ssd_state`` kernel.
    """
    bsz, _, h, p = x.shape
    n = b_mat.shape[3]
    xr, dtr, be, _, da_cum = _chunks(x, dt, a, b_mat, chunk)

    # chunk-final states from the chunk's own steps
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)   # [B,nc,L,H]
    wx = (decay_states * dtr)[..., None] * xr                  # [B,nc,L,H,P]
    states = torch.einsum("bnlhs,bnlhp->bnhps", be, wx)

    # inter-chunk recurrence over the nc chunk states
    chunk_decay = torch.exp(da_cum[:, :, -1, :])           # [B,nc,H]
    carry = (torch.zeros((bsz, h, p, n), dtype=xr.dtype, device=x.device)
             if h0 is None else h0.to(xr.dtype))
    prevs = []
    for c in range(xr.shape[1]):
        prevs.append(carry)                 # state *entering* chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(prevs, dim=1), carry


def ssd_outputs(x, dt, a, b_mat, c_mat, chunk: int, prev_states):
    """Phase 2 of the chunked scan: y (fp32 ``[B, S, H, P]``) from each
    chunk's own steps and the states entering it (``[B, nc, H, P, N]``).
    Plain twin of the ``tc`` variant's ``ssd_chunk_scan`` kernel."""
    bsz, s, h, p = x.shape
    xr, dtr, be, da, da_cum = _chunks(x, dt, a, b_mat, chunk)
    ce = c_mat.reshape(be.shape[:3] + (c_mat.shape[2], c_mat.shape[3])) \
        .to(xr.dtype).repeat_interleave(h // c_mat.shape[2], dim=3)
    seg = segsum(da.movedim(-1, -2))                       # [B,nc,H,L,L]

    # intra-chunk (diagonal) term: masked decay-weighted attention
    cb = torch.einsum("bnlhs,bnmhs->bnhlm", ce, be)        # [B,nc,H,L,L]
    w = cb * torch.exp(seg) * dtr.movedim(-1, -2)[:, :, :, None, :]
    y_diag = torch.einsum("bnhlm,bnmhp->bnlhp", w, xr)

    # off-diagonal contribution from the carried state
    state_decay = torch.exp(da_cum)                        # from chunk start
    y_off = torch.einsum("bnlhs,bnhps->bnlhp", ce, prev_states.to(xr.dtype)) \
        * state_decay[..., None]
    return (y_diag + y_off).reshape(bsz, s, h, p)


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, h0=None,
                return_final_state: bool = False):
    """Chunked state-space-duality scan; S must be a multiple of ``chunk``.

    ``x [B, S, H, P]``, ``dt [B, S, H]`` (softplus'd), ``a [H]``,
    ``b_mat``/``c_mat [B, S, G, N]``, ``h0 [B, H, P, N]``.  Returns ``y``
    (fp32) and, if asked, the final fp32 state: :func:`ssd_outputs` over
    :func:`ssd_states`.
    """
    prev_states, carry = ssd_states(x, dt, a, b_mat, chunk, h0=h0)
    y = ssd_outputs(x, dt, a, b_mat, c_mat, chunk, prev_states)
    if return_final_state:
        return y, carry
    return y


def ssd_ref(x, dt, a, b_mat, c_mat, *, chunk=256, h0=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the SSD kernel (``repro.kernels.ref.ssd_ref``)."""
    return ssd_chunked(x, dt, a, b_mat, c_mat, chunk, h0=h0,
                       return_final_state=True)


def ssd_bwd_ref(x, dt, a, b_mat, c_mat, h0, dy, dfinal, *, chunk):
    """Plain version of the SSD backward kernels: the gradients ``(dx,
    ddt, da, db_mat, dc_mat, dh0)`` of :func:`ssd_ref` (``n_groups ==
    1``) for ``dy [B, S, H, P]`` and ``dfinal [B, H, P, N]`` (None: zero),
    in the kernels' three phases:

    (i) the fp32 state entering each chunk (:func:`ssd_states`);
    (ii) the reverse pass: ``dh`` entering chunk c is ``exp(sum of da over
        c) * dh(c + 1) + sum_t exp(dacum_t) dy_t (x) C_t``, from
        ``dfinal``; ``dh0`` is the last;
    (iii) per chunk, the intra-chunk term's and the carried state's
        gradients with full ``[L, L]`` matrices, the gradient of ``dacum``
        summed back to ``da`` per step (``ddt += a d(da)``, ``da = sum dt
        d(da)``).

    ``db_mat``, ``dc_mat`` and ``da`` are summed over heads and sequence.
    Each gradient is rounded once to its input's dtype (``dh0`` fp32).
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    nc = s // chunk
    xr, dtr, be, da, cum = _chunks(x, dt, a, b_mat, chunk)
    ce = c_mat.reshape(bsz, nc, chunk, 1, n).to(xr.dtype) \
        .expand(-1, -1, -1, h, -1)
    dyr = dy.reshape(bsz, nc, chunk, h, p).to(xr.dtype)
    # (i)
    entering, _ = ssd_states(x, dt, a, b_mat, chunk, h0=h0)  # [B,nc,H,P,N]
    # (ii)
    own = torch.einsum("bclh,bclhp,bclhn->bchpn", torch.exp(cum), dyr, ce)
    decay = torch.exp(cum[:, :, -1, :])                    # [B,nc,H]
    carry = (torch.zeros((bsz, h, p, n), dtype=xr.dtype, device=x.device)
             if dfinal is None else dfinal.to(xr.dtype))
    leaving = [None] * nc            # dh of the state leaving chunk c
    for c in reversed(range(nc)):
        leaving[c] = carry
        carry = carry * decay[:, c, :, None, None] + own[:, c]
    dh0 = carry
    g_out = torch.stack(leaving, dim=1)                    # [B,nc,H,P,N]
    # (iii) the intra-chunk term: y_diag = (CB * M * dt_m) x
    m_dec = torch.exp(segsum(da.movedim(-1, -2)))          # [B,nc,H,L,L]
    cb = torch.einsum("bclhn,bcmhn->bchlm", ce, be)
    dw = torch.einsum("bclhp,bcmhp->bchlm", dyr, xr)
    dtm = dtr.movedim(-1, -2)[:, :, :, None, :]            # [B,nc,H,1,L]
    cbm = cb * m_dec
    dcb = dw * m_dec * dtm
    dx = torch.einsum("bchlm,bclhp->bcmhp", cbm, dyr) * dtr[..., None]
    dcm = torch.einsum("bchlm,bcmhn->bclhn", dcb, be)
    dbm = torch.einsum("bchlm,bclhn->bcmhn", dcb, ce)
    e_col = (dw * cbm).sum(-2).movedim(-1, -2)             # [B,nc,L,H]
    dcum = (dcb * cb).sum(-1).movedim(-1, -2) - dtr * e_col
    # the carried state's term: y_off = exp(dacum) C h_in
    d_off = torch.einsum("bclhp,bchpn->bclhn", dyr, entering) \
        * torch.exp(cum)[..., None]
    dcm = dcm + d_off
    dcum = dcum + (ce * d_off).sum(-1)
    # the state leaving the chunk: exp(dacum_L) h_in + sum r dt x (x) B
    r = torch.exp(cum[:, :, -1:, :] - cum)                 # [B,nc,L,H]
    xg = torch.einsum("bcmhp,bchpn->bcmhn", xr, g_out)
    bg = torch.einsum("bcmhn,bchpn->bcmhp", be, g_out)
    dx = dx + (r * dtr)[..., None] * bg
    dbm = dbm + (r * dtr)[..., None] * xg
    f_dt = r * (be * xg).sum(-1)                           # [B,nc,L,H]
    dcum = dcum - dtr * f_dt
    last = (dtr * f_dt).sum(2) + decay * (entering * g_out).sum((-1, -2))
    dcum[:, :, -1, :] += last
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))
    ddt = e_col + f_dt + a.to(xr.dtype) * dda
    da_grad = (dtr * dda).sum((0, 1, 2))
    return (dx.reshape(x.shape).to(x.dtype), ddt.reshape(dt.shape).to(dt.dtype),
            da_grad.to(a.dtype),
            dbm.sum(3).reshape(bsz, s, 1, n).to(b_mat.dtype),
            dcm.sum(3).reshape(bsz, s, 1, n).to(c_mat.dtype), dh0)


def ssd_bwd_tc_ref(x, dt, a, b_mat, c_mat, h0, dy, dfinal, *, chunk):
    """Plain version of the ``tc`` SSD backward
    (``csrc/ssd_backward_tc.cuh``): :func:`ssd_bwd_ref`'s phases with the
    kernel's roundings.  The entering states are rounded once to bf16 (as
    the forward's ``ssd_state`` writes them) and the leaving states'
    gradient ``G`` is rounded to bf16 for its products (its fp32 value for
    ``h_in . G``); the tiles ``CB * M`` (for dx) and ``dCB = dW * M * dt``
    (for dB and dC, per head) are each formed in fp32 and rounded once to
    bf16; the products sum in fp32.  The sums behind d(dacum) (rows of
    ``dCB * CB``, columns of ``dW * CB * M``, ``C . d_off``, ``X . BG``)
    take the fp32 values.  bf16 inputs; dx, dB and dC rounded once to bf16.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    nc = s // chunk
    xr, dtr, be, da, cum = _chunks(x, dt, a, b_mat, chunk)
    ce = c_mat.reshape(bsz, nc, chunk, 1, n).to(xr.dtype) \
        .expand(-1, -1, -1, h, -1)
    dyr = dy.reshape(bsz, nc, chunk, h, p).to(xr.dtype)
    entering, _ = ssd_states(x, dt, a, b_mat, chunk, h0=h0)
    entering = _bf16(entering)
    own = torch.einsum("bclh,bclhp,bclhn->bchpn", torch.exp(cum), dyr, ce)
    decay = torch.exp(cum[:, :, -1, :])
    carry = (torch.zeros((bsz, h, p, n), dtype=xr.dtype, device=x.device)
             if dfinal is None else dfinal.to(xr.dtype))
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = carry
        carry = carry * decay[:, c, :, None, None] + own[:, c]
    dh0 = carry
    g_out = torch.stack(leaving, dim=1)
    g_b = _bf16(g_out)
    m_dec = torch.exp(segsum(da.movedim(-1, -2)))
    cb = torch.einsum("bclhn,bcmhn->bchlm", ce, be)
    dw = torch.einsum("bclhp,bcmhp->bchlm", dyr, xr)
    dtm = dtr.movedim(-1, -2)[:, :, :, None, :]
    cbm = cb * m_dec
    dcb = dw * m_dec * dtm
    dx = torch.einsum("bchlm,bclhp->bcmhp", _bf16(cbm), dyr) \
        * dtr[..., None]
    dcm = torch.einsum("bchlm,bcmhn->bclhn", _bf16(dcb), be)
    dbm = torch.einsum("bchlm,bclhn->bcmhn", _bf16(dcb), ce)
    e_col = (dw * cbm).sum(-2).movedim(-1, -2)
    dcum = (dcb * cb).sum(-1).movedim(-1, -2) - dtr * e_col
    d_off = torch.einsum("bclhp,bchpn->bclhn", dyr, entering) \
        * torch.exp(cum)[..., None]
    dcm = dcm + d_off
    dcum = dcum + (ce * d_off).sum(-1)
    r = torch.exp(cum[:, :, -1:, :] - cum)
    xg = torch.einsum("bcmhp,bchpn->bcmhn", xr, g_b)
    bg = torch.einsum("bcmhn,bchpn->bcmhp", be, g_b)
    dx = dx + (r * dtr)[..., None] * bg
    dbm = dbm + (r * dtr)[..., None] * xg
    f_dt = r * (xr * bg).sum(-1)
    dcum = dcum - dtr * f_dt
    last = (dtr * f_dt).sum(2) + decay * (entering * g_out).sum((-1, -2))
    dcum[:, :, -1, :] += last
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))
    ddt = e_col + f_dt + a.to(xr.dtype) * dda
    da_grad = (dtr * dda).sum((0, 1, 2))
    return (dx.reshape(x.shape).to(x.dtype), ddt.reshape(dt.shape).to(dt.dtype),
            da_grad.to(a.dtype),
            dbm.sum(3).reshape(bsz, s, 1, n).to(b_mat.dtype),
            dcm.sum(3).reshape(bsz, s, 1, n).to(c_mat.dtype), dh0)


def _cum_serial(dtr: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """dacum over each chunk as the ``simt`` kernels take it: one serial
    fp32 sum a (b, chunk, head), each step ``cum + dt * a`` rounded once
    (a fused multiply-add; the product is exact in fp64)."""
    step = dtr.double() * a.double()[None, None, None, :]
    run = torch.zeros_like(dtr[:, :, 0])
    out = []
    for i in range(dtr.shape[2]):
        run = (run.double() + step[:, :, i]).float()
        out.append(run)
    return torch.stack(out, dim=2)


def _seg(cum: torch.Tensor) -> torch.Tensor:
    """``dacum[i] - dacum[j]`` over a chunk ``[B, nc, H, L, L]`` from
    ``cum [B, nc, L, H]``, -inf above the diagonal (:func:`segsum` of
    given sums)."""
    c = cum.movedim(-1, -2)
    l = c.shape[-1]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=c.device))
    return torch.where(mask, c[..., :, None] - c[..., None, :], float("-inf"))


def _ssd_states_x3(xr, dtr, be, cum, h0):
    """The ``simt`` ``state_kernel``'s arithmetic: per chunk ``state =
    exp(dacum[L-1]) state + (w x)^T B`` with ``w = exp(dacum[L-1] - dacum)
    dt`` and the product split-TF32; the states entering each chunk ``[B,
    nc, H, P, N]`` and the final state."""
    wx = (torch.exp(cum[:, :, -1:, :] - cum) * dtr)[..., None] * xr
    own = _x3("bnlhs,bnlhp->bnhps", be, wx)
    decay = torch.exp(cum[:, :, -1, :])
    carry = (torch.zeros(own.shape[:1] + own.shape[2:], dtype=torch.float32,
                         device=xr.device)
             if h0 is None else h0.float())
    prevs = []
    for c in range(xr.shape[1]):
        prevs.append(carry)
        carry = carry * decay[:, c, :, None, None] + own[:, c]
    return torch.stack(prevs, dim=1), carry


def ssd_x3_ref(x, dt, a, b_mat, c_mat, *, chunk=256, h0=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``simt`` SSD forward's arithmetic
    (``csrc/ssd_simt.cuh``): :func:`ssd_ref` (``n_groups == 1``) with every
    product taken as the three split-TF32 products (:func:`tf32_split`):
    the state product, ``C B^T``, ``W x`` (``W = C B^T * exp(dacum_i -
    dacum_j) * dt_j``, masked to ``j <= i``) and ``C . state^T`` (times
    ``exp(dacum_i)``), summed in fp32.  Returns fp32 ``y`` and the final
    state."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    xr, dtr, be, _, _ = _chunks(x, dt, a, b_mat, chunk)
    cum = _cum_serial(dtr, a)
    ce = c_mat.reshape(bsz, s // chunk, chunk, 1, n).float() \
        .expand(-1, -1, -1, h, -1)
    entering, final = _ssd_states_x3(xr, dtr, be, cum, h0)
    cb = _x3("bnlhs,bnmhs->bnhlm", ce, be)
    w = cb * torch.exp(_seg(cum)) * dtr.movedim(-1, -2)[:, :, :, None, :]
    y = _x3("bnlhs,bnhps->bnlhp", ce, entering) * torch.exp(cum)[..., None] \
        + _x3("bnhlm,bnmhp->bnlhp", w, xr)
    return y.reshape(bsz, s, h, p), final


def ssd_bwd_x3_ref(x, dt, a, b_mat, c_mat, h0, dy, dfinal, *, chunk):
    """Plain version of the ``simt`` SSD backward's arithmetic
    (``csrc/ssd_backward.cuh``): :func:`ssd_bwd_ref`'s phases with the
    entering states of :func:`ssd_x3_ref`'s state product and every
    product taken as the three split-TF32 products, a row scale folded
    into its operand as the kernels fold it (``exp(dacum) dy`` for the
    leaving states' gradient and ``dC``'s carried term, ``r dt x`` for
    ``dB``'s).  The sums behind d(dacum) take the fp32 values.  Each
    gradient rounded once to its input's dtype (``dh0`` fp32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    nc = s // chunk
    xr, dtr, be, _, _ = _chunks(x, dt, a, b_mat, chunk)
    cum = _cum_serial(dtr, a)
    ce = c_mat.reshape(bsz, nc, chunk, 1, n).float().expand(-1, -1, -1, h, -1)
    dyr = dy.reshape(bsz, nc, chunk, h, p).float()
    entering, _ = _ssd_states_x3(xr, dtr, be, cum, h0)
    e_dy = torch.exp(cum)[..., None] * dyr                 # exp(dacum) dy
    own = _x3("bclhp,bclhn->bchpn", e_dy, ce)
    decay = torch.exp(cum[:, :, -1, :])
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if dfinal is None else dfinal.float())
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = carry
        carry = carry * decay[:, c, :, None, None] + own[:, c]
    dh0 = carry
    g_out = torch.stack(leaving, dim=1)
    m_dec = torch.exp(_seg(cum))
    cb = _x3("bclhn,bcmhn->bchlm", ce, be)
    dw = _x3("bclhp,bcmhp->bchlm", dyr, xr)
    dtm = dtr.movedim(-1, -2)[:, :, :, None, :]
    cbm = cb * m_dec
    dcb = dw * m_dec * dtm
    dx = _x3("bchlm,bclhp->bcmhp", cbm, dyr)
    dcm = _x3("bchlm,bcmhn->bclhn", dcb, be) \
        + _x3("bclhp,bchpn->bclhn", e_dy, entering)
    dbm = _x3("bchlm,bclhn->bcmhn", dcb, ce)
    e_col = (dw * m_dec * cb).sum(-2).movedim(-1, -2)
    t1 = _x3("bclhn,bchpn->bclhp", ce, entering)           # C h_in^T
    dcum = (dcb * cb).sum(-1).movedim(-1, -2) - dtr * e_col \
        + torch.exp(cum) * (dyr * t1).sum(-1)
    r = torch.exp(cum[:, :, -1:, :] - cum)
    bg = _x3("bcmhn,bchpn->bcmhp", be, g_out)               # B G^T
    dx = (dx + r[..., None] * bg) * dtr[..., None]
    dbm = dbm + _x3("bcmhp,bchpn->bcmhn", (r * dtr)[..., None] * xr, g_out)
    f_dt = r * (xr * bg).sum(-1)
    dcum = dcum - dtr * f_dt
    last = (dtr * f_dt).sum(2) + decay * (entering * g_out).sum((-1, -2))
    dcum[:, :, -1, :] += last
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))
    ddt = e_col + f_dt + a.float() * dda
    da_grad = (dtr * dda).sum((0, 1, 2))
    return (dx.reshape(x.shape).to(x.dtype), ddt.reshape(dt.shape).to(dt.dtype),
            da_grad.to(a.dtype),
            dbm.sum(3).reshape(bsz, s, 1, n).to(b_mat.dtype),
            dcm.sum(3).reshape(bsz, s, 1, n).to(c_mat.dtype), dh0)


def pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the sequence axis (1) of ``t`` by ``pad`` steps at the end."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))],
                     dim=1)
