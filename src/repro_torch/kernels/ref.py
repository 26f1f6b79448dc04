"""Plain PyTorch twins of the kernel-path ops.

Twins of :func:`repro.kernels.ref.lease_settle_ref` and
:func:`repro.kernels.ref.lease_validate_ref` (bitwise targets: int32 ids at
the boundary, -1 padding, the same clip semantics; torch indexes with
int64, so indices are widened inside); :func:`lease_drain_ref`, the
certification drain composed as the reference's cluster composes it
(flush, per-item locks from the class owners, ``lease_validate_ref``); and
twins of the model stack's float
oracles: :func:`sdpa_ref` (``repro.models.attention.attn_mask`` /
``_sdpa_ref``) and :func:`ssd_ref` (``repro.models.ssm.ssd_chunked``); and
:func:`moe_combine_ref` (``repro.kernels.ref.moe_combine_ref``).
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
    cur = store_versions[read_items.clamp(0, n - 1).long()]
    ok = torch.where(valid, cur == read_versions,
                     torch.ones_like(valid)).all(dim=1)
    if write_locks is not None and write_items is not None:
        wvalid = write_items >= 0
        locked = write_locks[write_items.clamp(0, n - 1).long()]
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
        cc = item_cc[write_items.clamp(0, n - 1).long()].long()
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
    rows = tok_slot.long()
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


# --- SSD (twin of repro.models.ssm.segsum / ssd_chunked) ------------------------

def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum log_a[..., j+1..i] (-inf j>i)."""
    l = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, float("-inf"))


def _chunks(x, dt, a, mat, chunk: int):
    """Per-chunk fp32 views: x ``[B,nc,L,H,P]``, dt ``[B,nc,L,H]``, the
    group matrix repeated to every head ``[B,nc,L,H,N]``, and the log decay
    per step and its cumsum over the chunk ``[B,nc,L,H]``."""
    bsz, s, h, p = x.shape
    g, n = mat.shape[2], mat.shape[3]
    assert s % chunk == 0, f"seq {s} not a multiple of chunk {chunk}"
    nc = s // chunk
    xr = x.reshape(bsz, nc, chunk, h, p).float()
    dtr = dt.reshape(bsz, nc, chunk, h).float()
    me = mat.reshape(bsz, nc, chunk, g, n).float().repeat_interleave(
        h // g, dim=3)
    da = dtr * a.float()[None, None, None, :]              # log decay per step
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
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if h0 is None else h0.float())
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
        .float().repeat_interleave(h // c_mat.shape[2], dim=3)
    seg = segsum(da.movedim(-1, -2))                       # [B,nc,H,L,L]

    # intra-chunk (diagonal) term: masked decay-weighted attention
    cb = torch.einsum("bnlhs,bnmhs->bnhlm", ce, be)        # [B,nc,H,L,L]
    w = cb * torch.exp(seg) * dtr.movedim(-1, -2)[:, :, :, None, :]
    y_diag = torch.einsum("bnhlm,bnmhp->bnlhp", w, xr)

    # off-diagonal contribution from the carried state
    state_decay = torch.exp(da_cum)                        # from chunk start
    y_off = torch.einsum("bnlhs,bnhps->bnlhp", ce, prev_states.float()) \
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


def pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the sequence axis (1) of ``t`` by ``pad`` steps at the end."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))],
                     dim=1)
