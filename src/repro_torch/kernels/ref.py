"""Plain PyTorch twins of the kernel-path ops (the bitwise targets).

Twins of :func:`repro.kernels.ref.lease_settle_ref` and
:func:`repro.kernels.ref.lease_validate_ref`: int32 ids at the boundary,
-1 padding, the same clip semantics.  Torch indexes with int64, so indices
are widened inside.
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
