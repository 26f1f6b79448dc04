"""Dispatch points of the commit path: CUDA tensors -> kernel, CPU -> twin.

Counterparts of :func:`repro.kernels.ops.validate_transactions` and
:func:`repro.kernels.ops.settle_lease_batch`.  There is no backend probing:
the device of the tensors decides.  A CUDA tensor launches the kernel or
raises; only a tensor that lies on the CPU takes the plain twin.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .lease_validate import lease_validate


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
