"""Transaction Forwarder (TF) message types and retry policy (§3.2).

The TF migrates the *commit phase* (and, on validation failure, the
*re-execution*) of a transaction from its origin node to a target chosen by
the DTD.  The messages below are exchanged over the GCS p2p service; the
actual state machine lives in the replica logic (``core/cluster.py``), which
implements:

* the **remote validation optimization** — the forwarded message carries the
  read-set (items + observed versions) and the write-set so the target can
  certify without re-executing;
* **bounded re-forwarding** — if a re-executed transaction's data-set changed
  such that the target no longer covers it, the target *must* acquire the
  leases itself rather than forward again (``ForwardPolicy.force_acquire``),
  preventing unbounded migration chains;
* **result piggybacking** — the transaction's return value produced at the
  target rides back to the origin on the commit message so the originating
  application thread can be resumed with it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple


@dataclass
class ForwardRequest:
    """Serialized transaction shipped to the target node (RMI-style)."""

    txid: int
    origin: int
    origin_thread: int
    ccs: FrozenSet[int]
    # remote-validation payload:
    read_items: Tuple[int, ...]
    read_versions: Tuple[int, ...]
    write_set: Dict[int, float]
    # re-execution closure id: benchmarks register generators so the target
    # can re-run the transactional logic (same input parameters).
    spec_id: int = -1
    attempt: int = 0


@dataclass
class CommitNotice:
    """Commit (or abort) outcome returned to the origin (piggybacked result)."""

    txid: int
    origin: int
    origin_thread: int
    committed: bool
    result: float = 0.0
    executed_on: int = -1


@dataclass(frozen=True)
class ForwardPolicy:
    max_reexec: int = 5          # re-execution attempts at the target
    max_forwards: int = 1        # migration chain bound (paper: one hop, then
                                 # the holder must acquire leases itself)

    def may_forward(self, attempt: int) -> bool:
        return attempt < self.max_forwards
