"""Simulated view-synchronous Group Communication Service (Appia stand-in).

Provides the three primitives the paper's stack relies on, with the
communication-step latency model the paper itself uses to quantify costs
(§3.3): point-to-point = 1 step, URB = 2 steps, OAB = 3 steps (optimistic
delivery after 1 step, final total-order delivery after 3).

Guarantees preserved by the simulation (and relied upon by the lease
protocol's deadlock-freedom — see core/lease.py docstring):

* **OAB total order**: TO-deliver order is identical at every node (we order
  by broadcast issue time with a deterministic sequence tie-break);
* **Opt-before-TO**: optimistic delivery strictly precedes final delivery at
  every node;
* **per-sender FIFO URB**: messages UR-broadcast by one node deliver in issue
  order everywhere (constant latency preserves this), and a node's own
  UR-broadcasts are causally ordered after everything it delivered;
* **view synchrony**: `fail(node)` removes a member; a view-change callback
  fires at every surviving member at the same simulated instant, allowing the
  lease layer to reclaim the failed member's LORs (primary component).

Every delivery event is stamped with :class:`core.events.EvMeta` so the
schedule explorer can reorder *concurrent* deliveries while the policy seam
enforces exactly the guarantees above (TO chains per node, opt-before-TO
pairing, per-sender FIFO chains).  ``msg_keys`` derives the conflict classes
a protocol message touches — the explorer's commutation oracle.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, List, Optional

from .events import EventQueue, EvMeta


@dataclass(frozen=True)
class GCSLatency:
    step_ms: float = 0.5
    p2p_steps: float = 1.0
    urb_steps: float = 2.0
    oab_opt_steps: float = 1.0
    oab_to_steps: float = 3.0
    # Total-order broadcast is serialized through a sequencer (or token
    # ring): the final TO-delivery stream has a maximum rate of
    # 1/oab_serialize_ms messages per ms.  Optimistic deliveries are raw
    # network multicasts and do not pass through the sequencer.  This is the
    # resource whose contention the paper's protocols are designed to avoid
    # ("limiting the use of atomic broadcast exclusively for establishing
    # lease ownership").
    oab_serialize_ms: float = 0.0


def msg_keys(msg: Any) -> Optional[FrozenSet[int]]:
    """Conflict classes a protocol message touches (None: opaque).

    Used as the explorer's independence oracle: two deliveries whose key
    sets are disjoint commute.  Anything unrecognized is opaque — treated
    as dependent with everything, which only costs pruning, never soundness.
    """
    try:
        kind, payload = msg
    except (TypeError, ValueError):
        return None
    if kind == "lease":
        return frozenset(payload.ccs)
    if kind == "freed":
        return frozenset(cc for (_rid, _proc, ccs) in payload for cc in ccs)
    if kind == "commit":
        return frozenset(payload["ccs"])
    if kind == "forward":
        return frozenset(payload.ccs)
    return None


class SimGCS:
    """Event-driven GCS over an :class:`EventQueue`."""

    def __init__(self, events: EventQueue, n_nodes: int, lat: GCSLatency) -> None:
        self.events = events
        self.lat = lat
        self.members: List[int] = list(range(n_nodes))
        self._alive = [True] * n_nodes
        self._seq = itertools.count()
        # handlers[node] -> dict of callbacks
        self.on_opt: Dict[int, Callable[[Any, int], None]] = {}
        self.on_to: Dict[int, Callable[[Any, int], None]] = {}
        self.on_urb: Dict[int, Callable[[Any, int], None]] = {}
        self.on_p2p: Dict[int, Callable[[Any, int], None]] = {}
        self.on_view_change: Dict[int, Callable[[List[int], int], None]] = {}
        # traffic accounting (for benchmark reporting)
        self.n_oab = 0
        self.n_urb = 0
        self.n_p2p = 0
        self._seq_busy_until = 0.0
        # dense per-chain delivery counters for the explorer's FIFO metadata
        self._chain_seq: Dict[tuple, int] = {}
        self._msgid = itertools.count()

    def _chain_next(self, chain: tuple) -> int:
        c = self._chain_seq.get(chain, 0)
        self._chain_seq[chain] = c + 1
        return c

    # -- primitives ---------------------------------------------------------
    def oa_broadcast(self, sender: int, msg: Any) -> None:
        """OAB: Opt-deliver after 1 step, TO-deliver after >= 3 steps.

        TO-delivery additionally queues behind the sequencer: each message
        occupies the sequencer for ``oab_serialize_ms`` and messages are
        sequenced strictly one after another, which caps sustainable OAB
        throughput and models sequencer saturation under lease-request storms.
        """
        self.n_oab += 1
        lat = self.lat
        mid = next(self._msgid)
        keys = msg_keys(msg)
        opt_at = set()
        for node in self.members:
            if not self._alive[node]:
                continue
            if self._sched(lat.oab_opt_steps, node, self.on_opt, msg, sender,
                           meta=EvMeta(kind="opt", node=node, msgid=mid,
                                       keys=keys, label=f"opt@{node} m{mid}")):
                opt_at.add(node)
        # total order: constant latency + deterministic scheduling order makes
        # TO-deliver order identical across nodes (EventQueue seq tie-break).
        to_extra = 0.0
        if lat.oab_serialize_ms > 0:
            start = max(self.events.now, self._seq_busy_until)
            self._seq_busy_until = start + lat.oab_serialize_ms
            to_extra = self._seq_busy_until - self.events.now
        for node in self.members:
            # chain counters stay dense: only allocate a slot for deliveries
            # that are actually scheduled (handler registered)
            if not self._alive[node] or self.on_to.get(node) is None:
                continue
            self._sched(lat.oab_to_steps, node, self.on_to, msg, sender,
                        extra_ms=to_extra,
                        meta=EvMeta(kind="to", node=node,
                                    chain=("to", node),
                                    cseq=self._chain_next(("to", node)),
                                    msgid=mid, after_opt=node in opt_at,
                                    keys=keys, label=f"to@{node} m{mid}"))

    def ur_broadcast(self, sender: int, msg: Any) -> None:
        self.n_urb += 1
        keys = msg_keys(msg)
        for node in self.members:
            if not self._alive[node] or self.on_urb.get(node) is None:
                continue
            chain = ("urb", sender, node)
            self._sched(self.lat.urb_steps, node, self.on_urb, msg, sender,
                        meta=EvMeta(kind="urb", node=node, chain=chain,
                                    cseq=self._chain_next(chain), keys=keys,
                                    label=f"urb@{node} from {sender}"))

    def p2p_send(self, sender: int, dest: int, msg: Any) -> None:
        self.n_p2p += 1
        if self._alive[dest] and self.on_p2p.get(dest) is not None:
            chain = ("p2p", sender, dest)
            self._sched(self.lat.p2p_steps, dest, self.on_p2p, msg, sender,
                        meta=EvMeta(kind="p2p", node=dest, chain=chain,
                                    cseq=self._chain_next(chain),
                                    keys=msg_keys(msg),
                                    label=f"p2p@{dest} from {sender}"))

    # -- membership ----------------------------------------------------------
    def fail(self, node: int) -> None:
        """Crash a member; survivors get a synchronized view change."""
        if not self._alive[node]:
            return
        self._alive[node] = False
        new_view = [m for m in self.members if self._alive[m]]
        for m in new_view:
            cb = self.on_view_change.get(m)
            if cb is not None:
                chain = ("view", m)
                self.events.schedule(
                    self.lat.urb_steps * self.lat.step_ms,
                    (lambda c=cb, v=list(new_view), f=node: c(v, f)),
                    meta=EvMeta(kind="view", node=m, chain=chain,
                                cseq=self._chain_next(chain),
                                label=f"view@{m} -{node}"),
                )
        self.members = new_view

    def alive(self, node: int) -> bool:
        return self._alive[node]

    # -- internals -------------------------------------------------------------
    def _sched(self, steps: float, node: int, table, msg: Any, sender: int,
               extra_ms: float = 0.0, meta: Optional[EvMeta] = None) -> bool:
        cb = table.get(node)
        if cb is None:
            return False
        # liveness is re-checked at delivery time: a message in flight to a
        # node that crashes mid-flight is dropped, never processed by the
        # dead member (fail-stop) — senders recover via the view change
        self.events.schedule(
            steps * self.lat.step_ms + extra_ms,
            (lambda c=cb, m=msg, s=sender, n=node:
             c(m, s) if self._alive[n] else None),
            meta=meta,
        )
        return True
