"""Affinity statistics feeding the placement planner.

Two decayed matrices built on the repo's single decayed-counter
implementation (:class:`repro_torch.core.stats.DecayedFrequency`, one clock
source — the simulator's event clock or the engine-ticked router clock):

* ``node``  — A[j, x]: access rate of node/pod ``j`` on conflict class /
  session ``x``.  Fed by commit deliveries and request touches; forwards
  count extra (they are the cost signal a move removes), aborts are
  recorded separately and damp the executing node's affinity (a class
  aborting at a node is contended there, not attracted).
* ``co``    — Co[x, y]: co-access rate of classes ``x`` and ``y`` within
  one transaction footprint.  Moving a class toward nodes that own its
  co-accessed classes saves multi-class lease round-trips, so the scorer
  credits co-location (:func:`repro_torch.plan.score.score_moves`).

The tracker never decides anything — it is the measurement half of the
affinity → score → plan → prefetch loop.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from ..core.stats import DecayedFrequency


class AffinityTracker:
    def __init__(self, n_nodes: int, n_classes: int, *,
                 tau_ms: float = 500.0, forward_weight: float = 2.0,
                 abort_weight: float = 1.0, track_co: bool = False,
                 grow: bool = False) -> None:
        self.n_nodes = n_nodes
        self.forward_weight = forward_weight
        self.abort_weight = abort_weight
        self.node = DecayedFrequency(n_nodes, n_classes, tau_ms=tau_ms,
                                     grow_cols=grow)
        self.aborts = DecayedFrequency(n_nodes, n_classes, tau_ms=tau_ms,
                                       grow_cols=grow)
        # co-access is [n_classes, n_classes]: rows grow with the same
        # pow2 policy, columns via the shared grow_cols machinery
        self.co: Optional[DecayedFrequency] = (
            DecayedFrequency(n_classes, n_classes, tau_ms=tau_ms,
                             grow_cols=grow) if track_co else None)

    # -- event ingestion -----------------------------------------------------
    def record_commit(self, t: float, origin: int, ccs: Iterable[int]) -> None:
        """A transaction/request from ``origin`` committed touching ``ccs``."""
        ccs = tuple(ccs)
        self.node.record(t, origin, ccs)
        self._record_co(t, ccs)

    # serving touches are the same signal with request granularity
    record_touch = record_commit

    def record_forward(self, t: float, origin: int, ccs: Iterable[int]) -> None:
        """``origin`` had to ship work away for ``ccs`` — the planner's
        target signal, weighted above plain accesses."""
        self.node.record(t, origin, tuple(ccs), weight=self.forward_weight)

    def record_abort(self, t: float, node: int, ccs: Iterable[int]) -> None:
        """A certification abort at ``node``: contention, not attraction."""
        self.aborts.record(t, node, tuple(ccs))

    def _record_co(self, t: float, ccs) -> None:
        if self.co is None or len(ccs) < 2:
            return
        for x in ccs:
            self.co.record(t, x, (y for y in ccs if y != x))

    # -- planner inputs ------------------------------------------------------
    def rates(self, t: float, n_classes: Optional[int] = None) -> np.ndarray:
        """Effective affinity [n_classes, n_nodes]: access minus damped
        abort rates, clipped at zero (an abort can cancel an access, not
        turn a node repulsive below "never goes there").

        float32: this is the scorer's input boundary, and the jit computes
        in float32 regardless — handing it float64 would just put a [C, N]
        host-side conversion on the plan epoch's kick path."""
        a = self.node.rates(t).T
        b = self.aborts.rates(t).T
        out = np.maximum(a - self.abort_weight * b, 0.0).astype(np.float32)
        if n_classes is not None and out.shape[0] < n_classes:
            grown = np.zeros((n_classes, out.shape[1]), dtype=out.dtype)
            grown[: out.shape[0]] = out
            out = grown
        return out if n_classes is None else out[:n_classes]

    def co_rates(self, t: float, n_classes: int) -> Optional[np.ndarray]:
        """Co[x, y] co-access rates, [n_classes, n_classes] (or None)."""
        if self.co is None:
            return None
        c = self.co.rates(t)
        rows = min(c.shape[0], n_classes)
        cols = min(c.shape[1], n_classes)
        out = np.zeros((n_classes, n_classes), dtype=c.dtype)
        out[:rows, :cols] = c[:rows, :cols]
        return out

    def forget(self, cc: int) -> None:
        """Drop a class's statistics (e.g. an evicted session)."""
        self.node.zero_col(cc)
        self.aborts.zero_col(cc)
        if self.co is not None:
            self.co.zero_col(cc)
            if cc < self.co.counts.shape[0]:
                self.co.counts[cc, :] = 0.0

    def purge_node(self, node: int) -> None:
        """Drop a failed node's rows: a dead member must stop attracting
        (or repelling) planned moves.  Co-access is class-to-class and
        keeps no node axis."""
        self.node.counts[node, :] = 0.0
        self.aborts.counts[node, :] = 0.0

    def compact(self, n_classes: int) -> None:
        """Shrink the grown column spaces down to ``n_classes`` live
        classes (see :meth:`DecayedFrequency.shrink_to` for the pow2 +
        hysteresis policy)."""
        self.node.shrink_to(n_classes)
        self.aborts.shrink_to(n_classes)
        if self.co is not None:
            self.co.shrink_to(n_classes)
