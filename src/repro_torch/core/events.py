"""Deterministic discrete-event engine used by the cluster simulator.

Events are ordered by (time, seq) where ``seq`` is a monotonically increasing
issue counter — two events scheduled for the same instant fire in the order
they were scheduled, which makes every simulation run bit-reproducible for a
given seed.

Schedule exploration (repro.analysis.explore) plugs in through
:class:`SchedulePolicy`: an optional seam that controls dispatch order among
*enabled* events — the group scheduled for the same instant, plus message
deliveries falling inside a bounded commutation window after it.  The policy
only ever reorders candidates the delivery-order metadata (:class:`EvMeta`)
marks as legal: total-order, opt-before-TO, and per-sender FIFO constraints
are enforced here so every explored schedule is one the real GCS could have
produced.  With no policy installed (the default), the engine runs the exact
(time, seq) heap order it always has.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Set, Tuple

from ..obs import trace as obs_trace


@dataclass(frozen=True)
class EvMeta:
    """Delivery-order metadata stamped on schedulable events.

    ``chain``/``cseq`` encode a FIFO constraint: events sharing a chain are
    only dispatchable in ``cseq`` order (TO per node, URB per (sender, node),
    p2p per (sender, node)).  ``after_opt`` marks a final TO-delivery that
    must follow its own optimistic delivery (paired via ``msgid``/``node``).
    ``keys`` are the conflict classes the event touches — the explorer's
    independence oracle (disjoint keys commute); ``None`` means opaque,
    dependent with everything.
    """

    kind: str = "local"            # opt | to | urb | p2p | view | local
    node: int = -1                 # delivering / executing node
    chain: Optional[Tuple] = None  # FIFO chain id (hashable)
    cseq: int = -1                 # dense position within the chain
    msgid: int = -1                # OAB message id pairing opt with TO
    after_opt: bool = False        # TO-delivery gated on its opt-delivery
    keys: Optional[FrozenSet[int]] = None
    label: str = ""


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable[[], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)
    meta: Optional[EvMeta] = field(default=None, compare=False)


class SchedulePolicy:
    """Dispatch-order seam over enabled same-instant events.

    The queue hands ``select`` the candidate pool — every live event at the
    earliest pending instant, plus delivery events (``meta.kind != "local"``)
    within ``window`` ms after it — sorted by (time, seq).  ``select``
    returns the index of the event to dispatch; candidates that would break
    a delivery-order constraint must not be chosen (``eligible`` encodes
    them).  ``on_dispatch`` is invoked for *every* dispatched event
    (including the no-choice singletons) so the FIFO-chain bookkeeping stays
    in lockstep with the run.

    The base class is the identity policy: window 0, first eligible
    candidate — byte-identical to running with no policy at all.
    """

    window: float = 0.0

    def __init__(self) -> None:
        self._chain_done: Dict[Tuple, int] = {}
        self._opts_done: Set[Tuple[int, int]] = set()

    # -- delivery-order constraints -----------------------------------------
    def eligible(self, ev: _Event) -> bool:
        m = ev.meta
        if m is None:
            return True
        if m.after_opt and (m.node, m.msgid) not in self._opts_done:
            return False
        if m.chain is not None and self._chain_done.get(m.chain, 0) != m.cseq:
            return False
        return True

    # -- hooks ---------------------------------------------------------------
    def select(self, candidates: List[_Event]) -> int:
        """Pick the next event among >= 2 candidates (sorted by time, seq)."""
        for i, ev in enumerate(candidates):
            if self.eligible(ev):
                return i
        return 0  # unreachable for well-formed metadata; fail open

    def on_dispatch(self, ev: _Event) -> None:
        m = ev.meta
        if m is None:
            return
        if m.kind == "opt":
            self._opts_done.add((m.node, m.msgid))
        if m.chain is not None:
            self._chain_done[m.chain] = m.cseq + 1


class EventQueue:
    """A deterministic priority queue of timed callbacks."""

    def __init__(self, policy: Optional[SchedulePolicy] = None) -> None:
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self.now: float = 0.0
        self.n_dispatched: int = 0
        self.policy = policy
        # queue-level dispatch tracing rides the module-level recorder,
        # captured once at construction: `repro-explore replay --trace`
        # installs it before building the scenario, so counterexample
        # replays get per-delivery timelines while ordinary runs keep a
        # None here (one dead branch per dispatch, nothing else)
        self.trace = obs_trace.TRACE if obs_trace.TRACE.enabled else None

    def schedule(self, delay: float, fn: Callable[[], None],
                 meta: Optional[EvMeta] = None) -> _Event:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        ev = _Event(self.now + delay, next(self._seq), fn, meta=meta)
        heapq.heappush(self._heap, ev)
        return ev

    def at(self, time: float, fn: Callable[[], None]) -> _Event:
        return self.schedule(max(0.0, time - self.now), fn)

    def cancel(self, ev: _Event) -> None:
        ev.cancelled = True

    def run(self, until: float, max_events: Optional[int] = None) -> None:
        """Dispatch events in order until simulated ``until`` time."""
        n = 0
        policy = self.policy
        while self._heap and self._heap[0].time <= until:
            if policy is None:
                ev = heapq.heappop(self._heap)
                if ev.cancelled:
                    continue
                self.now = ev.time
            else:
                ev = self._pick(policy)
                if ev is None:
                    continue
                policy.on_dispatch(ev)
            tr = self.trace
            if tr is not None and ev.meta is not None:
                m = ev.meta
                tr.instant("dispatch", f"node{m.node}/gcs" if m.node >= 0
                           else "events", ts=ev.time, kind=m.kind,
                           label=m.label)
            ev.fn()
            self.n_dispatched += 1
            n += 1
            if max_events is not None and n >= max_events:
                break
        self.now = max(self.now, until)

    def _pick(self, policy: SchedulePolicy) -> Optional[_Event]:
        """Pop the policy-chosen event from the enabled candidate pool.

        The pool is every live event at the earliest pending instant plus
        delivery events within the commutation window after it.  The chosen
        event dispatches at the *base* instant (``now`` stays monotone:
        candidates never precede it), everything else is pushed back.
        """
        heap = self._heap
        base = heap[0].time
        limit = base + policy.window
        pool: List[_Event] = []
        deferred: List[_Event] = []
        while heap and heap[0].time <= limit:
            ev = heapq.heappop(heap)
            if ev.cancelled:
                continue
            in_window = ev.time <= base or (
                ev.meta is not None and ev.meta.kind != "local")
            (pool if in_window else deferred).append(ev)
        for ev in deferred:
            heapq.heappush(heap, ev)
        if not pool:
            return None
        if len(pool) == 1:
            chosen = pool[0]
        else:
            pool.sort()
            idx = policy.select(pool)
            chosen = pool.pop(idx)
            for ev in pool:
                heapq.heappush(heap, ev)
        self.now = max(self.now, base)
        return chosen

    def pending(self) -> List[_Event]:
        """Live events still queued, in (time, seq) order (for fingerprints)."""
        return sorted(e for e in self._heap if not e.cancelled)

    def empty(self) -> bool:
        return not any(not e.cancelled for e in self._heap)
