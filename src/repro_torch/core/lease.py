"""Lease managers: coarse-grained ALC and fine-grained FGL (Algorithm 1).

Every replica runs its own lease-manager instance holding a *replica* of the
conflict-queue state ``CQ``: an array of FIFO queues, one per conflict class,
containing Lease Ownership Records (LORs).  Queue contents evolve
deterministically from the total order of lease requests (TO-deliver) and the
uniform-reliable stream of ``LeaseFreed`` messages (UR-deliver), so all
replicas converge to the same queues.

Key protocol facts preserved from the paper (and exploited by its correctness
argument — see tests/test_lease_fgl.py):

* piggybacking (line 4) only considers LORs **already enqueued locally**
  (i.e. whose request was TO-delivered here) that are owned by this process
  and not ``blocked``;
* ``Opt-deliver`` of a remote conflicting request *blocks* local LORs before
  that request's TO-deliver can possibly occur (optimistic delivery precedes
  final delivery at every node), which is what makes piggybacking
  deadlock-free;
* a LOR is freed (single ``UR-broadcast`` batching all drained LORs) when it
  is blocked and its ``activeXacts`` counter drains to zero, or immediately at
  blocking time when it is at the head of its queue with no active
  transactions.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Records
# --------------------------------------------------------------------------

@dataclass
class LeaseRequest:
    """A lease request disseminated via OAB."""

    req_id: int                  # globally unique (issued per origin, see Cluster)
    proc: int                    # requesting replica
    ccs: Tuple[int, ...]         # conflict classes requested (sorted)
    coarse: bool = False         # True => single multi-cc LOR (ALC semantics)
    # planner-issued background prefetch (repro.plan): no transaction is
    # attached, so the requester drains the LORs' activeXacts immediately at
    # TO-deliver and they sit unblocked in the queues, piggybackable by
    # future local transactions.  Protocol-wise this is an ordinary lease
    # request — safety and queue replication are untouched.
    prefetch: bool = False


@dataclass
class LOR:
    """Lease Ownership Record — one replica's copy.

    ``activeXacts``/``blocked`` are only meaningful on the owning replica
    (``proc``); other replicas track queue membership for ordering/ownership
    decisions.
    """

    req_id: int
    proc: int
    ccs: Tuple[int, ...]         # FGL: single cc; ALC: the full request set
    activeXacts: int = 1
    blocked: bool = False

    @property
    def cc(self) -> int:
        assert len(self.ccs) == 1
        return self.ccs[0]

    def key(self) -> Tuple[int, int, Tuple[int, ...]]:
        return (self.req_id, self.proc, self.ccs)


# --------------------------------------------------------------------------
# Base: replicated conflict-queue state
# --------------------------------------------------------------------------

class LeaseManagerBase:
    """Shared conflict-queue machinery for both lease managers."""

    def __init__(self, proc: int, n_classes: int) -> None:
        self.proc = proc
        self.n_classes = n_classes
        # CQ: FIFO per conflict class, replicated via total order.
        self.cq: List[List[LOR]] = [[] for _ in range(n_classes)]
        # LORs indexed by (req_id) for this replica's copy.
        self._by_req: Dict[int, List[LOR]] = {}
        # Opt-delivered requests whose TO-deliver is still pending.  Needed to
        # close an opt/TO race the paper's prose glosses over: Algorithm 1
        # blocks local LORs at Opt-deliver time, but a LOR of an *earlier*
        # (in total order) request may be enqueued only at its later
        # TO-deliver — after the conflicting request's Opt-deliver already
        # ran — and would then never be blocked nor freed once drained,
        # deadlocking the later request behind a dormant LOR.  Any request
        # that is opt-delivered but not yet TO-delivered is necessarily
        # TO-ordered *after* every request already TO-delivered, so LORs
        # enqueued while a conflicting request is pending are born blocked.
        self._pending_opt: Dict[int, LeaseRequest] = {}
        # members removed by a view change: view synchrony demands that any
        # of their messages still in flight are discarded on delivery, else
        # their LORs would head queues forever (nobody left to free them).
        self._dead: set = set()
        # metrics
        self.n_piggyback = 0
        self.n_requests = 0

    # -- queue helpers ------------------------------------------------------
    def _is_first(self, lor: LOR, cc: int) -> bool:
        q = self.cq[cc]
        return bool(q) and q[0] is lor

    def head_owner(self, cc: int) -> int:
        """Current lease owner of ``cc`` per this replica's view (-1: none)."""
        q = self.cq[cc]
        return q[0].proc if q else -1

    def owner_view(self) -> List[int]:
        """L(i, x) ownership vector over all conflict classes."""
        return [self.head_owner(cc) for cc in range(self.n_classes)]

    def owns_all(self, ccs: Iterable[int]) -> bool:
        """True iff this replica's LORs head every queue in ``ccs``."""
        return all(self.head_owner(cc) == self.proc for cc in ccs)

    def owner_np(self) -> np.ndarray:
        """Ownership vector as an int32 array (-1: unowned) — the shape the
        certification kernel's write-lock derivation consumes (ids are
        int32 end to end; see the id-dtype lint rule)."""
        return np.fromiter(
            (self.head_owner(cc) for cc in range(self.n_classes)),
            np.int32, count=self.n_classes)

    def has_unblocked(self, cc: int, proc: int) -> bool:
        """True iff ``proc`` has an unblocked LOR anywhere in ``cc``'s queue
        (it holds the lease or is already queued to get it)."""
        return any(l.proc == proc and not l.blocked for l in self.cq[cc])

    def enabled_mask(self, groups: Sequence[Sequence[LOR]]) -> List[bool]:
        """``isEnabled`` over many waiting groups.  The sequential oracle
        just loops; the sharded manager overrides this with one vectorized
        settle per instant."""
        return [self.is_enabled(g) for g in groups]

    def protocol_state(self) -> Tuple:
        """Canonical protocol-state snapshot for the schedule explorer.

        Covers exactly the replicated state the fingerprint dedup keys on:
        per-class queue contents in order (req, proc, activeXacts, blocked),
        the opt-delivered-but-pending request ids, and the dead set.  Both
        managers emit the same shape, so a sequential and a sharded replica
        in the same protocol state fingerprint identically.
        """
        queues = tuple(
            (cc, tuple((l.req_id, l.proc, l.activeXacts, bool(l.blocked))
                       for l in self.cq[cc]))
            for cc in range(self.n_classes) if self.cq[cc])
        return (queues, tuple(sorted(self._pending_opt)),
                tuple(sorted(self._dead)))

    # -- protocol events (identical in both variants) -----------------------
    def on_to_deliver(self, req: LeaseRequest) -> List[LOR]:
        """TO-deliver of a lease request: enqueue its LORs (Alg. 1 l.21-23).

        Applies the total-order blocking catch-up (see ``_pending_opt``): a
        newly enqueued local LOR conflicting with any still-pending
        opt-delivered request is born blocked, so it is freed as soon as its
        transactions drain rather than lingering dormant.
        """
        self._pending_opt.pop(req.req_id, None)
        if req.proc in self._dead:
            return []
        lors = self._create_lors(req)
        self._by_req[req.req_id] = lors
        for lor in lors:
            for cc in lor.ccs:
                self.cq[cc].append(lor)
        if req.proc == self.proc and self._pending_opt:
            pending_ccs = set()
            for p in self._pending_opt.values():
                pending_ccs.update(p.ccs)
            for lor in lors:
                if any(cc in pending_ccs for cc in lor.ccs):
                    lor.blocked = True
        return lors

    def on_ur_deliver_freed(self, freed_keys: Sequence[Tuple[int, int, Tuple[int, ...]]]) -> None:
        """UR-deliver of LeaseFreed: dequeue each named LOR (Alg. 1 l.24-25)."""
        for (req_id, proc, ccs) in freed_keys:
            lors = self._by_req.get(req_id, [])
            for lor in lors:
                if lor.ccs == ccs and lor.proc == proc:
                    for cc in lor.ccs:
                        try:
                            self.cq[cc].remove(lor)
                        except ValueError:
                            pass
            # drop only the named (ccs, proc) record, matching the dequeue above
            self._by_req[req_id] = [
                l for l in lors if not (l.ccs == ccs and l.proc == proc)
            ]
            if not self._by_req[req_id]:
                del self._by_req[req_id]

    def on_opt_deliver(self, req: LeaseRequest) -> List[LOR]:
        """Opt-deliver of a lease request: freeLocalLeases (Alg. 1 l.26-33).

        Note Algorithm 1 line 36 has **no p_k ≠ p_i guard**: a node's own
        request also blocks its earlier LORs on the requested classes.  This
        matters — without it, a fresh request would queue behind the node's
        own dormant (activeXacts = 0, unblocked) LOR, which nothing would
        ever free: self-deadlock.  The newly requested LORs themselves are
        untouched because they are only enqueued at TO-deliver, which follows
        this optimistic delivery.

        Returns the list of local LORs that must be freed now (the caller
        UR-broadcasts a single LeaseFreed for them).
        """
        if req.proc in self._dead:
            return []
        self._pending_opt[req.req_id] = req
        to_free: List[LOR] = []
        for cc in req.ccs:
            for lor in self.cq[cc]:
                if lor.proc == self.proc and not lor.blocked:
                    lor.blocked = True
                    if (
                        all(self._is_first(lor, c) for c in lor.ccs)
                        and lor.activeXacts == 0
                    ):
                        to_free.append(lor)
        return _dedup(to_free)

    def finished_xact(self, lors: Sequence[LOR]) -> List[LOR]:
        """FinishedXact (Alg. 1 l.14-18): decrement; return LORs to free."""
        to_free: List[LOR] = []
        for lor in lors:
            lor.activeXacts -= 1
            assert lor.activeXacts >= 0, "activeXacts underflow"
            if lor.blocked and lor.activeXacts == 0:
                to_free.append(lor)
        return _dedup(to_free)

    def is_enabled(self, lors: Sequence[LOR]) -> bool:
        """isEnabled (Alg. 1 l.34-35): every LOR heads all its queues."""
        return all(
            self._is_first(lor, cc) for lor in lors for cc in lor.ccs
        )

    def purge_proc(self, proc: int) -> None:
        """View change: reclaim every LOR owned by a failed member.

        View synchrony guarantees all surviving replicas apply this at the
        same point of the delivery stream, so queues stay consistent.
        """
        self._dead.add(proc)
        for req_id in list(self._pending_opt):
            if self._pending_opt[req_id].proc == proc:
                del self._pending_opt[req_id]
        for cc in range(self.n_classes):
            self.cq[cc] = [l for l in self.cq[cc] if l.proc != proc]
        # all LORs of one request belong to its issuing proc, so removal is
        # whole-request: a "keep the other procs' LORs" branch here could
        # only ever retain records whose queue entries were just purged
        # (dangling LORs) — assert the invariant instead of masking it
        for req_id in list(self._by_req):
            owners = {l.proc for l in self._by_req[req_id]}
            assert len(owners) == 1, \
                "invariant violated: LORs of one request span procs"
            if proc in owners:
                del self._by_req[req_id]

    # -- to override ---------------------------------------------------------
    def _create_lors(self, req: LeaseRequest) -> List[LOR]:
        raise NotImplementedError

    def try_piggyback(self, ccs: FrozenSet[int]) -> Optional[List[LOR]]:
        raise NotImplementedError


def _dedup(lors: List[LOR]) -> List[LOR]:
    out: List[LOR] = []
    seen = set()
    for lor in lors:
        k = id(lor)
        if k not in seen:
            seen.add(k)
            out.append(lor)
    return out


# --------------------------------------------------------------------------
# FGL — fine-grained leases (the paper's new lease manager, Algorithm 1)
# --------------------------------------------------------------------------

class FGLLeaseManager(LeaseManagerBase):
    """One LOR per accessed conflict class; piggyback per class."""

    def _create_lors(self, req: LeaseRequest) -> List[LOR]:
        return [LOR(req.req_id, req.proc, (cc,)) for cc in req.ccs]

    def try_piggyback(self, ccs: FrozenSet[int]) -> Optional[List[LOR]]:
        """Alg. 1 line 4: cover ``ccs`` with own unblocked enqueued LORs."""
        S: List[LOR] = []
        for cc in sorted(ccs):
            found = None
            for lor in self.cq[cc]:
                if lor.proc == self.proc and not lor.blocked:
                    found = lor
                    break
            if found is None:
                return None
            S.append(found)
        for lor in _dedup(S):
            lor.activeXacts += 1
        self.n_piggyback += 1
        return S

    def missing_ccs(self, ccs: FrozenSet[int]) -> FrozenSet[int]:
        """Conflict classes not coverable by piggybacking (for the DTD)."""
        out = []
        for cc in ccs:
            if not any(
                l.proc == self.proc and not l.blocked for l in self.cq[cc]
            ):
                out.append(cc)
        return frozenset(out)


# --------------------------------------------------------------------------
# ALC — coarse-grained baseline (one lease record per transaction data-set)
# --------------------------------------------------------------------------

class ALCLeaseManager(LeaseManagerBase):
    """One multi-class LOR per request; reuse only on data-set inclusion."""

    def _create_lors(self, req: LeaseRequest) -> List[LOR]:
        return [LOR(req.req_id, req.proc, tuple(sorted(req.ccs)))]

    def try_piggyback(self, ccs: FrozenSet[int]) -> Optional[List[LOR]]:
        """Reuse iff the txn's data-set ⊆ a single owned, unblocked lease."""
        if not ccs:
            return None
        candidates = self.cq[min(ccs)]
        for lor in candidates:
            if (
                lor.proc == self.proc
                and not lor.blocked
                and ccs.issubset(lor.ccs)
            ):
                lor.activeXacts += 1
                self.n_piggyback += 1
                return [lor]
        return None

    def missing_ccs(self, ccs: FrozenSet[int]) -> FrozenSet[int]:
        return frozenset() if self.try_peek(ccs) else frozenset(ccs)

    def try_peek(self, ccs: FrozenSet[int]) -> bool:
        if not ccs:
            return False
        for lor in self.cq[min(ccs)]:
            if lor.proc == self.proc and not lor.blocked and ccs.issubset(lor.ccs):
                return True
        return False
