"""Runtime lease-protocol sanitizer: Algorithm 1's invariants, checked live.

:class:`LeaseSanitizer` is an invariant-checking proxy around either lease
manager (the sequential oracle *or* the sharded array-backed manager —
instrumenting both is what localizes a divergence to the first violated
invariant instead of a trailing byte-diff).  It is a pure observer: every
protocol call forwards to the wrapped manager unchanged and returns its
result as-is, reading only post-state — so a sanitize-on run is
byte-identical to sanitize-off.

Checked per delivery instant (paper references in README "repro.analysis"):

* **single-owner / no double grant** — at most one live LOR per
  (req_id, proc, ccs); queue heads are owners by construction.
* **blocked-and-drained before free** — every freed LOR is blocked with
  ``activeXacts == 0``; opt-deliver frees additionally head all their
  queues (Alg. 1 l.26-33).
* **LOR conservation** — LORs are created at TO-deliver and retired by
  exactly one of UR-free / view-change purge; ``purge_proc`` removes the
  failed member's LORs and nobody else's.
* **prefetch-head** — a planner-prefetch LOR drains to ``activeXacts=0``
  only while heading its queue (else it wedges the class: the planner-prefetch bug).
* **enabled-divergence** — the sharded manager's vectorized
  ``enabled_mask`` is cross-checked against the sequential ``isEnabled``.
  In the port that verdict comes from ``ops.settle_lease_batch`` on the
  manager's device (the card, at ``jax_min`` or more groups).

:func:`check_write_locks` covers the certification side (single-writer
write-locks in ``validate_batch`` inputs, and the drain's verdicts), and
:class:`SanitizerError` is also raised by
:class:`repro_torch.serve.certifier.StepCertifier` in sanitize mode for
lease-epoch monotonicity / owner-at-drain violations.

This module is the reference's :mod:`repro.analysis.sanitizer`;
:func:`check_write_locks` also takes the port's drain input,
:class:`repro_torch.core.stm.ClassLocks`.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from ..core.stm import ClassLocks

Key = Tuple[int, int, Tuple[int, ...]]


class SanitizerError(AssertionError):
    """First violated protocol invariant, with localizing context."""

    def __init__(self, invariant: str, detail: str) -> None:
        self.invariant = invariant
        self.detail = detail
        super().__init__(f"[{invariant}] {detail}")


class LeaseSanitizer:
    """Invariant-checking proxy around a lease manager (oracle or sharded).

    Unknown attributes (owner queries, metrics, shard internals) forward to
    the wrapped manager, so the proxy is a drop-in at every call site.
    """

    _OWN = frozenset({
        "inner", "_live", "_prefetch", "_purged",
        "n_created", "n_freed", "n_purged", "n_events", "n_checks"})

    def __init__(self, inner) -> None:
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "_live", set())      # keys currently queued
        object.__setattr__(self, "_prefetch", set())  # keys awaiting drain
        object.__setattr__(self, "_purged", set())    # keys view-changes took
        object.__setattr__(self, "n_created", 0)
        object.__setattr__(self, "n_freed", 0)
        object.__setattr__(self, "n_purged", 0)
        object.__setattr__(self, "n_events", 0)
        object.__setattr__(self, "n_checks", 0)

    # -- proxy plumbing ------------------------------------------------------
    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value) -> None:
        if name in LeaseSanitizer._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)

    def _fail(self, invariant: str, detail: str) -> None:
        raise SanitizerError(invariant, f"proc {self.inner.proc}: {detail}")

    def _in_queue(self, key: Key) -> bool:
        req_id, proc, ccs = key
        return all(
            any(l.req_id == req_id and l.proc == proc
                for l in self.inner.cq[cc])
            for cc in ccs)

    # -- TO-deliver: grants --------------------------------------------------
    def on_to_deliver(self, req):
        out = self.inner.on_to_deliver(req)
        self._granted([out])
        return out

    def to_deliver_batch(self, reqs):
        out = self.inner.to_deliver_batch(reqs)
        self._granted(out)
        return out

    def _granted(self, groups) -> None:
        for lors in groups:
            for l in lors:
                k = l.key()
                self.n_events += 1
                if k in self._live:
                    self._fail("single-owner",
                               f"double grant: LOR {k} enqueued while an "
                               f"identical live LOR exists")
                self._live.add(k)
                self.n_created += 1
                if not self._in_queue(k):
                    self._fail("conservation",
                               f"granted LOR {k} is absent from its "
                               f"conflict-class queue(s)")

    # -- Opt-deliver: blocking frees ----------------------------------------
    def on_opt_deliver(self, req):
        frees = self.inner.on_opt_deliver(req)
        self._check_frees(frees, "opt-deliver", require_head=True)
        return frees

    def opt_deliver_batch(self, reqs):
        frees = self.inner.opt_deliver_batch(reqs)
        self._check_frees(frees, "opt-deliver", require_head=True)
        return frees

    def _check_frees(self, frees, source: str, require_head: bool) -> None:
        for l in frees:
            k = l.key()
            self.n_checks += 1
            if k not in self._live:
                self._fail("conservation", f"{source} freed unknown LOR {k}")
            if not l.blocked:
                self._fail("blocked-and-drained",
                           f"{source} freed unblocked LOR {k}")
            if l.activeXacts != 0:
                self._fail("blocked-and-drained",
                           f"{source} freed LOR {k} with "
                           f"activeXacts={l.activeXacts}")
            if require_head and not self.inner.is_enabled([l]):
                # Alg. 1 l.30: the immediate free at blocking time only
                # fires for a LOR heading its queue
                self._fail("blocked-and-drained",
                           f"{source} freed LOR {k} that does not head "
                           f"all its queues")

    # -- FinishedXact: drains ------------------------------------------------
    def finished_xact(self, lors):
        frees = self.inner.finished_xact(lors)
        self._after_finish(lors, frees)
        return frees

    def finish_batch(self, groups):
        frees = self.inner.finish_batch(groups)
        self._after_finish([l for g in groups for l in g], frees)
        return frees

    def _after_finish(self, touched, frees) -> None:
        self._check_frees(frees, "finished_xact", require_head=False)
        for l in touched:
            k = l.key()
            if k in self._prefetch and l.activeXacts == 0:
                # planner-prefetch bug class: a prefetch LOR drained while non-head is
                # freed out of order (if blocked) or wedges its class as an
                # unfreeable dormant record (if not)
                self.n_checks += 1
                if not self.inner.is_enabled([l]):
                    self._fail("prefetch-head",
                               f"prefetch LOR {k} drained to activeXacts=0 "
                               f"while not heading its queue")
                self._prefetch.discard(k)

    # -- UR-deliver: retirement ----------------------------------------------
    def on_ur_deliver_freed(self, freed_keys):
        self._before_ur(freed_keys)
        out = self.inner.on_ur_deliver_freed(freed_keys)
        self._after_ur(freed_keys)
        return out

    def freed_batch(self, key_batches):
        flat = [k for batch in key_batches for k in batch]
        self._before_ur(flat)
        out = self.inner.freed_batch(key_batches)
        self._after_ur(flat)
        return out

    def _before_ur(self, keys) -> None:
        own = self.inner.proc
        for key in keys:
            self.n_events += 1
            req_id, proc, ccs = key
            if key not in self._live:
                if proc in self.inner._dead or key in self._purged:
                    continue  # late free after a purge: a legal no-op
                self._fail("conservation",
                           f"LeaseFreed for LOR {key} that was never "
                           f"granted or was already freed")
            if proc != own:
                # blocked/activeXacts are owner-local state — only the
                # generating replica's copy is meaningful (lease.LOR doc)
                continue
            for cc in ccs:
                for l in self.inner.cq[cc]:
                    if l.req_id == req_id and l.proc == proc:
                        self.n_checks += 1
                        if not l.blocked or l.activeXacts != 0:
                            self._fail(
                                "blocked-and-drained",
                                f"own LOR {key} freed while blocked="
                                f"{l.blocked}, activeXacts={l.activeXacts}")

    def _after_ur(self, keys) -> None:
        for key in keys:
            if key in self._live:
                self._live.discard(key)
                self.n_freed += 1
                if self._in_queue(key):
                    self._fail("conservation",
                               f"LeaseFreed for {key} left a queue entry "
                               f"behind")

    # -- view change ---------------------------------------------------------
    def purge_proc(self, proc: int):
        doomed = {k for k in self._live if k[1] == proc}
        survivors = self._live - doomed
        out = self.inner.purge_proc(proc)
        for k in doomed:
            if self._in_queue(k):
                self._fail("conservation",
                           f"purge_proc({proc}) left LOR {k} of the failed "
                           f"member queued")
        for k in survivors:
            self.n_checks += 1
            if not self._in_queue(k):
                self._fail("conservation",
                           f"purge_proc({proc}) dropped LOR {k} of a "
                           f"surviving member")
        self._live = survivors
        self._purged |= doomed
        self._prefetch -= doomed
        self.n_purged += len(doomed)
        return out

    # -- enablement ----------------------------------------------------------
    def enabled_mask(self, groups):
        out = self.inner.enabled_mask(groups)
        if getattr(self.inner, "settle", None) is not None:
            # sharded manager: cross-check the vectorized verdicts against
            # the sequential isEnabled loop — the first divergent group
            # names the kernel bug instead of a downstream byte-diff
            for g, got in zip(groups, out):
                self.n_checks += 1
                if bool(got) != self.inner.is_enabled(g):
                    self._fail(
                        "enabled-divergence",
                        f"enabled_mask verdict {bool(got)} diverges from "
                        f"sequential isEnabled for group "
                        f"{[l.key() for l in g]}")
        return out

    # -- piggybacking ---------------------------------------------------------
    def try_piggyback(self, ccs: FrozenSet[int]):
        out = self.inner.try_piggyback(ccs)
        if out:
            for l in out:
                self.n_checks += 1
                k = l.key()
                if k not in self._live:
                    self._fail("conservation",
                               f"piggyback returned unknown LOR {k}")
                if l.proc != self.inner.proc:
                    self._fail("single-owner",
                               f"piggyback on a remote LOR {k}")
                if l.blocked:
                    self._fail("blocked-and-drained",
                               f"piggyback on blocked LOR {k}")
        return out

    # -- hooks / reconciliation ----------------------------------------------
    def mark_prefetch(self, lors) -> None:
        """Cluster hook: these LORs belong to a planner prefetch and must
        drain to activeXacts=0 only at the head (prefetch-head rule)."""
        for l in lors:
            self._prefetch.add(l.key())

    def verify_full(self) -> None:
        """Full reconciliation: queue contents == live ledger, and
        created == freed + purged + live.  O(classes) — end-of-run/tests."""
        inq = set()
        for cc in range(self.inner.n_classes):
            for l in self.inner.cq[cc]:
                inq.add(l.key())
        if inq != self._live:
            extra = sorted(inq - self._live)
            missing = sorted(self._live - inq)
            self._fail("conservation",
                       f"queue/ledger divergence: {len(extra)} unledgered, "
                       f"{len(missing)} missing; e.g. "
                       f"{(extra + missing)[:3]}")
        if self.n_created != self.n_freed + self.n_purged + len(self._live):
            self._fail("conservation",
                       f"created={self.n_created} != freed={self.n_freed} "
                       f"+ purged={self.n_purged} + live={len(self._live)}")

    def counters(self) -> Dict[str, int]:
        return {"events": self.n_events, "checks": self.n_checks,
                "created": self.n_created, "freed": self.n_freed,
                "purged": self.n_purged, "live": len(self._live)}


def check_write_locks(node: int, owners: np.ndarray,
                      item_cc: Optional[np.ndarray],
                      locks, txns: Sequence, verdicts: Sequence) -> int:
    """Single-writer check on one certification batch (simulator side).

    Recomputes per-item write locks from the lease layer's *current*
    ownership view — on the host, independently of the production
    derivation — and flags (a) a stale/forged lock input to
    ``validate_batch``, and (b) any passing transaction that writes an item
    leased elsewhere.  ``locks`` is the input the certification used: None,
    per-item 0/1 locks (the reference's form), or the drain's
    :class:`~repro_torch.core.stm.ClassLocks`, whose owners and node must
    equal the lease layer's view.  ``verdicts`` are taken as the drain
    returned them.  Returns the number of write slots checked.
    """
    if item_cc is None:
        return 0
    owners = np.asarray(owners)
    item_cc = np.asarray(item_cc)
    if isinstance(locks, ClassLocks):
        if locks.node != node:
            raise SanitizerError(
                "write-locks",
                f"stale write-lock input at node {node}: the class view was "
                f"built for node {locks.node}")
        held = np.asarray(locks.owners)
        if held.shape != owners.shape:
            raise SanitizerError(
                "write-locks",
                f"stale write-lock input at node {node}: the drain holds "
                f"{held.size} class owners, the lease layer {owners.size}")
        if not np.array_equal(held, owners):
            bad = np.flatnonzero(held != owners)
            raise SanitizerError(
                "write-locks",
                f"stale write-lock input at node {node}: {bad.size} "
                f"class owner(s) diverge from the lease ownership view, "
                f"e.g. class {int(bad[0])}")
    elif locks is not None:
        per_item = owners[item_cc]
        expected = (per_item >= 0) & (per_item != node)
        got = np.asarray(locks).astype(bool)
        if not np.array_equal(got, expected):
            bad = np.flatnonzero(got != expected)
            raise SanitizerError(
                "write-locks",
                f"stale write-lock input at node {node}: {bad.size} "
                f"item(s) diverge from the lease ownership view, e.g. "
                f"item {int(bad[0])}")
    n = 0
    for t, ok in zip(txns, verdicts):
        if not ok:
            continue
        for item in t.write_set:
            n += 1
            owner = int(owners[item_cc[item]])
            if owner >= 0 and owner != node:
                raise SanitizerError(
                    "write-locks",
                    f"txn {t.txid} passed certification at node {node} "
                    f"while writing item {item} leased to proc {owner}")
    return n
