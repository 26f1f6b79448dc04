"""Sharded, array-backed lease manager: the million-class control plane.

``LeaseManagerBase`` (repro_torch.core.lease) keeps one python list per conflict
class — exactly Algorithm 1, and the byte-identical oracle — but every
delivery instant walks python objects, which is the serial bottleneck at
million-class scale.  This module re-lands the same replicated state as a
handful of dense arrays sharded by class hash, so a whole instant's worth
of protocol work (enqueue at TO-deliver, blocking+frees at Opt-deliver,
dequeues at LeaseFreed, ``isEnabled`` checks for every waiting commit
phase) settles as vectorized queue-position math, with the packed
head/wait arrays dispatched through one
:func:`repro_torch.kernels.ops.settle_lease_batch` on the manager's device
when the instant is large enough to amortize the transfer (``jax_min``,
the reference's name, mirroring ``certify_jax_min``).

Layout: class ``cc`` lives in shard ``cc & (n_shards-1)`` at row
``cc >> log2(n_shards)``.  Each shard holds four ``[rows, cap]`` arrays
(``req``/``proc``/``active``/``blocked``) plus a ``qlen`` vector; ``cap``
grows in power-of-two steps like every other packed buffer in the repo
(``repro_torch.core.stm._pad_bucket`` idiom).  Queue order *is* column order:
removals compact with a stable argsort, so FIFO order matches the oracle's
``list.remove`` exactly.

Only FGL fits this layout (one LOR per class per request — a queue cell is
a LOR).  ALC's multi-class LORs stay on the sequential manager; the
cluster gates construction accordingly (``SimConfig.lease_mode``).

Equivalence contract (pinned by tests/test_lease_batched.py): for any
delivery stream, every observable — queue contents and order, owner
views, freed-key lists and their order, ``is_enabled``/piggyback
verdicts — is byte-identical to ``FGLLeaseManager``.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .lease import LeaseRequest


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BatchedLOR:
    """Handle onto one queue cell of a :class:`ShardedLeaseManager`.

    The oracle hands out ``LOR`` dataclass instances that *are* the state;
    here the state lives in the shard arrays, so the handle carries the
    immutable identity ``(req_id, proc, cc)`` and reads ``blocked`` /
    ``activeXacts`` live from its cell — consumers (the cluster, tests)
    see the same attribute surface either way.
    """

    __slots__ = ("_mgr", "req_id", "proc", "_cc")

    def __init__(self, mgr: "ShardedLeaseManager", req_id: int, proc: int,
                 cc: int) -> None:
        self._mgr = mgr
        self.req_id = req_id
        self.proc = proc
        self._cc = cc

    @property
    def cc(self) -> int:
        return self._cc

    @property
    def ccs(self) -> Tuple[int, ...]:
        return (self._cc,)

    def key(self) -> Tuple[int, int, Tuple[int, ...]]:
        return (self.req_id, self.proc, (self._cc,))

    def _cell(self) -> Tuple["_LeaseShard", int, int]:
        sh, row = self._mgr._locate(self._cc)
        pos = sh.find_one(row, self.req_id, self.proc)
        if pos < 0:
            raise LookupError(
                f"LOR (req={self.req_id}, proc={self.proc}, cc={self._cc}) "
                "is not enqueued")
        return sh, row, pos

    @property
    def blocked(self) -> bool:
        sh, row, pos = self._cell()
        return bool(sh.blocked[row, pos])

    @property
    def activeXacts(self) -> int:
        sh, row, pos = self._cell()
        return int(sh.active[row, pos])

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"BatchedLOR(req_id={self.req_id}, proc={self.proc}, "
                f"cc={self._cc})")


class _CQView:
    """Read-only ``cq[cc] -> [LOR-like]`` view over the shard arrays.

    Tests and diagnostics index the oracle's ``cq`` directly; this view
    materializes per-class handle lists on demand so the same code reads
    either manager.
    """

    def __init__(self, mgr: "ShardedLeaseManager") -> None:
        self._mgr = mgr

    def __len__(self) -> int:
        return self._mgr.n_classes

    def __getitem__(self, cc: int) -> List[BatchedLOR]:
        return self._mgr._queue_handles(cc)

    def __iter__(self):
        for cc in range(self._mgr.n_classes):
            yield self[cc]


class _LeaseShard:
    """Dense conflict-queue state for one shard: [slots, cap] cell arrays.

    Rows are *slots*, not class rows: a class row gets a dense slot the
    first time the protocol touches it (``lookup``), so the array
    footprint — and every scatter, gather and growth copy — scales with
    the classes in use, not the class space.  Sizing the arrays by the
    raw class-row space instead spreads the same traffic over a sparse
    multi-GB allocation where nearly every batched scatter faults fresh
    zero pages; at a million classes those soft faults cost more than
    the queue work itself.  Cell fill values are never observable:
    every reader masks by ``qlen``.
    """

    INIT_CAP = 8
    INIT_SLOTS = 1024

    def __init__(self, n_rows: int) -> None:
        self.n_rows = n_rows                 # class-row space of this shard
        self.cap = self.INIT_CAP
        self.slot_cap = min(_pow2(max(n_rows, 1)), self.INIT_SLOTS)
        self.n_slots = 0
        self.slot_of: Dict[int, int] = {}    # class row -> dense slot
        self.row_of = np.zeros((self.slot_cap,), np.int64)   # slot -> row
        self.req = np.zeros((self.slot_cap, self.cap), np.int32)
        self.proc = np.zeros((self.slot_cap, self.cap), np.int32)
        self.active = np.zeros((self.slot_cap, self.cap), np.int32)
        self.blocked = np.zeros((self.slot_cap, self.cap), bool)
        self.qlen = np.zeros((self.slot_cap,), np.int32)

    def lookup(self, rows: np.ndarray) -> np.ndarray:
        """Class rows -> dense slots, allocating on first touch.

        Allocation on read is deliberate: an untouched slot reads as an
        empty queue (qlen 0), so the translation can sit inside the one
        row-computation choke point (``_split`` / ``_locate``) and every
        array consumer stays oblivious to the indirection.
        """
        slot_of = self.slot_of
        out = np.empty((rows.size,), np.int64)
        new: List[int] = []
        for i, r in enumerate(rows.tolist()):
            s = slot_of.get(r)
            if s is None:
                s = len(slot_of)
                slot_of[r] = s
                new.append(r)
            out[i] = s
        if new:
            n = len(slot_of)
            if n > self.slot_cap:
                self._grow_slots(n)
            self.row_of[n - len(new): n] = new
            self.n_slots = n
        return out

    def lookup_one(self, r: int) -> int:
        s = self.slot_of.get(r)
        if s is not None:
            return s
        s = len(self.slot_of)
        if s + 1 > self.slot_cap:
            self._grow_slots(s + 1)
        self.slot_of[r] = s
        self.row_of[s] = r
        self.n_slots = s + 1
        return s

    def _grow_slots(self, need: int) -> None:
        slot_cap = _pow2(max(need, self.slot_cap * 2))
        ns = self.n_slots
        for name in ("req", "proc", "active", "blocked"):
            old = getattr(self, name)
            new = np.zeros((slot_cap, self.cap), old.dtype)
            new[:ns] = old[:ns]
            setattr(self, name, new)
        for name in ("row_of", "qlen"):
            old = getattr(self, name)
            new = np.zeros((slot_cap,), old.dtype)
            new[:ns] = old[:ns]
            setattr(self, name, new)
        self.slot_cap = slot_cap

    def _grow(self, need: int) -> None:
        cap = _pow2(max(need, self.cap * 2))
        ns = self.n_slots
        for name in ("req", "proc", "active", "blocked"):
            old = getattr(self, name)
            new = np.zeros((self.slot_cap, cap), old.dtype)
            new[:ns, : self.cap] = old[:ns]
            setattr(self, name, new)
        self.cap = cap

    # -- vectorized mutations ------------------------------------------------
    def enqueue(self, rows: np.ndarray, reqs: np.ndarray, procs: np.ndarray,
                blocked: np.ndarray) -> None:
        """Append one cell per entry, preserving input order within a row."""
        if rows.size == 0:
            return
        # rank duplicates of the same row so same-instant arrivals keep
        # their delivery order (stable sort = original order within a row)
        order = np.argsort(rows, kind="stable")
        sr = rows[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sr)) + 1]
        lens = np.diff(np.r_[starts, sr.size])
        rank_sorted = np.arange(sr.size) - np.repeat(starts, lens)
        rank = np.empty_like(rank_sorted)
        rank[order] = rank_sorted
        pos = self.qlen[rows] + rank
        need = int(pos.max()) + 1
        if need > self.cap:
            self._grow(need)
        self.req[rows, pos] = reqs
        self.proc[rows, pos] = procs
        self.active[rows, pos] = 1
        self.blocked[rows, pos] = blocked
        np.add.at(self.qlen, rows, 1)

    def find(self, rows: np.ndarray, reqs: np.ndarray,
             procs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Positions of (req, proc) cells in the given rows (-1: absent).

        A request enqueues at most one LOR per class, so (req_id, proc)
        identifies at most one cell per queue.
        """
        cols = np.arange(self.cap)[None, :]
        valid = cols < self.qlen[rows, None]
        hit = valid & (self.req[rows] == reqs[:, None]) \
            & (self.proc[rows] == procs[:, None])
        found = hit.any(axis=1)
        pos = np.where(found, hit.argmax(axis=1), -1)
        return pos, found

    def find_one(self, row: int, req_id: int, proc: int) -> int:
        n = int(self.qlen[row])
        if n == 0:
            return -1
        hit = (self.req[row, :n] == req_id) & (self.proc[row, :n] == proc)
        i = int(hit.argmax())
        return i if hit[i] else -1

    def compact_rows(self, urows: np.ndarray, delmask: np.ndarray) -> None:
        """Remove the masked cells of ``urows`` (delmask: [len(urows), cap]),
        sliding survivors left — the array rendition of ``list.remove`` in
        FIFO order (stable argsort keeps the relative order of keepers)."""
        order = np.argsort(delmask, axis=1, kind="stable")
        ndel = delmask.sum(axis=1).astype(np.int32)
        newlen = self.qlen[urows] - ndel
        cols = np.arange(self.cap)[None, :]
        tail = cols >= newlen[:, None]
        for name, fill in (("req", -1), ("proc", -1),
                           ("active", 0), ("blocked", False)):
            arr = getattr(self, name)
            sub = np.take_along_axis(arr[urows], order, axis=1)
            sub[tail] = fill
            arr[urows] = sub
        self.qlen[urows] = newlen

    def remove(self, rows: np.ndarray, reqs: np.ndarray,
               procs: np.ndarray) -> None:
        """Dequeue the named (req, proc) cells; absent keys are no-ops
        (matching the oracle's ``try: remove except ValueError: pass``)."""
        if rows.size == 0:
            return
        pos, found = self.find(rows, reqs, procs)
        if not found.any():
            return
        rows, pos = rows[found], pos[found]
        urows, inv = np.unique(rows, return_inverse=True)
        dm = np.zeros((urows.size, self.cap), bool)
        dm[inv, pos] = True
        self.compact_rows(urows, dm)


class ShardedLeaseManager:
    """FGL lease manager over sharded arrays (drop-in for FGLLeaseManager).

    The protocol surface (``on_to_deliver`` / ``on_opt_deliver`` /
    ``on_ur_deliver_freed`` / ``finished_xact`` / ``is_enabled`` /
    ``try_piggyback`` / ``purge_proc`` / owner queries) matches
    :class:`repro_torch.core.lease.FGLLeaseManager` observable-for-observable;
    the ``*_batch`` entry points amortize one delivery instant's worth of
    events into single array ops (the microbench and serving paths).
    """

    def __init__(self, proc: int, n_classes: int, *, n_shards: int = 8,
                 jax_min: int = 64, device="cuda") -> None:
        if n_shards < 1 or (n_shards & (n_shards - 1)) != 0:
            raise ValueError(f"n_shards must be a power of two, got {n_shards}")
        self.device = resolve_device(device)
        self.proc = proc
        self.n_classes = n_classes
        self.n_shards = n_shards
        self.jax_min = jax_min
        self._smask = n_shards - 1
        self._sbits = n_shards.bit_length() - 1
        self._n_rows = (n_classes + n_shards - 1) // n_shards
        self._shards = [_LeaseShard(self._n_rows) for _ in range(n_shards)]
        # same replica-local bookkeeping as the oracle
        self._by_req: Dict[int, List[BatchedLOR]] = {}
        self._pending_opt: Dict[int, LeaseRequest] = {}
        # sparse twin of the oracle's pending-ccs union: per-class count of
        # pending opt-delivered requests touching it (born-blocked check).
        # A dict, not an int32[C] vector: pending sets are instant-sized,
        # and the hot batch loops touch it per request — O(ccs) dict ops
        # beat a C-wide scatter per message by orders of magnitude
        self._pending_cnt: Dict[int, int] = {}
        self._dead: set = set()
        self.n_piggyback = 0
        self.n_requests = 0
        self.cq = _CQView(self)

    # -- layout helpers ------------------------------------------------------
    def _locate(self, cc: int) -> Tuple[_LeaseShard, int]:
        sh = self._shards[cc & self._smask]
        return sh, sh.lookup_one(cc >> self._sbits)

    def _split(self, ccs: np.ndarray) -> Iterable[
            Tuple[_LeaseShard, np.ndarray, np.ndarray]]:
        """Group flat class ids by shard: yields (shard, slots, flat_mask).

        The returned row indices are the shard's dense *slots* — the
        class-row -> slot translation happens here (and in ``_locate``)
        so every consumer indexes the compact arrays directly.
        """
        s = ccs & self._smask
        rows = ccs >> self._sbits
        for sh_id in np.unique(s):
            m = s == sh_id
            sh = self._shards[sh_id]
            yield sh, sh.lookup(rows[m]), m

    def _queue_handles(self, cc: int) -> List[BatchedLOR]:
        sh, row = self._locate(cc)
        n = int(sh.qlen[row])
        return [BatchedLOR(self, int(sh.req[row, i]), int(sh.proc[row, i]), cc)
                for i in range(n)]

    # -- owner queries -------------------------------------------------------
    def head_owner(self, cc: int) -> int:
        sh, row = self._locate(cc)
        return int(sh.proc[row, 0]) if sh.qlen[row] > 0 else -1

    def owner_np(self) -> np.ndarray:
        """L(i, x) ownership vector as one gather (-1: unowned)."""
        _, head_proc, _, qlen = self._head_state()
        return np.where(qlen > 0, head_proc, -1).astype(np.int32)

    def owner_view(self) -> List[int]:
        return self.owner_np().tolist()

    def owns_all(self, ccs: Iterable[int]) -> bool:
        return all(self.head_owner(cc) == self.proc for cc in ccs)

    def has_unblocked(self, cc: int, proc: int) -> bool:
        """True iff ``proc`` has an unblocked LOR anywhere in ``cc``'s queue."""
        sh, row = self._locate(cc)
        n = int(sh.qlen[row])
        if n == 0:
            return False
        return bool(((sh.proc[row, :n] == proc)
                     & ~sh.blocked[row, :n]).any())

    def _head_state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """Per-class head cell, scattered back from the dense slot tables.

        O(touched classes) work into O(n_classes) output: classes no slot
        was ever allocated for stay at qlen 0 (unowned), which is exactly
        their queue state.
        """
        C = self.n_classes
        head_req = np.zeros((C,), np.int32)
        head_proc = np.zeros((C,), np.int32)
        head_active = np.zeros((C,), np.int32)
        qlen = np.zeros((C,), np.int32)
        for s_id, sh in enumerate(self._shards):
            ns = sh.n_slots
            if not ns:
                continue
            cc = (sh.row_of[:ns] << self._sbits) | s_id
            head_req[cc] = sh.req[:ns, 0]
            head_proc[cc] = sh.proc[:ns, 0]
            head_active[cc] = sh.active[:ns, 0]
            qlen[cc] = sh.qlen[:ns]
        return head_req, head_proc, head_active, qlen

    # -- the per-instant settle ---------------------------------------------
    def settle(self, groups: Sequence[Sequence[BatchedLOR]],
               fresh_ccs: Optional[np.ndarray] = None, *,
               use_kernel: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """One settle over the instant's touched classes.

        Returns ``(rel, owner, free, enabled)``: ``rel`` is the sorted
        vector of classes this instant actually touched (every waiter's
        class plus ``fresh_ccs``), and ``owner``/``free`` are head verdicts
        aligned to it.  Compacting to ``rel`` is what keeps an instant
        O(batch) at million-class scale — the head state of untouched
        classes can't change a verdict, so it is never gathered.  The
        compact axis is pow2-padded (padding rows read as empty queues),
        as in the reference.

        ``fresh_ccs`` names classes whose head LOR was newly blocked at
        this instant (an Opt-deliver hit an own unblocked head); the free
        mask is exactly those heads that are also drained — the
        blocked-and-drained rule as queue-position math.  ``groups`` are
        waiting LOR groups (commit phases / prefetches); ``enabled[b]`` is
        Algorithm 1's ``isEnabled`` for group ``b``.  Dispatches the torch
        settle on the manager's device when ``use_kernel`` (callers gate on
        ``jax_min``), else the numpy twin — the two agree bitwise (tests
        pin it).
        """
        if fresh_ccs is None:
            fresh_ccs = np.empty((0,), np.int32)
        fresh_ccs = np.asarray(fresh_ccs, np.int32)
        flat_cc = np.fromiter((l._cc for g in groups for l in g), np.int32)
        rel = np.unique(np.concatenate([flat_cc, fresh_ccs]))
        Cp = _pow2(max(rel.size, 1))
        head_req = np.full((Cp,), -1, np.int32)
        head_proc = np.full((Cp,), -1, np.int32)
        head_active = np.zeros((Cp,), np.int32)
        qlen = np.zeros((Cp,), np.int32)
        for sh, rows, m in self._split(rel):
            idx = np.flatnonzero(m)
            head_req[idx] = sh.req[rows, 0]
            head_proc[idx] = sh.proc[rows, 0]
            head_active[idx] = sh.active[rows, 0]
            qlen[idx] = sh.qlen[rows]
        fresh = np.zeros((Cp,), bool)
        fresh[np.searchsorted(rel, fresh_ccs)] = True
        B = len(groups)
        Bp = _pow2(max(B, 1))
        K = _pow2(max([len(g) for g in groups] + [1]))
        wait_req = np.full((Bp, K), -1, np.int32)
        wait_cc = np.full((Bp, K), -1, np.int32)
        for i, g in enumerate(groups):
            for j, l in enumerate(g):
                wait_req[i, j] = l.req_id
                wait_cc[i, j] = l._cc
        valid = wait_cc >= 0
        wait_cc[valid] = np.searchsorted(rel, wait_cc[valid])
        if use_kernel:
            from ..kernels import ops

            # two host->device copies in, one device->host copy out
            heads = torch.from_numpy(np.stack(
                [head_req, head_proc, head_active, qlen,
                 fresh.astype(np.int32)]))
            waits = torch.from_numpy(np.stack([wait_req, wait_cc]))
            # lint: allow(host-sync): the settle's inputs are the host's
            # queue heads and waiting groups, packed above
            heads, waits = heads.to(self.device), waits.to(self.device)
            owner, free, enabled = ops.settle_lease_batch(
                heads[0], heads[1], heads[2], heads[3], heads[4] > 0,
                waits[0], waits[1], self.proc)
            out = torch.cat([owner, free.to(torch.int32),
                             enabled.to(torch.int32)])
            # lint: allow(host-sync): the settle's verdicts drive the
            # host's queues: its one wait
            out = out.cpu().numpy()
            return (rel, out[:Cp], out[Cp:2 * Cp].astype(bool),
                    out[2 * Cp:2 * Cp + B].astype(bool))
        owner, free, enabled = _settle_np(
            head_req, head_proc, head_active, qlen, fresh,
            wait_req, wait_cc, self.proc)
        return rel, owner, free, enabled[:B]

    def enabled_mask(self, groups: Sequence[Sequence[BatchedLOR]]
                     ) -> List[bool]:
        """Vectorized ``isEnabled`` over many waiting groups at once."""
        if not groups:
            return []
        if len(groups) >= self.jax_min:
            _, _, _, enabled = self.settle(groups, use_kernel=True)
            return [bool(x) for x in enabled]
        return [self.is_enabled(g) for g in groups]

    def is_enabled(self, lors: Sequence[BatchedLOR]) -> bool:
        for l in lors:
            sh, row = self._locate(l.cc)
            if (sh.qlen[row] == 0 or sh.req[row, 0] != l.req_id
                    or sh.proc[row, 0] != l.proc):
                return False
        return True

    # -- protocol events -----------------------------------------------------
    def on_to_deliver(self, req: LeaseRequest) -> List[BatchedLOR]:
        return self.to_deliver_batch([req])[0]

    def to_deliver_batch(self, reqs: Sequence[LeaseRequest]
                         ) -> List[List[BatchedLOR]]:
        """TO-deliver many requests in delivery order, one batched enqueue.

        Born-blocked catch-up reads only the pending counter (never queue
        state), so deferring the enqueue scatter to the end of the batch is
        exact: within a row, batch order is delivery order.  The loop body
        is deliberately numpy-free — per-request array calls would cost
        microseconds each; flat python lists feed one concatenated scatter.
        """
        out: List[List[BatchedLOR]] = []
        ccs_l: List[int] = []
        rid_l: List[int] = []
        proc_l: List[int] = []
        blk_l: List[bool] = []
        cnt = self._pending_cnt
        for req in reqs:
            if req.coarse:
                raise ValueError(
                    "ShardedLeaseManager is FGL-only (lease_mode='batched' "
                    "requires lease_kind='fgl')")
            pending = self._pending_opt.pop(req.req_id, None)
            if pending is not None:
                for cc in pending.ccs:
                    n = cnt[cc] - 1
                    if n:
                        cnt[cc] = n
                    else:
                        del cnt[cc]
            if req.proc in self._dead:
                out.append([])
                continue
            born = req.proc == self.proc and bool(self._pending_opt)
            ccs_l.extend(req.ccs)
            rid_l.extend([req.req_id] * len(req.ccs))
            proc_l.extend([req.proc] * len(req.ccs))
            blk_l.extend((cc in cnt) if born else False for cc in req.ccs)
            handles = [BatchedLOR(self, req.req_id, req.proc, cc)
                       for cc in req.ccs]
            self._by_req[req.req_id] = handles
            out.append(handles)
        if ccs_l:
            flat = np.asarray(ccs_l, np.int32)
            flat_rid = np.asarray(rid_l, np.int32)
            flat_proc = np.asarray(proc_l, np.int32)
            flat_blk = np.asarray(blk_l, bool)
            for sh, rows, m in self._split(flat):
                sh.enqueue(rows, flat_rid[m], flat_proc[m], flat_blk[m])
        return out

    def on_opt_deliver(self, req: LeaseRequest) -> List[BatchedLOR]:
        return self.opt_deliver_batch([req])

    def opt_deliver_batch(self, reqs: Sequence[LeaseRequest]
                          ) -> List[BatchedLOR]:
        """Opt-deliver many requests: freeLocalLeases as one settle.

        Blocking is idempotent and only the *first* request of an instant
        to touch a class can see its head own-unblocked-and-drained, so
        evaluating free candidates on pre-state at first occurrence and
        OR-blocking every touched own LOR reproduces the sequential
        per-request loop exactly.  Returned frees follow the flattened
        (request-order, class-order) stream, i.e. the order the oracle
        would have appended them.
        """
        flat: List[int] = []
        cnt = self._pending_cnt
        for req in reqs:
            if req.proc in self._dead:
                continue
            self._pending_opt[req.req_id] = req
            for cc in req.ccs:
                cnt[cc] = cnt.get(cc, 0) + 1
            flat.extend(req.ccs)
        if not flat:
            return []
        return self._opt_block_stream(np.asarray(flat, np.int32))

    def _opt_block_stream(self, ccs_flat: np.ndarray) -> List[BatchedLOR]:
        uniq, first_idx = np.unique(ccs_flat, return_index=True)
        fresh_u = np.zeros((uniq.size,), bool)     # head own & unblocked, pre
        head_rid = np.full((uniq.size,), -1, np.int32)
        for sh, rows, m in self._split(uniq):
            cols = np.arange(sh.cap)[None, :]
            valid = cols < sh.qlen[rows, None]
            own_unblk = valid & (sh.proc[rows] == self.proc) \
                & ~sh.blocked[rows]
            fresh_u[m] = own_unblk[:, 0]
            head_rid[m] = sh.req[rows, 0]
            if own_unblk.any():
                sh.blocked[rows] |= own_unblk
        fresh_idx = np.flatnonzero(fresh_u)
        if not fresh_idx.size:
            return []
        # rel == uniq[fresh_idx] (already sorted unique), so free aligns 1:1
        _, _, free, _ = self.settle(
            [], uniq[fresh_idx], use_kernel=fresh_idx.size >= self.jax_min)
        sel = fresh_idx[free[: fresh_idx.size]]
        sel = sel[np.argsort(first_idx[sel], kind="stable")]
        return [BatchedLOR(self, int(head_rid[i]), self.proc, int(uniq[i]))
                for i in sel]

    def on_ur_deliver_freed(
            self, freed_keys: Sequence[Tuple[int, int, Tuple[int, ...]]]
    ) -> None:
        return self.freed_batch([freed_keys])

    def freed_batch(
            self,
            key_batches: Sequence[Sequence[Tuple[int, int, Tuple[int, ...]]]]
    ) -> None:
        """UR-deliver many LeaseFreed batches: one vectorized dequeue.

        Absent keys are no-ops (late frees after a purge), and stable
        compaction makes the final queue order independent of removal
        order — both matching the oracle.
        """
        ccs: List[int] = []
        rids: List[int] = []
        procs: List[int] = []
        for freed_keys in key_batches:
            for (req_id, proc, kccs) in freed_keys:
                lors = self._by_req.get(req_id)
                if lors is not None:
                    kept = [l for l in lors
                            if not (l.ccs == kccs and l.proc == proc)]
                    if kept:
                        self._by_req[req_id] = kept
                    else:
                        del self._by_req[req_id]
                for cc in kccs:
                    ccs.append(cc)
                    rids.append(req_id)
                    procs.append(proc)
        if not ccs:
            return
        flat = np.asarray(ccs, np.int32)
        flat_rid = np.asarray(rids, np.int32)
        flat_proc = np.asarray(procs, np.int32)
        for sh, rows, m in self._split(flat):
            sh.remove(rows, flat_rid[m], flat_proc[m])

    def finished_xact(self, lors: Sequence[BatchedLOR]) -> List[BatchedLOR]:
        """FinishedXact: decrement each LOR; return blocked-and-drained."""
        to_free: List[BatchedLOR] = []
        seen: set = set()
        for l in lors:
            sh, row = self._locate(l.cc)
            pos = sh.find_one(row, l.req_id, l.proc)
            assert pos >= 0, "finished_xact on a dequeued LOR"
            sh.active[row, pos] -= 1
            assert sh.active[row, pos] >= 0, "activeXacts underflow"
            if sh.blocked[row, pos] and sh.active[row, pos] == 0:
                k = (l.req_id, l.proc, l.cc)
                if k not in seen:
                    seen.add(k)
                    to_free.append(l)
        return to_free

    def finish_batch(self, groups: Sequence[Sequence[BatchedLOR]]
                     ) -> List[BatchedLOR]:
        """Vectorized FinishedXact over many transactions at once.

        All decrements scatter first (cells are distinct across FGL groups
        of distinct transactions — piggybacking shares cells but each
        transaction holds its own reference count); frees are then read
        out in input order.
        """
        flat: List[BatchedLOR] = [l for g in groups for l in g]
        if not flat:
            return []
        ccs = np.fromiter((l.cc for l in flat), np.int32, count=len(flat))
        rids = np.fromiter((l.req_id for l in flat), np.int32,
                           count=len(flat))
        procs = np.fromiter((l.proc for l in flat), np.int32,
                            count=len(flat))
        free_flags = np.zeros((len(flat),), bool)
        idx = np.arange(len(flat))
        for sh, rows, m in self._split(ccs):
            pos, found = sh.find(rows, rids[m], procs[m])
            assert found.all(), "finish_batch on a dequeued LOR"
            np.subtract.at(sh.active, (rows, pos), 1)
            assert (sh.active[rows, pos] >= 0).all(), "activeXacts underflow"
            free_flags[idx[m]] = sh.blocked[rows, pos] \
                & (sh.active[rows, pos] == 0)
        out: List[BatchedLOR] = []
        seen: set = set()
        for i in np.flatnonzero(free_flags):
            l = flat[i]
            k = (l.req_id, l.proc, l.cc)
            if k not in seen:
                seen.add(k)
                out.append(l)
        return out

    # -- piggybacking --------------------------------------------------------
    def try_piggyback(self, ccs: FrozenSet[int]) -> Optional[List[BatchedLOR]]:
        """Alg. 1 line 4: cover ``ccs`` with own unblocked enqueued LORs."""
        picks: List[Tuple[_LeaseShard, int, int, int, int]] = []
        for cc in sorted(ccs):
            sh, row = self._locate(cc)
            n = int(sh.qlen[row])
            if n == 0:
                return None
            m = (sh.proc[row, :n] == self.proc) & ~sh.blocked[row, :n]
            i = int(m.argmax())
            if not m[i]:
                return None
            picks.append((sh, row, i, cc, int(sh.req[row, i])))
        for (sh, row, i, _cc, _rid) in picks:
            sh.active[row, i] += 1
        self.n_piggyback += 1
        return [BatchedLOR(self, rid, self.proc, cc)
                for (_sh, _row, _i, cc, rid) in picks]

    def missing_ccs(self, ccs: FrozenSet[int]) -> FrozenSet[int]:
        return frozenset(cc for cc in ccs
                         if not self.has_unblocked(cc, self.proc))

    def protocol_state(self) -> Tuple:
        """Canonical protocol-state snapshot for the schedule explorer.

        Same shape as ``LeaseManagerBase.protocol_state`` — read straight
        off the shard arrays so fingerprinting skips the per-cell handle
        objects the ``cq`` view would allocate.
        """
        queues = []
        for s_id, sh in enumerate(self._shards):
            for row, slot in sh.slot_of.items():
                n = int(sh.qlen[slot])
                if n:
                    cc = (row << self._sbits) | s_id
                    queues.append((cc, tuple(
                        (int(sh.req[slot, i]), int(sh.proc[slot, i]),
                         int(sh.active[slot, i]), bool(sh.blocked[slot, i]))
                        for i in range(n))))
        queues.sort()
        return (tuple(queues), tuple(sorted(self._pending_opt)),
                tuple(sorted(self._dead)))

    # -- view change ---------------------------------------------------------
    def purge_proc(self, proc: int) -> None:
        """View change: reclaim every LOR owned by a failed member."""
        self._dead.add(proc)
        cnt = self._pending_cnt
        for req_id in list(self._pending_opt):
            if self._pending_opt[req_id].proc == proc:
                req = self._pending_opt.pop(req_id)
                for cc in req.ccs:
                    n = cnt[cc] - 1
                    if n:
                        cnt[cc] = n
                    else:
                        del cnt[cc]
        for sh in self._shards:
            ns = sh.n_slots
            if not ns:
                continue
            cols = np.arange(sh.cap)[None, :]
            valid = cols < sh.qlen[:ns, None]
            dm = valid & (sh.proc[:ns] == proc)
            rows = np.flatnonzero(dm.any(axis=1))
            if rows.size:
                sh.compact_rows(rows, dm[rows])
        for req_id in list(self._by_req):
            owners = {l.proc for l in self._by_req[req_id]}
            assert len(owners) == 1, \
                "invariant violated: LORs of one request span procs"
            if proc in owners:
                del self._by_req[req_id]


def _settle_np(head_req: np.ndarray, head_proc: np.ndarray,
               head_active: np.ndarray, qlen: np.ndarray,
               fresh_blocked: np.ndarray, wait_req: np.ndarray,
               wait_cc: np.ndarray, proc: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy twin of :func:`repro_torch.kernels.ref.lease_settle_ref`
    (bitwise)."""
    c = head_req.shape[0]
    occupied = qlen > 0
    owner = np.where(occupied, head_proc, -1).astype(np.int32)
    free = occupied & fresh_blocked & (head_proc == proc) & (head_active == 0)
    valid = wait_cc >= 0
    cc = np.clip(wait_cc, 0, max(c - 1, 0))
    at_head = occupied[cc] & (head_req[cc] == wait_req)
    enabled = np.where(valid, at_head, True).all(axis=1)
    return owner, free, enabled


def pack_lease_requests(reqs: Sequence[LeaseRequest]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack requests into pow2-bucketed int32 ``[B, K]`` arrays (-1 padded).

    The lease-layer sibling of ``repro_torch.core.stm.pack_read_sets``: rows are
    requests, columns their conflict classes, both axes padded to powers
    of two, as in the reference.  Returns
    ``(cc, req_id, proc)`` arrays.
    """
    b = _pow2(max(len(reqs), 1))
    k = _pow2(max([len(r.ccs) for r in reqs] + [1]))
    cc = np.full((b, k), -1, np.int32)
    rid = np.full((b, k), -1, np.int32)
    proc = np.full((b, k), -1, np.int32)
    for i, r in enumerate(reqs):
        n = len(r.ccs)
        cc[i, :n] = r.ccs
        rid[i, :n] = r.req_id
        proc[i, :n] = r.proc
    return cc, rid, proc
