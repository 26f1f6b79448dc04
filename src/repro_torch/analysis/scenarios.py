"""Explorable protocol scenarios, including the seeded-mutant catalogue.

Every entry in :data:`SCENARIOS` maps a name to ``builder(args, policy) ->
model`` — a freshly constructed simulation wired with the explorer's
recording :class:`~repro_torch.core.events.SchedulePolicy`.  The name + args
pair is recorded in every emitted trace, which is what makes counterexamples
replayable from the CLI (``repro-torch-explore replay trace.json``) without
pickling live objects.  ``args["device"]`` ("cuda" by default, as everywhere
in the port) places the sharded lease managers' settle, the step
certifier's epoch store and the cluster's version tables.

Three families:

* **scripted mutants** (``mutant-*``) — the ten seeded protocol bugs of
  ``tests/test_sanitizer_mutants.py``, wrapped as event sequences so the
  explorer re-finds each one (they trip the sanitizer on *every* schedule,
  including the default).
* **schedule-only mutants** (``mutant-no-born-blocked``,
  ``mutant-stale-piggyback``) — bugs the single-schedule sanitizer run
  provably cannot catch: the default FIFO schedule is clean, and only a
  legal reordering of an optimistic delivery against a same-instant
  total-order delivery (resp. a local piggyback) exposes them.  Pass
  ``{"mutant": False}`` for the un-mutated control.
* **smoke cells** (``smoke-*``) — tiny real-:class:`Cluster` configurations
  explored in CI, expected violation-free.  ``smoke-bank`` also takes
  ``jax_min``: 1 sends every drain through the drain kernel and every
  settle through the device ops (the default keeps the numpy paths).
"""
from __future__ import annotations

from typing import Callable, Dict, FrozenSet, List, Optional

import numpy as np

from ..core.events import EventQueue, EvMeta, SchedulePolicy
from ..core.gcs import GCSLatency, SimGCS
from ..core.lease import FGLLeaseManager, LeaseRequest, _dedup
from ..core.lease_batched import ShardedLeaseManager
from .fingerprint import digest, queue_state
from .sanitizer import LeaseSanitizer, check_write_locks


# --------------------------------------------------------------------------
# Scripted single-manager scenarios (the sanitizer-mutant catalogue)
# --------------------------------------------------------------------------

class ScriptedModel:
    """A fixed step sequence on one event queue — the simplest model shape.

    Steps are scheduled at distinct instants at build time; the explorer
    can still reorder them wherever the commutation window pools them.
    """

    def __init__(self, policy: Optional[SchedulePolicy],
                 horizon: float = 100.0) -> None:
        self.events = EventQueue(policy=policy)
        self.horizon = horizon
        self._state_fns: List[Callable[[], object]] = []

    def track(self, lm) -> None:
        self._state_fns.append(lm.protocol_state)

    def step(self, at: float, fn: Callable[[], None],
             keys: Optional[FrozenSet[int]] = None, label: str = "") -> None:
        self.events.schedule(at, fn, meta=EvMeta(
            kind="local",
            keys=None if keys is None else frozenset(keys), label=label))

    def go(self) -> None:
        self.events.run(self.horizon, max_events=10_000)

    def fingerprint(self) -> str:
        return digest(tuple(f() for f in self._state_fns),
                      queue_state(self.events))

    def wedged(self) -> List[str]:
        return []


def _device(args: Dict) -> str:
    return args.get("device", "cuda")


def _mgr(kind: str, proc: int, n_classes: int = 8, device: str = "cuda"):
    if kind == "sharded":
        return LeaseSanitizer(ShardedLeaseManager(
            proc, n_classes, n_shards=2, jax_min=1, device=device))
    return LeaseSanitizer(FGLLeaseManager(proc, n_classes))


def _req(req_id: int, proc: int, ccs) -> LeaseRequest:
    return LeaseRequest(req_id=req_id, proc=proc, ccs=tuple(sorted(ccs)))


def _sc_skipped_epoch_bump(args: Dict, pol) -> ScriptedModel:
    from ..serve.certifier import StepCertifier

    m = ScriptedModel(pol)
    owner = {4: 0}
    c = StepCertifier(2, sanitize=True, owner_of=lambda s: owner.get(s, -1),
                      device=_device(args))

    class R:
        sid = 4

    m.step(1.0, lambda: c.bump(4, 1), label="bump sid4 e1")
    m.step(2.0, lambda: c.enqueue(0, R(), 1), label="enqueue step")
    # the bug: apply_move updates the router only — no certifier.bump
    m.step(3.0, lambda: owner.__setitem__(4, 1), label="move sid4")
    m.step(4.0, lambda: c.drain(0), label="drain")
    return m


def _sc_drain_prefetch_non_head(args: Dict, pol) -> ScriptedModel:
    m = ScriptedModel(pol)
    lm = _mgr(args.get("kind", "oracle"), proc=1, device=_device(args))
    m.track(lm)
    box: Dict[str, list] = {}
    m.step(1.0, lambda: lm.on_to_deliver(_req(1, 0, (5,))),
           keys={5}, label="to r1 (remote head)")

    def own():
        box["lors"] = lm.on_to_deliver(_req(2, 1, (5,)))
        lm.mark_prefetch(box["lors"])

    m.step(2.0, own, keys={5}, label="to r2 (own prefetch)")
    # the bug: draining a prefetch without waiting for is_enabled
    m.step(3.0, lambda: lm.finished_xact(box["lors"]),
           keys={5}, label="drain prefetch non-head")
    return m


def _sc_view_change_overpurge(args: Dict, pol) -> ScriptedModel:
    class OverPurging(FGLLeaseManager):
        def purge_proc(self, proc):
            super().purge_proc(proc)
            super().purge_proc(2)  # the bug: an innocent member's LORs go too

    m = ScriptedModel(pol)
    lm = LeaseSanitizer(OverPurging(0, 8))
    m.track(lm)
    m.step(1.0, lambda: lm.on_to_deliver(_req(1, 1, (3,))),
           keys={3}, label="to r1")
    m.step(2.0, lambda: lm.on_to_deliver(_req(2, 2, (4,))),
           keys={4}, label="to r2")
    m.step(3.0, lambda: lm.purge_proc(1), label="view -1")
    return m


def _sc_double_grant(args: Dict, pol) -> ScriptedModel:
    m = ScriptedModel(pol)
    lm = _mgr(args.get("kind", "oracle"), proc=0, device=_device(args))
    m.track(lm)
    req = _req(1, 0, (2,))
    m.step(1.0, lambda: lm.on_to_deliver(req), keys={2}, label="to r1")
    # the bug: duplicate TO delivery not deduped
    m.step(2.0, lambda: lm.on_to_deliver(req), keys={2}, label="to r1 dup")
    return m


class _WTxn:
    def __init__(self, txid: int, writes) -> None:
        self.txid = txid
        self.write_set = {w: 1.0 for w in writes}


def _sc_stale_write_locks(args: Dict, pol) -> ScriptedModel:
    m = ScriptedModel(pol)
    owners = np.array([0, 1], np.int32)          # cc=1 leased to proc 1
    item_cc = np.array([0, 1, 1], np.int32)
    stale = np.zeros(3, np.int32)                # the bug: locks not refreshed
    m.step(1.0, lambda: check_write_locks(0, owners, item_cc, stale, [], []),
           keys={0, 1}, label="certify with stale locks")
    return m


def _sc_leased_away_write(args: Dict, pol) -> ScriptedModel:
    m = ScriptedModel(pol)
    owners = np.array([0, 1], np.int32)
    item_cc = np.array([0, 1, 1], np.int32)
    # the bug: verdict True for a txn writing item 2 (leased to proc 1)
    m.step(1.0, lambda: check_write_locks(0, owners, item_cc, None,
                                          [_WTxn(7, [2])], [True]),
           keys={0, 1}, label="certify leased-away write")
    return m


def _sc_recycled_sid(args: Dict, pol) -> ScriptedModel:
    from ..serve.certifier import StepCertifier

    m = ScriptedModel(pol)
    c = StepCertifier(2, sanitize=True, device=_device(args))
    m.step(1.0, lambda: c.bump(5, 7), label="bump sid5 e7")
    # the bug: a recycled sid restarts below its tombstone
    m.step(2.0, lambda: c.bump(5, 3), label="bump sid5 e3")
    return m


def _sc_free_active_lease(args: Dict, pol) -> ScriptedModel:
    m = ScriptedModel(pol)
    lm = _mgr(args.get("kind", "oracle"), proc=0, device=_device(args))
    m.track(lm)
    box: Dict[str, list] = {}

    def grant():
        box["lors"] = lm.on_to_deliver(_req(1, 0, (2, 3)))

    m.step(1.0, grant, keys={2, 3}, label="to r1")
    # the bug: freeing a lease that was never blocked nor drained
    m.step(2.0, lambda: lm.on_ur_deliver_freed([box["lors"][0].key()]),
           keys={2, 3}, label="freed live r1")
    return m


def _sc_forged_free(args: Dict, pol) -> ScriptedModel:
    m = ScriptedModel(pol)
    lm = _mgr("oracle", proc=0)
    m.track(lm)
    m.step(1.0, lambda: lm.on_to_deliver(_req(1, 0, (2,))),
           keys={2}, label="to r1")
    m.step(2.0, lambda: lm.on_ur_deliver_freed([(99, 1, (5,))]),
           keys={5}, label="forged free r99")
    return m


def _sc_enabled_mask_flip(args: Dict, pol) -> ScriptedModel:
    m = ScriptedModel(pol)
    lm = _mgr("sharded", proc=0, device=_device(args))
    m.track(lm)
    box: Dict[str, list] = {}

    def setup():
        box["g1"] = lm.on_to_deliver(_req(1, 0, (1,)))
        lm.on_to_deliver(_req(2, 1, (2,)))
        box["g2"] = lm.on_to_deliver(_req(3, 0, (2,)))
        inner = lm.inner
        orig = inner.enabled_mask
        # the bug: a settle-kernel defect flips the packed verdicts
        inner.enabled_mask = lambda groups: [not v for v in orig(groups)]

    m.step(1.0, setup, keys={1, 2}, label="grant + flip settle")
    m.step(2.0, lambda: lm.enabled_mask([box["g1"], box["g2"]]),
           keys={1, 2}, label="settle")
    return m


# --------------------------------------------------------------------------
# Schedule-only mutants: clean on the default schedule, buggy under reorder
# --------------------------------------------------------------------------

class NoBornBlockedFGL(FGLLeaseManager):
    """Mutant: drops the ``_pending_opt`` born-blocked catch-up.

    Algorithm 1 blocks local LORs at Opt-deliver; the catch-up in
    ``on_to_deliver`` closes the race where a conflicting request's
    Opt-deliver lands *before* this request's own TO-deliver enqueues its
    LORs.  On the default FIFO schedule the TO-deliver always dispatches
    first (lower scheduling seq at the shared instant), so no per-event invariant
    ever fires — only the reordered schedule wedges, which the explorer's
    quiescence check catches.
    """

    def on_to_deliver(self, req: LeaseRequest):
        self._pending_opt.pop(req.req_id, None)
        if req.proc in self._dead:
            return []
        lors = self._create_lors(req)
        # the seeded mutant re-implements the manager's own enqueue minus
        # the catch-up under test
        self._by_req[req.req_id] = lors
        for lor in lors:
            for cc in lor.ccs:
                self.cq[cc].append(lor)
        # the bug: no born-blocked catch-up against _pending_opt
        return lors


class StalePiggybackFGL(FGLLeaseManager):
    """Mutant: piggybacking consults a pre-Opt-deliver blocked snapshot.

    ``on_opt_deliver`` snapshots which own LORs were unblocked before it
    blocks them; ``try_piggyback`` then treats snapshot members as still
    piggybackable.  Harmless when the piggyback dispatches before the
    conflicting Opt-deliver (the default order here); under the legal
    reordering it attaches a transaction to a blocked LOR — which the
    sanitizer flags (blocked-and-drained) on that schedule only.
    """

    def __init__(self, proc: int, n_classes: int) -> None:
        super().__init__(proc, n_classes)
        self._stale = set()

    def on_opt_deliver(self, req: LeaseRequest):
        for cc in req.ccs:
            for lor in self.cq[cc]:
                if lor.proc == self.proc and not lor.blocked:
                    self._stale.add(id(lor))
        return super().on_opt_deliver(req)

    def try_piggyback(self, ccs: FrozenSet[int]):
        S = []
        for cc in sorted(ccs):
            found = None
            for lor in self.cq[cc]:
                if lor.proc == self.proc and (
                        not lor.blocked or id(lor) in self._stale):
                    found = lor
                    break
            if found is None:
                return None
            S.append(found)
        for lor in _dedup(S):
            lor.activeXacts += 1
        self.n_piggyback += 1
        return S


class LeaseHarness:
    """A miniature lease-protocol deployment over :class:`SimGCS`.

    Wires sanitized lease managers into the GCS exactly like the cluster's
    lease path (opt-deliver frees, TO-deliver enqueues + waiter tracking,
    UR freed dequeues + waiter recheck), without the STM/certification
    machinery — small enough for exhaustive exploration, real enough that
    protocol liveness bugs show up as wedged waiters at quiescence.
    """

    def __init__(self, policy: Optional[SchedulePolicy], n_nodes: int,
                 n_classes: int, mgr_factory: Callable[[int], object],
                 step_ms: float = 0.35, horizon: float = 60.0) -> None:
        self.events = EventQueue(policy=policy)
        self.gcs = SimGCS(self.events, n_nodes,
                          GCSLatency(step_ms=step_ms, oab_serialize_ms=0.0))
        self.lms = [LeaseSanitizer(mgr_factory(i)) for i in range(n_nodes)]
        self.waiters: List[Dict[int, list]] = [{} for _ in range(n_nodes)]
        self.holds: Dict[int, float] = {}
        self.pg_failed: List = []
        self.horizon = horizon
        for i in range(n_nodes):
            self.gcs.on_opt[i] = lambda msg, sender, n=i: self._on_opt(n, msg)
            self.gcs.on_to[i] = lambda msg, sender, n=i: self._on_to(n, msg)
            self.gcs.on_urb[i] = lambda msg, sender, n=i: self._on_urb(n, msg)

    # -- scripted stimulus ---------------------------------------------------
    def request(self, at: float, proc: int, req_id: int, ccs,
                hold_ms: float = 1.0) -> None:
        """Broadcast a lease request at ``at``; the owning txn holds its
        LORs for ``hold_ms`` once enabled, then finishes."""
        self.holds[req_id] = hold_ms
        ccs = tuple(sorted(ccs))
        self.events.schedule(
            at,
            (lambda p=proc, r=req_id, c=ccs:
             self.gcs.oa_broadcast(p, ("lease", _req(r, p, c)))),
            meta=EvMeta(kind="local", node=proc, keys=frozenset(ccs),
                        label=f"req{req_id}@{proc}"))

    def piggyback(self, at: float, proc: int, ccs,
                  hold_ms: float = 1.0) -> None:
        """Attempt Alg. 1 line 4 reuse at ``at``; on success the attached
        txn holds for ``hold_ms``.  A failed attempt is recorded and the
        txn is simply not run (no fallback request)."""
        keys = frozenset(ccs)

        def fn():
            lors = self.lms[proc].try_piggyback(keys)
            if lors is None:
                self.pg_failed.append((proc, tuple(sorted(keys))))
                return
            self.events.schedule(
                hold_ms, (lambda n=proc, ls=lors: self._finish(n, ls)),
                meta=EvMeta(kind="local", node=proc, keys=keys,
                            label=f"fin pg@{proc}"))

        self.events.schedule(at, fn, meta=EvMeta(
            kind="local", node=proc, keys=keys, label=f"pg@{proc}"))

    # -- protocol plumbing ---------------------------------------------------
    def _on_opt(self, node: int, msg) -> None:
        _, req = msg
        to_free = self.lms[node].on_opt_deliver(req)
        if to_free:
            self.gcs.ur_broadcast(
                node, ("freed", [l.key() for l in to_free]))

    def _on_to(self, node: int, msg) -> None:
        _, req = msg
        lors = self.lms[node].on_to_deliver(req)
        if req.proc == node and lors:
            if self.lms[node].is_enabled(lors):
                self._start(node, req.req_id, lors)
            else:
                self.waiters[node][req.req_id] = lors
        self._recheck(node)

    def _on_urb(self, node: int, msg) -> None:
        kind, payload = msg
        if kind == "freed":
            self.lms[node].on_ur_deliver_freed(payload)
        self._recheck(node)

    def _recheck(self, node: int) -> None:
        w = self.waiters[node]
        for rid in list(w):
            if self.lms[node].is_enabled(w[rid]):
                self._start(node, rid, w.pop(rid))

    def _start(self, node: int, req_id: int, lors) -> None:
        keys = frozenset(cc for l in lors for cc in l.ccs)
        self.events.schedule(
            self.holds.get(req_id, 1.0),
            (lambda n=node, ls=lors: self._finish(n, ls)),
            meta=EvMeta(kind="local", node=node, keys=keys,
                        label=f"fin r{req_id}@{node}"))

    def _finish(self, node: int, lors) -> None:
        to_free = self.lms[node].finished_xact(lors)
        if to_free:
            self.gcs.ur_broadcast(
                node, ("freed", [l.key() for l in to_free]))

    # -- model protocol ------------------------------------------------------
    def go(self) -> None:
        self.events.run(self.horizon, max_events=20_000)
        for lm in self.lms:
            lm.verify_full()

    def fingerprint(self) -> str:
        return digest(
            tuple(lm.protocol_state() for lm in self.lms),
            tuple(tuple(sorted(w)) for w in self.waiters),
            queue_state(self.events))

    def wedged(self) -> List[str]:
        out = []
        for n, w in enumerate(self.waiters):
            for rid in sorted(w):
                out.append(f"req {rid} awaiting enablement at node {n}")
        if not self.events.empty():
            out.append("event queue never quiesced")
        return out


def _sc_no_born_blocked(args: Dict, pol) -> LeaseHarness:
    mutant = bool(args.get("mutant", True))
    mk = ((lambda i: NoBornBlockedFGL(i, 4)) if mutant
          else (lambda i: FGLLeaseManager(i, 4)))
    h = LeaseHarness(pol, n_nodes=2, n_classes=4, mgr_factory=mk)
    # proc 0's TO-deliver of its own request races proc 1's conflicting
    # Opt-deliver at the same instant (t = 1.05 with 0.35 ms steps)
    h.request(0.0, 0, 1, (0,), hold_ms=2.0)
    h.request(0.7, 1, 2, (0,), hold_ms=1.0)
    return h


def _sc_stale_piggyback(args: Dict, pol) -> LeaseHarness:
    mutant = bool(args.get("mutant", True))
    mk = ((lambda i: StalePiggybackFGL(i, 4)) if mutant
          else (lambda i: FGLLeaseManager(i, 4)))
    h = LeaseHarness(pol, n_nodes=2, n_classes=4, mgr_factory=mk)
    h.request(0.0, 0, 1, (0,), hold_ms=3.0)   # lease granted at t = 1.05
    h.request(1.7, 1, 2, (0,), hold_ms=1.0)   # conflicting opt at t = 2.05
    h.piggyback(2.05, 0, (0,), hold_ms=2.5)   # races that opt-delivery
    return h


# --------------------------------------------------------------------------
# Smoke cells: tiny real clusters, expected violation-free
# --------------------------------------------------------------------------

def _smoke_cfg(**kw):
    from ..core.cluster import SimConfig

    base = dict(
        n_nodes=2, threads_per_node=1, n_items=32, n_classes=4,
        duration_ms=3.0, warmup_ms=0.0, drain_ms=25.0,
        # force the numpy settle/certify paths: per-schedule device dispatch
        # would dominate a model-checking run that re-executes thousands
        # of tiny simulations
        certify_jax_min=1 << 30, lease_jax_min=1 << 30,
        seed=0)
    base.update(kw)
    return SimConfig(**base)


def _sc_smoke_bank(args: Dict, pol):
    from ..core.workloads import BankWorkload
    from .explore import ClusterModel

    kw = {}
    if "jax_min" in args:
        kw.update(certify_jax_min=int(args["jax_min"]),
                  lease_jax_min=int(args["jax_min"]))
    cfg = _smoke_cfg(
        lease_mode=args.get("lease_mode", "sequential"),
        handoff=args.get("handoff", "drain"),
        duration_ms=float(args.get("duration_ms", 3.0)),
        seed=int(args.get("seed", 0)), device=_device(args), **kw)
    wl = BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items,
                      locality=float(args.get("locality", 0.5)))
    return ClusterModel(cfg, wl, pol)


def _sc_smoke_planner_failure(args: Dict, pol):
    from ..core.workloads import BankWorkload
    from ..plan import PlanConfig
    from .explore import ClusterModel

    cfg = _smoke_cfg(
        n_nodes=3, n_items=48, n_classes=6,
        duration_ms=float(args.get("duration_ms", 6.0)),
        lease_mode="sequential",
        plan=PlanConfig(epoch_ms=2.0, top_k=2, min_events=1.0, margin=0.0,
                        hysteresis_epochs=1, node_budget_bytes=1e9),
        seed=int(args.get("seed", 1)), device=_device(args))
    wl = BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items,
                      locality=float(args.get("locality", 0.7)))
    return ClusterModel(cfg, wl, pol,
                        fail_at=(float(args.get("fail_ms", 3.0)),
                                 int(args.get("fail_node", 2))))


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

SCENARIOS: Dict[str, Callable] = {
    # the ten seeded sanitizer mutants (tests/test_sanitizer_mutants.py)
    "mutant-skipped-epoch-bump": _sc_skipped_epoch_bump,
    "mutant-drain-prefetch-non-head": _sc_drain_prefetch_non_head,
    "mutant-view-change-overpurge": _sc_view_change_overpurge,
    "mutant-double-grant": _sc_double_grant,
    "mutant-stale-write-locks": _sc_stale_write_locks,
    "mutant-leased-away-write": _sc_leased_away_write,
    "mutant-recycled-sid": _sc_recycled_sid,
    "mutant-free-active-lease": _sc_free_active_lease,
    "mutant-forged-free": _sc_forged_free,
    "mutant-enabled-mask-flip": _sc_enabled_mask_flip,
    # schedule-dependent mutants only the explorer can catch
    "mutant-no-born-blocked": _sc_no_born_blocked,
    "mutant-stale-piggyback": _sc_stale_piggyback,
    # CI smoke cells
    "smoke-bank": _sc_smoke_bank,
    "smoke-planner-failure": _sc_smoke_planner_failure,
}

# the invariant each mutant's counterexample must name (None: any)
MUTANT_INVARIANTS: Dict[str, str] = {
    "mutant-skipped-epoch-bump": "owner-at-drain",
    "mutant-drain-prefetch-non-head": "prefetch-head",
    "mutant-view-change-overpurge": "conservation",
    "mutant-double-grant": "single-owner",
    "mutant-stale-write-locks": "write-locks",
    "mutant-leased-away-write": "write-locks",
    "mutant-recycled-sid": "epoch-monotonicity",
    "mutant-free-active-lease": "blocked-and-drained",
    "mutant-forged-free": "conservation",
    "mutant-enabled-mask-flip": "enabled-divergence",
    "mutant-no-born-blocked": "quiescence",
    "mutant-stale-piggyback": "blocked-and-drained",
}


def get_scenario(name: str) -> Callable:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
