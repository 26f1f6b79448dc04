"""Discrete-event simulator of a Lilac-TM / ALC replicated cluster.

This is the faithful reproduction vehicle: N replicas, each with a local STM
(TL2-style versioned store), a lease manager (coarse ALC or fine-grained FGL),
a replication manager, the Transaction Forwarder and the DTD, driven by a
deterministic event queue and the simulated GCS (OAB/URB/p2p with the paper's
communication-step latency model).

Algorithm variants (paper §4) are obtained by configuration:

=============  ==========  ================
variant        lease_kind  dtd.policy
=============  ==========  ================
ALC            alc         local
FGL            fgl         local
MG-ALC         alc         opt
LILAC-TM-ST    fgl         short
LILAC-TM-LT    fgl         long
LILAC-TM-OPT   fgl         opt
=============  ==========  ================

Threads are closed-loop load generators: each of ``threads_per_node`` worker
threads executes one transaction at a time, blocks through its commit phase,
then starts the next — matching the paper's 2/4-threads-per-node runs.
Execution (and forwarded re-execution) consumes a CPU slot at the executing
node; slot occupancy feeds the CPU_i statistic used by constraint (3).

The port runs each replica's version table and batched certification on
``SimConfig.device`` (the card by default): a drain flushes the replica's
written versions, checks write items against the lease layer's class
owners and certifies, in one kernel launch.  The host-side protocol is the
reference's, verdict for verdict.  The proactive placement planner
(``SimConfig.plan``) scores its lease moves on the same device.  The
sanitizer and explorer hooks of the reference belong to a later slice.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .conflict import ConflictClassMap
from .dtd import DTD, DTDConfig
from .events import EventQueue
from .forwarder import CommitNotice, ForwardPolicy, ForwardRequest
from .gcs import GCSLatency, SimGCS
from .lease import ALCLeaseManager, FGLLeaseManager, LeaseRequest, LOR
from .stats import CpuMeter, DecayedFrequency
from .stm import ClassLocks, Transaction, VersionedStore, validate_batch


# --------------------------------------------------------------------------
# Workload interface
# --------------------------------------------------------------------------

@dataclass
class TxnSpec:
    """A transaction's logic + static footprint, as sampled by a workload.

    ``execute(store, stm_txn)`` performs the reads/writes (and is re-invoked
    on re-execution, reading fresh values); ``items`` is the item footprint
    used for conflict-class mapping (stable across re-executions, as in the
    Bank/TPC-C benchmarks where the data-set is determined by the input
    parameters).
    """

    execute: Callable[[VersionedStore, Transaction], float]
    items: Tuple[int, ...]
    read_only: bool = False
    opt_hint: int = -1
    exec_ms: Optional[float] = None


class Workload:
    def sample(self, node: int, rng: np.random.Generator) -> TxnSpec:
        raise NotImplementedError


# --------------------------------------------------------------------------
# Simulation config & metrics
# --------------------------------------------------------------------------

@dataclass
class SimConfig:
    n_nodes: int = 4
    threads_per_node: int = 2
    n_items: int = 4096
    n_classes: int = 256
    lease_kind: str = "fgl"               # "fgl" | "alc"
    dtd: DTDConfig = field(default_factory=lambda: DTDConfig(policy="local"))
    # Calibrated regime (EXPERIMENTS.md §Calibration): communication-
    # dominated, as in the paper's Gigabit-Ethernet cluster — short in-memory
    # transactions (tens of us), ~0.35 ms per communication step, OAB
    # sequencer serialization 0.3 ms/message.
    latency: GCSLatency = field(
        default_factory=lambda: GCSLatency(step_ms=0.35, oab_serialize_ms=0.3)
    )
    exec_ms: float = 0.03                  # mean RW execution time
    ro_exec_ms: float = 0.02               # mean read-only execution time
    validate_ms: float = 0.005
    local_commit_ms: float = 0.002
    msg_proc_ms: float = 0.01      # outbound protocol processing (dilates under load)
    think_ms: float = 0.005
    duration_ms: float = 2000.0
    warmup_ms: float = 200.0
    drain_ms: float = 200.0
    stats_update_ms: float = 5.0           # staleness of piggybacked stats
    forward: ForwardPolicy = field(default_factory=ForwardPolicy)
    seed: int = 0
    init_value: float = 1000.0
    # "batched": enabled transactions whose commit-phase slots fire within
    # the same drain window are certified in ONE vectorized validate_batch
    # call (the default pipeline); "sequential" is the per-transaction python
    # loop, retained as the equivalence-test oracle.
    certify_mode: str = "batched"
    # Coalescing window for the certification drain.  0.0 (default) drains at
    # the same simulated instant the commit-phase slots fire — bit-identical
    # to the sequential path.  > 0 defers the verdict by up to this much to
    # grow batches (leases are held across the window, so safety is
    # unchanged; commit latency takes the hit) — the knob that lets the
    # simulator run node/thread counts an order of magnitude past the
    # paper's 4-node cluster without the python certification loop
    # dominating wall-clock.
    certify_window_ms: float = 0.0
    # Batches below this size settle verdicts with the numpy loop (device
    # dispatch overhead would swamp a near-empty batch); at or above it the
    # packed arrays go through kernels.ops on ``device`` (the CUDA kernel on
    # the card, the torch twin on the CPU).  The two agree bitwise — tests
    # force this to 1 to pin the vectorized path against the sequential
    # oracle.
    certify_jax_min: int = 8
    # Lease control plane.  "batched" (default, FGL only): the replicated
    # conflict-queue state lives in the sharded array-backed manager
    # (repro_torch.core.lease_batched) — lease_shards owner shards by class hash,
    # queue mutations as vectorized scatters, waiter/prefetch enablement
    # settled per delivery instant through kernels.ops.settle_lease_batch
    # once an instant packs >= lease_jax_min groups (numpy row math below,
    # same verdicts).  "sequential" keeps the per-class python queues
    # (LeaseManagerBase) as the byte-identical oracle; ALC always uses it
    # (coarse multi-class LORs don't fit the one-LOR-per-class layout).
    lease_mode: str = "batched"
    lease_shards: int = 8
    lease_jax_min: int = 64
    # Ownership handoff.  "pipelined" (default) is the Zeus-style overlap:
    # the footprint is known at start (spec.items), so when the DTD would
    # keep the transaction local its lease request is OA-broadcast *at
    # start* and the request round + the owner's in-flight commit drain
    # overlap the transaction's own execution; commit certification still
    # waits for both execution and enablement, so safety is untouched (the
    # explorer's CI grid model-checks both handoffs violation-free, and
    # benchmarks/handoff.py pins pipelined >= drain across the locality x
    # contention grid).  "drain" is the paper's ordering — execute, then
    # request leases, then wait for the owner's LORs to drain — kept as
    # the fallback knob and the oracle for the overlap's equivalence tests.
    handoff: str = "pipelined"
    # Commit-phase slot cost.  "amortized" (default, batched mode only):
    # the group of transactions enabled together occupies ONE worker slot
    # for cert_fixed_ms + len(group) * cert_per_txn_ms — simulated
    # throughput, not just simulator wall-clock, reflects that the batched
    # pipeline certifies the group in one kernel dispatch.  "per_txn": every
    # transaction occupies its own slot for validate_ms + local_commit_ms —
    # always used by the sequential oracle, and forced by the equivalence
    # test to pin the batched drain as a pure vectorization.
    cert_slot_mode: str = "amortized"
    cert_fixed_ms: Optional[float] = None     # default: validate_ms
    cert_per_txn_ms: Optional[float] = None   # default: local_commit_ms
    # Proactive placement planner (repro_torch.plan): score affinity-driven
    # lease moves every plan.epoch_ms of simulated time, on ``device``, and
    # execute them as background prefetch requests through the lease
    # managers (None = off).
    plan: Optional["PlanConfig"] = None  # noqa: F821 (repro_torch.plan)
    # The reference's lease-protocol sanitizer and schedule-space explorer.
    # Not ported yet: setting either raises NotImplementedError rather than
    # being ignored.
    sanitize: bool = False
    explore: Optional[object] = None
    # Structured tracing (repro_torch.obs): record lease rounds, forwards,
    # aborts, certify batches, and planner epochs as sim-time-stamped
    # spans/instants on per-node tracks, exportable to Perfetto via
    # ``Cluster.trace.export(path)``.  Stamps come from the event queue's
    # virtual clock, so a traced run is byte-identical to an untraced one
    # (asserted in tests/test_obs.py) and two seeded runs export
    # byte-identical JSON.
    trace: bool = False
    # Where the version tables, write locks and certification kernel live:
    # "cuda" (default) or "cpu".  "cuda" without a card raises.
    device: str = "cuda"


@dataclass
class Metrics:
    commits: int = 0
    ro_commits: int = 0
    rw_commits: int = 0
    aborts: int = 0
    forwards: int = 0
    lease_requests: int = 0
    piggybacks: int = 0
    rw_certified: int = 0
    cert_batches: int = 0          # batched validate_batch drains issued
    cert_batch_txns: int = 0       # transactions certified through them
    plan_epochs: int = 0           # planner invocations
    plan_prefetches: int = 0       # background lease prefetches issued
    commit_times: List[Tuple[float, int]] = field(default_factory=list)
    commit_latency_sum: float = 0.0

    def throughput(self, t0: float, t1: float) -> float:
        """Committed txns per second within [t0, t1) of simulated time."""
        n = sum(1 for (t, _) in self.commit_times if t0 <= t < t1)
        return n / max(1e-9, (t1 - t0)) * 1e3

    def lease_reuse_rate(self) -> float:
        """Paper Fig. 3(b): piggybacked RW txns / total RW txns certified."""
        return self.piggybacks / max(1, self.rw_certified)


# --------------------------------------------------------------------------
# Per-replica state
# --------------------------------------------------------------------------

class Replica:
    def __init__(self, node: int, cfg: SimConfig,
                 device: torch.device) -> None:
        self.node = node
        self.cfg = cfg
        if cfg.lease_mode not in ("batched", "sequential"):
            raise ValueError(f"unknown lease_mode {cfg.lease_mode!r}")
        if cfg.lease_kind == "fgl" and cfg.lease_mode == "batched":
            from .lease_batched import ShardedLeaseManager

            self.lm = ShardedLeaseManager(
                node, cfg.n_classes, n_shards=cfg.lease_shards,
                jax_min=cfg.lease_jax_min, device=device)
        elif cfg.lease_kind == "fgl":
            self.lm = FGLLeaseManager(node, cfg.n_classes)
        else:
            self.lm = ALCLeaseManager(node, cfg.n_classes)
        self.store = VersionedStore(cfg.n_items, cfg.init_value, device)
        self.freq = DecayedFrequency(cfg.n_nodes, cfg.n_classes)
        self.cpu_view = np.zeros((cfg.n_nodes,), dtype=np.float64)
        self.meter = CpuMeter(cfg.threads_per_node)
        self.free_slots = cfg.threads_per_node
        self.slot_queue: deque = deque()
        self.slowdown = 1.0  # CPU-contention multiplier on processing times
        self.waiters: List[Tuple["SimTxn", List[LOR]]] = []
        self.pending_reqs: Dict[int, "SimTxn"] = {}
        # batched certification: commit-phase slots that fired but whose
        # verdict is settled by the next drain event (same instant)
        self.certify_queue: List["SimTxn"] = []
        self.certify_pending = False
        # lease prefetches awaiting their LORs heading every queue: the
        # drain to activeXacts=0 must only happen at the head, preserving
        # the protocol invariant (drained => enabled) the free rules rely on
        self.prefetch_waiters: List[List[LOR]] = []


@dataclass
class SimTxn:
    txid: int
    origin: int
    thread: int
    spec: TxnSpec
    ccs: FrozenSet[int]
    t_start: float
    stm: Transaction
    lors: List[LOR] = field(default_factory=list)
    exec_node: int = -1
    reexecs: int = 0
    forwards: int = 0
    reused: bool = False
    result: float = 0.0
    # pipelined handoff (SimConfig.handoff="pipelined"): the lease round
    # was issued at start; commit joins on (execution done AND LORs held)
    early: bool = False
    exec_done: bool = False


# --------------------------------------------------------------------------
# The cluster
# --------------------------------------------------------------------------

class Cluster:
    def __init__(self, cfg: SimConfig, workload: Workload, ccmap=None) -> None:
        for name in ("sanitize", "explore"):
            if getattr(cfg, name) not in (None, False):
                raise NotImplementedError(
                    f"SimConfig.{name} is not ported yet: it comes with "
                    f"the runtime-analysis slice of the port (ROADMAP "
                    f"queue 1 item 7)")
        self.device = resolve_device(cfg.device)
        self.cfg = cfg
        self.workload = workload
        self.events = EventQueue()
        # repro_torch.obs recorder (None when off: every site is one dead
        # branch)
        self.trace = None
        if cfg.trace:
            from ..obs.trace import TraceRecorder

            self.trace = TraceRecorder()
        self.gcs = SimGCS(self.events, cfg.n_nodes, cfg.latency)
        self.ccmap = ccmap or ConflictClassMap(
            cfg.n_classes, stride=max(1, cfg.n_items // cfg.n_classes)
        )
        self.replicas = [Replica(i, cfg, self.device)
                         for i in range(cfg.n_nodes)]
        self.dtd = DTD(cfg.dtd, cfg.n_nodes)
        self.metrics = Metrics()
        self.rngs = [np.random.default_rng(cfg.seed * 1000 + i) for i in range(cfg.n_nodes)]
        self._txid = itertools.count(1)
        self._reqid = itertools.count(1)
        self._stopped = False
        self._inflight: Dict[int, SimTxn] = {}
        # item -> conflict class, from which a drain's write check reads
        # the lease layer's ownership; built once, and kept on the device
        # as int32 (4.6 MB at TPC-C's 1.14 M items, L2-resident) so a drain
        # hands over only the class owners
        if hasattr(self.ccmap, "of_item"):
            self._item_cc = np.fromiter(
                (self.ccmap.of_item(i) for i in range(cfg.n_items)),
                np.int32, count=cfg.n_items)
            if self._item_cc.size and not (
                    0 <= self._item_cc.min()
                    and self._item_cc.max() < cfg.n_classes):
                raise ValueError(
                    f"the conflict map sends items to classes outside "
                    f"[0, {cfg.n_classes}) (n_classes)")
            self._item_cc_dev = torch.from_numpy(self._item_cc).to(
                self.device)
        else:
            self._item_cc = None
            self._item_cc_dev = None
        # proactive placement planner (repro_torch.plan): a global control
        # loop with the same piggybacked-staleness view the DTD gets
        self.planner = None
        if cfg.plan is not None:
            from ..plan import PlacementPlanner

            self.planner = PlacementPlanner(
                cfg.n_nodes, cfg.n_classes, cfg.plan,
                track_co=cfg.plan.co_gain > 0.0, device=self.device)
        self.t_throughput: List[Tuple[float, int, int]] = []  # (t, node, 1)
        for i in range(cfg.n_nodes):
            self.gcs.on_opt[i] = self._make_handler(i, self._on_opt)
            self.gcs.on_to[i] = self._make_handler(i, self._on_to)
            self.gcs.on_urb[i] = self._make_handler(i, self._on_urb)
            self.gcs.on_p2p[i] = self._make_handler(i, self._on_p2p)
            self.gcs.on_view_change[i] = (
                lambda view, failed, n=i: self._on_view_change(n, view, failed)
            )

    def _make_handler(self, node: int, fn):
        return lambda msg, sender, n=node, f=fn: f(n, msg, sender)

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> Metrics:
        cfg = self.cfg
        for node in range(cfg.n_nodes):
            for thread in range(cfg.threads_per_node):
                self.events.schedule(0.0, (lambda n=node, t=thread: self._start_txn(n, t)))
        self._schedule_stats_sync()
        if self.planner is not None:
            self._schedule_plan_epoch()
        self.events.run(cfg.duration_ms)
        self._stopped = True
        self.events.run(cfg.duration_ms + cfg.drain_ms)
        return self.metrics

    def load_state(self, values: np.ndarray, versions: np.ndarray,
                   clock: int) -> None:
        """Start every replica from the given store state (e.g. a reference
        replica's ``values``/``versions``/``clock``, as numpy arrays)."""
        for r in self.replicas:
            r.store = VersionedStore.from_numpy(
                values, versions, self.device, clock=clock,
                init_value=self.cfg.init_value)

    def throughput(self) -> float:
        return self.metrics.throughput(self.cfg.warmup_ms, self.cfg.duration_ms)

    def wedged(self) -> List[str]:
        """Stuck protocol work, for the explorer's quiescence check.

        Meaningful once the event queue has drained with ``_stopped`` set:
        the closed loop schedules nothing new, so any surviving in-flight
        transaction or waiter can only be waiting on a protocol event that
        will never come — a lease circulation deadlock no per-event
        invariant check can see.  Transactions originated by a failed
        member are excluded (fail-stop: nobody restarts them).
        """
        out: List[str] = []
        for txid in sorted(self._inflight):
            txn = self._inflight[txid]
            if self.gcs.alive(txn.origin):
                out.append(f"txn {txid} in-flight (origin {txn.origin}, "
                           f"exec {txn.exec_node})")
        for r in self.replicas:
            if not self.gcs.alive(r.node):
                continue
            for (txn, lors) in r.waiters:
                ccs = sorted({cc for l in lors for cc in l.ccs})
                out.append(f"txn {txn.txid} awaiting enablement of "
                           f"{ccs} at node {r.node}")
            if r.prefetch_waiters:
                out.append(f"{len(r.prefetch_waiters)} prefetch group(s) "
                           f"never headed their queues at node {r.node}")
        return out

    def _schedule_stats_sync(self) -> None:
        def sync():
            if self._stopped:
                return
            t = self.events.now
            truth = np.array(
                [
                    r.meter.utilization(t) if self.gcs.alive(r.node) else 1.0
                    for r in self.replicas
                ]
            )
            for r in self.replicas:
                r.cpu_view[:] = truth
            self.events.schedule(self.cfg.stats_update_ms, sync)

        self.events.schedule(self.cfg.stats_update_ms, sync)

    # -- proactive placement (repro_torch.plan) -------------------------------
    def _schedule_plan_epoch(self) -> None:
        def epoch():
            if self._stopped:
                return
            self._run_plan_epoch()
            self.events.schedule(self.cfg.plan.epoch_ms, epoch)

        self.events.schedule(self.cfg.plan.epoch_ms, epoch)

    def _run_plan_epoch(self) -> None:
        """Score all [class, node] lease moves in one evaluation on the
        cluster's device and issue the bounded plan as background prefetch
        requests.

        A planned move costs one lease round (OAB request + URB free) *off*
        any transaction's critical path; once the prefetched LOR heads its
        queue, transactions at the target piggyback on it and the forward /
        lease round-trip they used to pay disappears.  Safety is untouched:
        the move is an ordinary lease request through the replicated
        conflict queues.
        """
        from .dtd import C_AB, C_P2P, C_URB

        alive = [i for i in range(self.cfg.n_nodes) if self.gcs.alive(i)]
        if not alive:
            return
        self.metrics.plan_epochs += 1
        coord = self.replicas[alive[0]]
        n_cls = self.cfg.n_classes
        owner = coord.lm.owner_np().astype(np.int32)
        # a lease prefetch ships no state (write-sets replicate via URB
        # regardless of ownership) — costs are the paper's step constants
        step = self.cfg.latency.step_ms
        fwd_cost = np.full((n_cls,), (C_P2P + C_URB) * step)
        move_cost = np.full((n_cls,), (C_AB + C_URB) * step)
        plan = self.planner.plan(
            self.events.now, owner, np.zeros((n_cls,)), fwd_cost, move_cost,
            coord.cpu_view)
        executed = []
        for mv in plan.moves:
            if not self.gcs.alive(mv.dst):
                continue
            dlm = self.replicas[mv.dst].lm
            if dlm.has_unblocked(mv.cc, mv.dst):
                continue                 # dst already holds / awaits it
            req = LeaseRequest(
                req_id=next(self._reqid), proc=mv.dst, ccs=(mv.cc,),
                coarse=(self.cfg.lease_kind == "alc"), prefetch=True)
            self.metrics.plan_prefetches += 1
            self.gcs.oa_broadcast(mv.dst, ("lease", req))
            executed.append(mv)
        self.planner.committed(executed)
        tr = self.trace
        if tr is not None:
            tr.span("plan-epoch", "plan", self.events.now, 0.0,
                    moves=len(executed))
            for mv in executed:
                tr.instant("plan-prefetch", "plan", ts=self.events.now,
                           cc=mv.cc, dst=mv.dst)

    # -- CPU slots -------------------------------------------------------------
    def _request_slot(self, node: int, fn: Callable[[], None]) -> None:
        r = self.replicas[node]
        if r.free_slots > 0:
            r.free_slots -= 1
            r.meter.acquire(self.events.now)
            fn()
        else:
            r.slot_queue.append(fn)

    def _release_slot(self, node: int) -> None:
        r = self.replicas[node]
        r.meter.release(self.events.now)
        if r.slot_queue:
            nxt = r.slot_queue.popleft()
            r.meter.acquire(self.events.now)
            self.events.schedule(0.0, nxt)
        else:
            r.free_slots += 1

    def inject_load(
        self, node: int, extra_load: float, slowdown: float, seize_slots: int = 0
    ) -> None:
        """Inject background CPU-intensive jobs (overload experiment, Fig 3c).

        External jobs contend for the node's cores: ``seize_slots`` worker
        slots are occupied outright, every remaining processing step at the
        node (execution, re-execution, validation, commit processing, and the
        protocol work of disseminating commits / lease releases) dilates by
        ``slowdown``, and the node's reported CPU utilization rises by
        ``extra_load`` (which is what constraint (3) reads).
        """
        r = self.replicas[node]
        r.slowdown = slowdown
        for _ in range(seize_slots):
            self._request_slot(node, lambda: None)  # held for the run
        r.meter.extra_load = extra_load

    def _send_cost_ms(self, node: int) -> float:
        """Outbound protocol-processing time (serialization, URB handoff).

        Dilated by the node's CPU contention: an overloaded node is slow to
        release leases and to disseminate write-sets, which is a large part
        of why uninformed migration towards it hurts (Fig 3c).
        """
        r = self.replicas[node]
        return self.cfg.msg_proc_ms * r.slowdown

    def _ur_broadcast_from(self, node: int, msg) -> None:
        d = self._send_cost_ms(node)
        if d <= 0:
            self.gcs.ur_broadcast(node, msg)
        else:
            self.events.schedule(d, lambda: self.gcs.ur_broadcast(node, msg))

    # -- transaction lifecycle --------------------------------------------------
    def _start_txn(self, node: int, thread: int) -> None:
        if self._stopped or not self.gcs.alive(node):
            return
        rng = self.rngs[node]
        spec = self.workload.sample(node, rng)
        txn = SimTxn(
            txid=next(self._txid),
            origin=node,
            thread=thread,
            spec=spec,
            ccs=self.ccmap.get_conflict_classes(spec.items),
            t_start=self.events.now,
            stm=Transaction(txid=0, origin=node),
        )
        txn.stm.txid = txn.txid
        mean = spec.exec_ms or (self.cfg.ro_exec_ms if spec.read_only else self.cfg.exec_ms)
        dur = float(rng.exponential(mean) * 0.5 + mean * 0.5)  # bounded jitter
        dur *= self.replicas[node].slowdown
        if self.cfg.handoff == "pipelined" and not spec.read_only:
            self._early_acquire(txn, node)
        self._request_slot(node, lambda: self.events.schedule(dur, lambda: self._exec_done(txn, node)))

    def _early_acquire(self, txn: SimTxn, node: int) -> None:
        """Zeus-style pipelined handoff: issue the lease round at start.

        The footprint is known from ``spec.items`` before execution, so
        when the DTD verdict is "certify locally" the OAB request round and
        the current owner's in-flight commit drain run *under* this
        transaction's execution instead of after it.  When the DTD wants to
        migrate the work, the reactive request-after-execute path is kept —
        acquiring remotely-homed classes early would fight the forwarder.
        """
        r = self.replicas[node]
        target = self.dtd.decide(
            origin=node,
            ccs=txn.ccs,
            lease_owner_of_cc=r.lm.head_owner,
            freq_rates=r.freq.rates(self.events.now),
            cpu=r.cpu_view,
            opt_hint=txn.spec.opt_hint,
        )
        if (target != node and self.gcs.alive(target)
                and self.cfg.forward.may_forward(txn.forwards)):
            return
        txn.early = True
        txn.exec_node = node
        self._inflight[txn.txid] = txn
        tr = self.trace
        lors = r.lm.try_piggyback(txn.ccs)
        if lors is not None:
            txn.reused = True
            self.metrics.piggybacks += 1
            txn.lors = lors
            if tr is not None:
                tr.instant("lease-piggyback", f"node{node}/lease",
                           ts=self.events.now, txid=txn.txid)
            return
        req = LeaseRequest(
            req_id=next(self._reqid),
            proc=node,
            ccs=tuple(sorted(txn.ccs)),
            coarse=(self.cfg.lease_kind == "alc"),
        )
        r.lm.n_requests += 1
        self.metrics.lease_requests += 1
        r.pending_reqs[req.req_id] = txn
        if tr is not None:
            # closed by _on_to when the TO-delivery grants the LORs; async
            # span because rounds from the node's threads overlap freely
            tr.abegin("lease-round", f"node{node}/lease", req.req_id,
                      ts=self.events.now, txid=txn.txid, ccs=len(req.ccs))
        self.gcs.oa_broadcast(node, ("lease", req))

    def _exec_done(self, txn: SimTxn, node: int) -> None:
        r = self.replicas[node]
        txn.stm = Transaction(txid=txn.txid, origin=txn.origin)
        txn.result = txn.spec.execute(r.store, txn.stm)
        self._release_slot(node)
        txn.exec_done = True
        tr = self.trace
        if tr is not None:
            tr.span("exec", f"node{node}/t{txn.thread}", txn.t_start,
                    self.events.now - txn.t_start, txid=txn.txid)
        if txn.spec.read_only:
            self.events.schedule(
                self.cfg.local_commit_ms, lambda: self._txn_done(txn, committed=True)
            )
            return
        if txn.early:
            # pipelined handoff: the lease round ran under execution; enter
            # the commit phase now if the LORs are already held, else the
            # pending TO-deliver joins (_on_to sees exec_done)
            self.metrics.rw_certified += 1
            if txn.lors:
                self._wait_enabled(txn, node)
            return
        self._dispatch(txn, node)

    # -- DTD dispatch -------------------------------------------------------------
    def _dispatch(self, txn: SimTxn, node: int) -> None:
        self._inflight[txn.txid] = txn
        r = self.replicas[node]
        target = self.dtd.decide(
            origin=node,
            ccs=txn.ccs,
            lease_owner_of_cc=r.lm.head_owner,
            freq_rates=r.freq.rates(self.events.now),
            cpu=r.cpu_view,
            opt_hint=txn.spec.opt_hint,
        )
        if target != node and self.gcs.alive(target) and self.cfg.forward.may_forward(txn.forwards):
            txn.forwards += 1
            self.metrics.forwards += 1
            tr = self.trace
            if tr is not None:
                tr.instant("forward", f"node{node}/dtd", ts=self.events.now,
                           txid=txn.txid, target=target)
            if self.planner is not None:
                # the planner's target signal: work shipped away from origin
                self.planner.affinity.record_forward(
                    self.events.now, node, txn.ccs)
            # record the forward target NOW: if it fails while the message is
            # in flight (the GCS drops p2p to dead nodes), the view-change
            # handler must still see exec_node == failed to restart this
            # transaction — waiting for the target's _certify to set it would
            # wedge the originating thread forever
            txn.exec_node = target
            self.gcs.p2p_send(
                node,
                target,
                ("forward", txn),
            )
        else:
            self._certify(txn, node)

    # -- certification (replication manager) ----------------------------------------
    def _certify(self, txn: SimTxn, node: int) -> None:
        txn.exec_node = node
        r = self.replicas[node]
        self.metrics.rw_certified += 1
        tr = self.trace
        lors = r.lm.try_piggyback(txn.ccs)
        if lors is not None:
            txn.reused = True
            self.metrics.piggybacks += 1
            txn.lors = lors
            if tr is not None:
                tr.instant("lease-piggyback", f"node{node}/lease",
                           ts=self.events.now, txid=txn.txid)
            self._wait_enabled(txn, node)
        else:
            req = LeaseRequest(
                req_id=next(self._reqid),
                proc=node,
                ccs=tuple(sorted(txn.ccs)),
                coarse=(self.cfg.lease_kind == "alc"),
            )
            r.lm.n_requests += 1
            self.metrics.lease_requests += 1
            r.pending_reqs[req.req_id] = txn
            if tr is not None:
                tr.abegin("lease-round", f"node{node}/lease", req.req_id,
                          ts=self.events.now, txid=txn.txid,
                          ccs=len(req.ccs))
            self.gcs.oa_broadcast(node, ("lease", req))

    def _wait_enabled(self, txn: SimTxn, node: int) -> None:
        r = self.replicas[node]
        r.waiters.append((txn, txn.lors))
        self._check_waiters(node)

    def _check_waiters(self, node: int) -> None:
        r = self.replicas[node]
        if r.prefetch_waiters:
            self._settle_prefetches(node)
        still: List[Tuple[SimTxn, List[LOR]]] = []
        ready: List[SimTxn] = []
        # one vectorized isEnabled settle over every waiting commit phase
        # (the sequential oracle's enabled_mask is the per-group loop)
        enabled = r.lm.enabled_mask([lors for (_txn, lors) in r.waiters])
        for (txn, lors), ok in zip(r.waiters, enabled):
            if ok:
                ready.append(txn)
            else:
                still.append((txn, lors))
        r.waiters = still
        if not ready:
            return
        cfg = self.cfg
        if cfg.certify_mode == "batched" and cfg.cert_slot_mode == "amortized":
            # PR-4's pipeline certifies the whole enabled group in ONE
            # kernel dispatch, so the commit phase is one core's work:
            # a single slot charges fixed + per-txn increment for the group
            # instead of every transaction paying the full
            # validate+commit on its own slot — simulated throughput, not
            # just simulator wall-clock, reflects the batching
            fixed = cfg.cert_fixed_ms if cfg.cert_fixed_ms is not None \
                else cfg.validate_ms
            per_txn = cfg.cert_per_txn_ms if cfg.cert_per_txn_ms is not None \
                else cfg.local_commit_ms
            dur = (fixed + per_txn * len(ready)) * r.slowdown

            def start(group=tuple(ready), d=dur):
                def fin():
                    self._release_slot(node)
                    for t in group:
                        self._enqueue_certify(t, node)
                self.events.schedule(d, fin)

            self._request_slot(node, start)
            return
        for txn in ready:
            # certification + commit processing is CPU work at the executing
            # node: occupy a worker slot for its (dilated) duration, so an
            # overloaded node's commit phase queues behind the external jobs
            dur = (cfg.validate_ms + cfg.local_commit_ms) * r.slowdown

            def start(t=txn, d=dur):
                def fin():
                    self._release_slot(node)
                    if cfg.certify_mode == "batched":
                        self._enqueue_certify(t, node)
                    else:
                        self._validate_and_commit(t, node)
                self.events.schedule(d, fin)

            self._request_slot(node, start)

    def _settle_prefetches(self, node: int) -> None:
        """Drain prefetched LORs that now head every queue they touch.

        A prefetch carries no transaction, so its LOR must end at
        activeXacts=0 to be freeable — but draining it while still queued
        behind another owner would create a dormant *non-head* LOR that no
        protocol event ever frees (the blocked-and-drained rule only fires
        at the head), wedging the class.  So the drain waits for
        ``is_enabled``, exactly like a transaction's commit phase: at the
        head, a drained unblocked LOR is the protocol's ordinary dormant
        state (piggybackable; freed the moment a conflicting request blocks
        it), and one blocked while waiting is freed here as it drains.
        """
        r = self.replicas[node]
        still: List[List[LOR]] = []
        to_free: List[LOR] = []
        enabled = r.lm.enabled_mask(r.prefetch_waiters)
        for lors, ok in zip(r.prefetch_waiters, enabled):
            if ok:
                to_free.extend(r.lm.finished_xact(lors))
            else:
                still.append(lors)
        r.prefetch_waiters = still
        if to_free:
            self._ur_broadcast_from(node, ("freed", [l.key() for l in to_free]))

    # -- batched certification drain ------------------------------------------
    def _enqueue_certify(self, txn: SimTxn, node: int) -> None:
        """Queue a commit-phase-complete transaction for the batch drain.

        All commit-phase slots armed by one ``_check_waiters`` call share the
        same duration, so they land here at the same instant; the drain event
        (scheduled at zero delay, i.e. after every same-instant fin) packs
        them into one ``validate_batch`` dispatch.
        """
        r = self.replicas[node]
        r.certify_queue.append(txn)
        if not r.certify_pending:
            r.certify_pending = True
            self.events.schedule(
                self.cfg.certify_window_ms, lambda: self._drain_certify(node))

    def _class_locks(self, node: int) -> Optional[ClassLocks]:
        """The lease layer's ownership view for a drain's write check.

        An item is write-locked at ``node`` when its conflict class is
        currently leased to a *different* replica.  Enabled transactions head
        every queue they touch, so a lock conflict here means the batch was
        fed a transaction the lease layer never enabled — the kernel turns
        that protocol violation into an abort instead of a silent pass.
        The drain applies :meth:`_write_locks`' rule to its write slots
        only; None without an item -> class map (every write check passes).
        """
        if self._item_cc_dev is None:
            return None
        return ClassLocks(self._item_cc_dev,
                          self.replicas[node].lm.owner_np(), node)

    def _write_locks(self, node: int) -> Optional[torch.Tensor]:
        """Per-item write-lock state from the lease layer's ownership view
        (the reference's form, ``repro.core.cluster.Cluster._write_locks``).

        Derived on the device: only the ``n_classes`` owners are uploaded,
        and the per-item gather runs against the device ``item -> class``
        table built at construction.
        """
        if self._item_cc_dev is None:
            return None
        owners = torch.from_numpy(self.replicas[node].lm.owner_np()).to(
            self.device)
        per_item = owners[self._item_cc_dev]
        return ((per_item >= 0) & (per_item != node)).to(torch.int32)

    def _locked_write(self, txn: SimTxn, node: int) -> bool:
        """Per-txn twin of the kernels' lock check (small-batch path)."""
        if self._item_cc is None:
            return False
        lm = self.replicas[node].lm
        for item in txn.stm.write_set:
            owner = lm.head_owner(int(self._item_cc[item]))
            if owner >= 0 and owner != node:
                return True
        return False

    def _drain_certify(self, node: int) -> None:
        r = self.replicas[node]
        r.certify_pending = False
        batch, r.certify_queue = r.certify_queue, []
        if not batch:
            return
        if len(batch) >= self.cfg.certify_jax_min:
            ok = validate_batch(r.store, [t.stm for t in batch],
                                class_locks=self._class_locks(node))
        else:
            # near-empty batch: device dispatch overhead would dominate —
            # the numpy loop settles the same verdicts, including the lock
            # check, so a protocol violation aborts regardless of how many
            # transactions happened to share the drain instant
            ok = [r.store.validate(t.stm) and not self._locked_write(t, node)
                  for t in batch]
        self.metrics.cert_batches += 1
        self.metrics.cert_batch_txns += len(batch)
        # Intra-batch serialization: the one-at-a-time path applies each
        # commit before validating the next, so a transaction reading an item
        # written by an earlier committer in the same batch must abort (the
        # earlier commit stamped a fresh txid, which can never equal the
        # snapshot version).  Writes are resolved by the single apply_batch.
        written: set = set()
        verdicts: List[bool] = []
        committers: List[SimTxn] = []
        for t, o in zip(batch, ok):
            good = bool(o) and not any(
                it in written for it in t.stm.read_items)
            verdicts.append(good)
            if good:
                written.update(t.stm.write_set)
                committers.append(t)
        if committers:
            r.store.apply_batch(
                [t.stm.write_set for t in committers],
                [t.txid for t in committers])
        tr = self.trace
        if tr is not None:
            tr.span("certify-batch", f"node{node}/cert", self.events.now,
                    0.0, batch=len(batch),
                    aborts=len(batch) - len(committers))
        for t, good in zip(batch, verdicts):
            if good:
                self._commit_applied(t, node)
            else:
                self._certify_failed(t, node)

    def _validate_and_commit(self, txn: SimTxn, node: int) -> None:
        """One-at-a-time certification — the batched drain's test oracle."""
        r = self.replicas[node]
        if r.store.validate(txn.stm):
            self._commit(txn, node)
        else:
            self._certify_failed(txn, node)

    def _certify_failed(self, txn: SimTxn, node: int) -> None:
        r = self.replicas[node]
        self.metrics.aborts += 1
        tr = self.trace
        if tr is not None:
            tr.instant("abort", f"node{node}/dtd", ts=self.events.now,
                       txid=txn.txid)
        if self.planner is not None:
            # contention at the executing node damps its affinity
            self.planner.affinity.record_abort(self.events.now, node, txn.ccs)
        txn.reexecs += 1
        if txn.reexecs > self.cfg.forward.max_reexec:
            # give up: release leases, notify origin with an abort
            self._finish_leases(txn, node)
            if node != txn.origin:
                self.gcs.p2p_send(
                    node,
                    txn.origin,
                    ("notice", CommitNotice(txn.txid, txn.origin, txn.thread, False)),
                )
            else:
                self._txn_done(txn, committed=False)
            return
        # re-execute holding the leases (ALC re-execution rule): no other
        # replica can have updated the leased classes, so the re-run is
        # conflict-free provided the data-set is unchanged.
        rng = self.rngs[node]
        mean = txn.spec.exec_ms or self.cfg.exec_ms
        dur = float(rng.exponential(mean) * 0.5 + mean * 0.5) * r.slowdown
        def reexec():
            self.events.schedule(dur, lambda: self._reexec_done(txn, node))
        self._request_slot(node, reexec)

    def _reexec_done(self, txn: SimTxn, node: int) -> None:
        r = self.replicas[node]
        txn.stm = Transaction(txid=txn.txid, origin=txn.origin)
        txn.result = txn.spec.execute(r.store, txn.stm)
        self._release_slot(node)
        tr = self.trace
        if tr is not None:
            tr.span("reexec", f"node{node}/t{txn.thread}", self.events.now,
                    0.0, txid=txn.txid, n=txn.reexecs)
        if self.cfg.certify_mode == "batched":
            self._enqueue_certify(txn, node)
        else:
            self._validate_and_commit(txn, node)

    def _commit(self, txn: SimTxn, node: int) -> None:
        r = self.replicas[node]
        r.store.apply_versioned(txn.stm.write_set, txn.txid)
        self._commit_applied(txn, node)

    def _commit_applied(self, txn: SimTxn, node: int) -> None:
        """Post-apply commit work: disseminate the write-set, free leases.

        The batched drain applies all committers' write-sets in one
        ``apply_batch`` scatter and then runs this per transaction in batch
        order, so broadcast/free ordering matches the sequential path.
        """
        self._ur_broadcast_from(
            node,
            (
                "commit",
                {
                    "txid": txn.txid,
                    "origin": txn.origin,
                    "thread": txn.thread,
                    "ccs": tuple(sorted(txn.ccs)),
                    "writes": dict(txn.stm.write_set),
                    "result": txn.result,
                    "executed_on": node,
                },
            ),
        )
        if self.planner is not None:
            self.planner.affinity.record_commit(
                self.events.now, txn.origin, txn.ccs)
        self._finish_leases(txn, node)

    def _finish_leases(self, txn: SimTxn, node: int) -> None:
        r = self.replicas[node]
        if not txn.lors:
            return
        to_free = r.lm.finished_xact(txn.lors)
        txn.lors = []
        if to_free:
            self._ur_broadcast_from(node, ("freed", [l.key() for l in to_free]))

    def _txn_done(self, txn: SimTxn, committed: bool) -> None:
        self._inflight.pop(txn.txid, None)
        m = self.metrics
        if committed:
            m.commits += 1
            if txn.spec.read_only:
                m.ro_commits += 1
            else:
                m.rw_commits += 1
            m.commit_times.append((self.events.now, txn.origin))
            m.commit_latency_sum += self.events.now - txn.t_start
        # closed loop: the originating thread starts its next transaction
        self.events.schedule(
            self.cfg.think_ms, (lambda: self._start_txn(txn.origin, txn.thread))
        )

    # -- GCS handlers ----------------------------------------------------------------
    def _on_opt(self, node: int, msg, sender: int) -> None:
        kind, payload = msg
        if kind != "lease":
            return
        req: LeaseRequest = payload
        r = self.replicas[node]
        to_free = r.lm.on_opt_deliver(req)
        if to_free:
            self._ur_broadcast_from(node, ("freed", [l.key() for l in to_free]))

    def _on_to(self, node: int, msg, sender: int) -> None:
        kind, payload = msg
        if kind != "lease":
            return
        req: LeaseRequest = payload
        r = self.replicas[node]
        lors = r.lm.on_to_deliver(req)
        if req.proc == node:
            if req.prefetch:
                # planner prefetch: no transaction is attached; the LORs
                # wait like a commit phase would and are drained to
                # activeXacts=0 only once they head their queues
                # (_settle_prefetches) — afterwards they sit unblocked and
                # piggybackable, freed by the usual rule the moment a
                # conflicting request blocks them
                if lors:
                    r.prefetch_waiters.append(lors)
            else:
                txn = r.pending_reqs.pop(req.req_id, None)
                if txn is not None:
                    txn.lors = lors
                    tr = self.trace
                    if tr is not None:
                        tr.aend("lease-round", f"node{node}/lease",
                                req.req_id, ts=self.events.now)
                    if txn.exec_done:
                        self._wait_enabled(txn, node)
                    # else: pipelined handoff — the lease round finished
                    # before the overlapped execution; _exec_done joins
        self._check_waiters(node)

    def _on_urb(self, node: int, msg, sender: int) -> None:
        kind, payload = msg
        r = self.replicas[node]
        if kind == "freed":
            r.lm.on_ur_deliver_freed(payload)
            tr = self.trace
            if tr is not None and node == sender:
                # once per broadcast (at the freeing node), not per replica
                tr.instant("lease-free", f"node{node}/lease",
                           ts=self.events.now, n=len(payload))
            self._check_waiters(node)
        elif kind == "commit":
            c = payload
            if node != c["executed_on"]:
                r.store.apply_versioned(c["writes"], c["txid"])
            r.freq.record(self.events.now, c["origin"], c["ccs"])
            if node == c["origin"]:
                # resume the originating thread (result piggybacked on the
                # commit message, §3.2)
                self._complete_origin(c["txid"])

    def _on_p2p(self, node: int, msg, sender: int) -> None:
        kind, payload = msg
        if kind == "forward":
            txn: SimTxn = payload
            self._certify(txn, node)
        elif kind == "notice":
            n: CommitNotice = payload
            # aborted after max re-executions: surface to the application
            # (paper: explicit exception); the thread moves on.
            self._inflight.pop(n.txid, None)
            self.events.schedule(
                self.cfg.think_ms, (lambda: self._start_txn(n.origin, n.origin_thread))
            )

    # origin-side completion bookkeeping -------------------------------------------
    def _complete_origin(self, txid: int) -> None:
        txn = self._inflight.pop(txid, None)
        if txn is None:
            return
        self._txn_done(txn, committed=True)

    def _on_view_change(self, node: int, view: List[int], failed: int) -> None:
        r = self.replicas[node]
        r.lm.purge_proc(failed)
        if self.planner is not None:
            # the planner's state must die with the member too: its affinity
            # rows would keep attracting moves toward the dead node, and
            # history entries naming it would mis-gate reversals (idempotent
            # — every surviving replica's view change applies it)
            self.planner.purge_node(failed)
        # transactions this node forwarded to (or had pending at) the failed
        # member are restarted locally — fail-stop recovery for the TF path.
        for txid, txn in list(self._inflight.items()):
            if txn.origin == node and txn.exec_node == failed:
                del self._inflight[txid]
                self.events.schedule(
                    self.cfg.think_ms,
                    (lambda t=txn: self._start_txn(t.origin, t.thread)),
                )
        self._check_waiters(node)
