"""Locality-aware multi-pod request router — Lilac-TM at the serving layer.

Sessions are the conflict classes; the pod holding a session's KV cache is
its lease owner.  Per request the router solves the paper's ILP
(:mod:`repro_torch.core.dtd`) over the pods:

* ``short`` policy — the SC communication cost, with the step constants
  replaced by roofline-priced byte costs (:mod:`repro_torch.dist.locality`):
  forwarding a request is a p2p of the prompt/response; acquiring the
  session locally ships the KV slice + an ownership handoff;
* ``long`` policy — the LC access-frequency cost over piggybacked
  per-pod session-touch rates (an attractor forms where a session's
  requests concentrate);
* constraint (3) — pods above ``max_cpu`` (queue depth / capacity) are
  not eligible migration targets: the paper's own straggler valve.

The step-constant ILP and the byte model can disagree: the SC constants say
"forward to the owner" regardless of how many bytes the alternatives put on
the DCN, and its all-overloaded fallback acquires at the origin even when
that ships megabytes of KV.  ``arbitration`` selects who settles the
forward-vs-acquire binary for an owned session:

* ``steps``  — the DTD step constants alone (legacy behaviour);
* ``priced`` — ``price_session_dispatch.prefer_migration`` alone: forward
  when the work description is lighter than the KV state, acquire
  otherwise, with constraint (3) flipping the verdict only when the
  preferred side is overloaded and the other is not;
* ``hybrid`` — the DTD picks first; when it redirects to a third pod
  (overload valve, LC attractor) that stands, but whenever its choice is
  the plain origin/owner binary the byte model breaks the disagreement.

The router maintains the fine-grained ownership ledger with per-session
*lease stickiness*: ownership only moves when the DTD decides the state
should travel, so repeated requests on a session are certified locally —
the serving analogue of FGL lease reuse.  Per-session access frequencies
(the LC inputs) live in ONE growable
:class:`repro_torch.core.stats.DecayedFrequency` matrix ([pod, sid]) decayed on
the router clock — the engine advances it via :meth:`tick` with simulated
step time, so the attractor is rate-based, not per-touch.  The placement
planner's affinity tracker (:mod:`repro_torch.plan.affinity`) is the same
implementation on the same clock; attach one via :attr:`affinity` and the
router feeds it touch/forward events as they happen.

When a planner drives placement (:attr:`planned` set by the engine),
constraint-(3) overload no longer flips the arbitration verdict onto the
byte-heavy plan: panic-acquiring a grown KV cache on the critical path is
exactly the reactive churn the proactive planner replaces — rebalancing
becomes the planner's job, off the critical path and byte-budgeted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.dtd import DTD, DTDConfig
from ..core.stats import DecayedFrequency
from ..dist.locality import ROUTER_DEFAULTS, price_session_dispatch

ARBITRATIONS = ("steps", "priced", "hybrid")


@dataclass
class RouteDecision:
    target: int                  # pod that will run the decode
    action: str                  # "local" | "forward" | "acquire"
    wire_bytes: float = 0.0
    wire_s: float = 0.0          # DCN time of the chosen plan, RTT included
    # the session's lease epoch after this decision: bumped on every
    # ownership move, snapshotted onto forwarded requests so the owner's
    # batched certifier (repro_torch.serve.certifier) can reject forwards that
    # lost their lease while on the wire
    epoch: int = 0


@dataclass
class RouterMetrics:
    requests: int = 0
    local_hits: int = 0
    forwards: int = 0
    acquires: int = 0
    wire_bytes: float = 0.0
    flips: int = 0               # byte model overrode the step-constant verdict
    planned_moves: int = 0       # ownership moves applied by the planner

    @property
    def lease_reuse_rate(self) -> float:
        return self.local_hits / max(1, self.requests)


class LocalityRouter:
    def __init__(
        self,
        n_pods: int,
        *,
        policy: str = ROUTER_DEFAULTS.policy,
        arbitration: str = ROUTER_DEFAULTS.arbitration,
        max_cpu: float = ROUTER_DEFAULTS.max_cpu,
        kv_bytes_per_token: float = 2048.0,
        request_bytes: float = 4096.0,
        response_bytes: float = 1024.0,
        freq_tau_ms: float = ROUTER_DEFAULTS.freq_tau_ms,
        seq_shards: float = 1,
    ) -> None:
        if arbitration not in ARBITRATIONS:
            raise ValueError(f"unknown arbitration {arbitration!r}")
        self.n_pods = n_pods
        self.policy = policy
        self.arbitration = arbitration
        self.dtd = DTD(DTDConfig(policy=policy, max_cpu=max_cpu), n_pods)
        self.owner: Dict[int, int] = {}          # session -> owning pod
        self.lease_epoch: Dict[int, int] = {}    # session -> ownership epoch
        # tombstone floor for evicted sids: lease_epoch holds *live*
        # sessions only; an absent sid resolves to this floor, which is
        # raised past every evicted session's last epoch.  A recycled sid
        # therefore starts above anything its previous tenancy ever
        # stamped — the no-alias guarantee without an ever-growing dict.
        self._epoch_floor = 0
        self.freq_tau_ms = freq_tau_ms
        # per-session touch rates, one growable [pod, sid] matrix on the
        # router clock (shared implementation with the planner's affinity)
        self.freq = DecayedFrequency(n_pods, 64, tau_ms=freq_tau_ms,
                                     grow_cols=True)
        # optional planner hookups (set by the engine when a planner runs)
        self.affinity = None         # repro_torch.plan.affinity.AffinityTracker
        self.planned = False         # rebalancing delegated to the planner
        self.cpu = np.zeros((n_pods,), np.float64)
        self.kv_bytes_per_token = kv_bytes_per_token
        self.request_bytes = request_bytes
        self.response_bytes = response_bytes
        # seq-sharded KV layout: a state move leaves as this many parallel
        # shard-to-shard hops (fractional for partially-sharded hybrid
        # caches), shifting the forward-vs-acquire crossover toward
        # acquisition for long-context sessions
        self.seq_shards = max(1.0, float(seq_shards))
        self.metrics = RouterMetrics()
        self._now = 0.0              # router clock, ms (advanced by tick())

    # -- stats ingestion -----------------------------------------------------
    def observe_cpu(self, cpu: np.ndarray) -> None:
        self.cpu[:] = cpu

    def tick(self, dt_ms: float) -> None:
        """Advance the router clock; session touch rates decay against it."""
        self._now += dt_ms

    def _touch(self, origin: int, sid: int) -> None:
        self.freq.record(self._now, origin, (sid,))
        if self.affinity is not None:
            self.affinity.record_touch(self._now, origin, (sid,))

    # -- the decision ----------------------------------------------------------
    def route(self, origin: int, sid: int, session_len: int) -> RouteDecision:
        m = self.metrics
        m.requests += 1
        self._touch(origin, sid)
        owner = self.owner.get(sid, -1)
        epoch = self.lease_epoch.get(sid, self._epoch_floor)

        if owner == origin:
            m.local_hits += 1
            return RouteDecision(origin, "local", epoch=epoch)

        kv_bytes = session_len * self.kv_bytes_per_token
        # request/response sizes are already bytes, not tokens
        costs = price_session_dispatch(
            self.request_bytes, self.response_bytes, kv_bytes,
            wire_bytes_per_token=1.0, seq_shards=self.seq_shards)

        if owner < 0:
            # new session (or re-placement after evict): place at the DTD's
            # choice (long-term policy may pick the attractor; default to
            # origin).  Every placement is an ownership transition, so the
            # epoch bumps — forwards snapshotted against a prior placement
            # of a recycled sid must not certify against the new one
            target = self._dtd_target(origin, sid, owner)
            self.owner[sid] = target
            epoch += 1
            self.lease_epoch[sid] = epoch
            if target == origin:
                m.local_hits += 1
                return RouteDecision(origin, "local", epoch=epoch)
            m.forwards += 1
            wire = self.request_bytes + self.response_bytes
            m.wire_bytes += wire
            return RouteDecision(target, "forward", wire,
                                 costs.migrate_work_s, epoch=epoch)

        target = self._dtd_target(origin, sid, owner)
        action = "forward" if target == owner else "acquire"
        if self.arbitration != "steps":
            action, target = self._arbitrate(origin, owner, target, action, costs)

        if action == "forward":
            # migrate the work to the state owner
            m.forwards += 1
            m.wire_bytes += costs.work_bytes
            if self.affinity is not None:
                self.affinity.record_forward(self._now, origin, (sid,))
            return RouteDecision(owner, "forward", costs.work_bytes,
                                 costs.migrate_work_s, epoch=epoch)
        # migrate the state to the target (lease + KV move): the epoch bump
        # invalidates forwards still in flight toward the old owner
        self.owner[sid] = target
        epoch += 1
        self.lease_epoch[sid] = epoch
        m.acquires += 1
        m.wire_bytes += kv_bytes
        return RouteDecision(target, "acquire", kv_bytes,
                             costs.migrate_state_s, epoch=epoch)

    def _arbitrate(self, origin: int, owner: int, target: int, action: str,
                   costs) -> Tuple[str, int]:
        """Settle forward-vs-acquire with the priced verdict.

        ``prefer_migration`` (forward the work) wins unless the preferred
        side violates constraint (3) while the other side doesn't; when both
        sides are overloaded the cheap-wire plan is the fallback — this is
        where the step-constant solver's acquire-at-origin fallback ships
        whole KV caches for nothing.
        """
        if self.arbitration == "hybrid" and target not in (origin, owner):
            return action, target    # DTD redirect (valve / attractor) stands
        if self.planned:
            # planner mode: the byte verdict stands unconditionally — the
            # constraint-(3) escape hatch (acquire a grown cache because the
            # owner runs hot) is the reactive churn the planner replaces
            # with budgeted, off-critical-path rebalancing
            byte_action = ("forward", owner) if costs.prefer_migration \
                else ("acquire", origin)
            if byte_action[0] != action:
                self.metrics.flips += 1
            return byte_action
        fwd_ok = self.dtd.feasible(self.cpu, owner)
        acq_ok = self.dtd.feasible(self.cpu, origin)
        if costs.prefer_migration:
            byte_action = ("forward", owner) if fwd_ok or not acq_ok \
                else ("acquire", origin)
        else:
            byte_action = ("acquire", origin) if acq_ok or not fwd_ok \
                else ("forward", owner)
        if byte_action[0] != action:
            self.metrics.flips += 1
        return byte_action

    def _dtd_target(self, origin: int, sid: int, owner: int) -> int:
        freq = np.zeros((self.n_pods, 1), np.float64)
        if sid < self.freq.n_cols:
            freq[:, 0] = self.freq.rates(self._now)[:, sid]
        return self.dtd.decide(
            origin=origin,
            ccs=frozenset({0}),
            lease_owner_of_cc=lambda cc: owner,
            freq_rates=freq,
            cpu=self.cpu,
            opt_hint=owner if owner >= 0 else origin,
        )

    def apply_move(self, sid: int, dst: int) -> int:
        """Apply a planner move to the ownership ledger; returns the new
        lease epoch.  Epoch semantics are identical to a reactive acquire:
        every ownership transition bumps, so forwards routed against the
        old owner fail certification and re-route."""
        self.owner[sid] = dst
        epoch = self.lease_epoch.get(sid, self._epoch_floor) + 1
        self.lease_epoch[sid] = epoch
        self.metrics.planned_moves += 1
        return epoch

    def evict(self, sid: int) -> int:
        """Retire a session from the ledger; returns its tombstone epoch.

        The sid's epoch entry is *folded into* ``_epoch_floor`` rather than
        kept (the dict holds live sessions only): the floor is raised past
        the evicted epoch, and an absent sid resolves to the floor on its
        next appearance.  Callers stamp the returned tombstone into their
        epoch store (:meth:`repro_torch.serve.certifier.StepCertifier.bump`) so a
        forward of the dead tenancy still on the wire fails certification —
        and a recycled sid's first placement bumps *above* the tombstone,
        so it can never be aliased by that stale forward either.
        """
        self.owner.pop(sid, None)
        e = self.lease_epoch.pop(sid, self._epoch_floor)
        self._epoch_floor = max(self._epoch_floor, e + 1)
        self.freq.zero_col(sid)
        if self.affinity is not None:
            self.affinity.forget(sid)
        self._maybe_compact()
        return self._epoch_floor

    def _maybe_compact(self) -> None:
        """Shrink the grown per-session stat columns back toward the live
        sid range (pow2 + 4x hysteresis, see ``DecayedFrequency.shrink_to``)
        — a burst of high sids must not pin memory after mass eviction."""
        hi = (max(self.owner) + 1) if self.owner else 0
        self.freq.shrink_to(hi)
        if self.affinity is not None:
            self.affinity.compact(hi)
