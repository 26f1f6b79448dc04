"""Turn batched move scores into a bounded, damped placement plan.

The planner is deliberately conservative: decayed affinity counters are
noisy, and an over-eager plan would churn leases (the exact failure mode
the paper's overload experiment warns about).  Three dampers:

* **top-K** moves per epoch — the control loop nudges, it never reshuffles
  the fleet in one step;
* **per-node byte budget** — the inbound state a target node may receive
  per epoch is capped, so planned migrations can't swamp a NIC (and total
  planned wire is bounded by ``n_nodes · node_budget_bytes`` per epoch);
* **hysteresis** — a move that *reverses* a move executed within the last
  ``hysteresis_epochs`` epochs is rejected, so two attractors can't
  ping-pong a class between them.

Candidates are ranked by score per shipped byte (a zero-byte lease
prefetch ranks above any re-home of equal score), and at most one target —
the argmax — is considered per class.  Constraint-(3) feasibility is
already masked in the scorer; the planner re-checks nothing about safety
because it never touches the lease protocol: executors route every move
through the existing lease manager / ownership ledger.

The planner scores on its ``device`` ("cuda" by default: a side stream on
the card, see :func:`repro_torch.plan.score.score_moves_async`), and with
a plan ``mesh`` (:func:`repro_torch.dist.sharding.make_plan_mesh`; None on
a world of one) splits the classes over its ranks, as the reference does.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, replace
from typing import Deque, List, Optional, Tuple

import numpy as np

from .affinity import AffinityTracker
from .. import resolve_device
from .score import PendingScores, score_moves_async


@dataclass(frozen=True)
class PlanConfig:
    """Knobs of the affinity → score → plan loop (see module docstrings)."""

    epoch_ms: float = 50.0           # plan cadence on the consumer's clock
    top_k: int = 8                   # max moves per epoch
    node_budget_bytes: float = 4e6   # max inbound state per target per epoch
    hysteresis_epochs: int = 4       # W: reversal-rejection window
    horizon_ms: float = 500.0        # benefit horizon (≈ affinity tau)
    margin: float = 2.0              # benefit must exceed margin × move cost
    min_frac: float = 0.45           # dominance share a target must hold
    min_events: float = 6.0          # decayed evidence a class needs to move
    load_gain: float = 0.0           # rebalancing pressure (events/ms per cpu)
    co_gain: float = 0.0             # co-location credit (sim multi-class txns)
    min_score: float = 0.0           # floor on the final score
    max_cpu: float = 0.9             # DTD constraint (3) threshold
    overload_ctrl: bool = True
    tau_ms: float = 500.0            # affinity decay constant
    forward_weight: float = 2.0      # forwards count this much in affinity


# Serving: epochs are engine sim-time ms (a pod step is ~0.1–0.5 ms), moves
# ship real KV bytes — tight budget, strict evidence gates.  Winners of the
# benchmarks/planner.py sweep (mixtral KV sizes, 3 seeds): vs ROUTER_DEFAULTS
# the planner cuts total wire 4.6–7.5× and forwards 8–26% at locality ≥ 0.7
# with tokens/s parity at locality 0 (where the gates keep it idle).
SERVE_PLAN_DEFAULTS = PlanConfig(
    epoch_ms=5.0, top_k=4, node_budget_bytes=2e6, hysteresis_epochs=6,
    horizon_ms=500.0, margin=3.0, min_frac=0.7, min_events=8.0,
    load_gain=0.02, forward_weight=1.5)

# Simulator: epochs are simulated wall ms, costs are the paper's
# communication steps (a lease prefetch ships no state), multi-class
# footprints make co-location worth crediting.
SIM_PLAN_DEFAULTS = PlanConfig(
    epoch_ms=50.0, top_k=16, node_budget_bytes=float("inf"),
    hysteresis_epochs=2, horizon_ms=200.0, margin=4.0, min_frac=0.5,
    co_gain=0.25, tau_ms=200.0)


@dataclass(frozen=True)
class PlannedMove:
    cc: int                 # conflict class / session id
    src: int                # owner at planning time
    dst: int                # target node/pod
    state_bytes: float      # state the move ships (0 ⇒ pure lease prefetch)
    score: float

    @property
    def is_prefetch(self) -> bool:
        return self.state_bytes <= 0.0


@dataclass
class PlacementPlan:
    epoch: int
    moves: List[PlannedMove] = field(default_factory=list)
    n_candidates: int = 0   # finite-scored candidates before bounding

    @property
    def total_bytes(self) -> float:
        return sum(m.state_bytes for m in self.moves)

    def __bool__(self) -> bool:
        return bool(self.moves)


@dataclass
class PendingPlan:
    """An in-flight epoch: scoring dispatched, bounding deferred.

    Everything the bounding loop reads is snapshotted at :meth:`
    PlacementPlanner.begin` time (epoch-stamped inputs), so however many
    decode steps run between ``begin`` and ``finish``, the finished plan is
    byte-identical to the plan a synchronous call would have produced at
    the begin instant.  ``scores`` is the dispatched evaluation, not yet
    waited for; ``view`` stamps the membership view for purge
    invalidation.
    """

    epoch: int
    view: int
    c: int
    owner: "np.ndarray"
    state_bytes: "np.ndarray"
    scores: Optional[PendingScores]   # [cap, N]; None when c == 0


class PlacementPlanner:
    """The decision half of the loop: affinity in, bounded plan out."""

    def __init__(self, n_nodes: int, n_classes: int,
                 cfg: Optional[PlanConfig] = None, *,
                 grow: bool = False, track_co: bool = False,
                 device="cuda", mesh=None) -> None:
        self.cfg = cfg or PlanConfig()
        self.n_nodes = n_nodes
        self.affinity = AffinityTracker(
            n_nodes, n_classes, tau_ms=self.cfg.tau_ms,
            forward_weight=self.cfg.forward_weight,
            track_co=track_co or self.cfg.co_gain > 0.0, grow=grow)
        self.epoch = 0
        # executed-move history for the reversal check: (epoch, cc, src, dst)
        self._history: Deque[Tuple[int, int, int, int]] = deque()
        self.planned_moves = 0
        self.planned_bytes = 0.0
        # the device the scores are computed on, the plan mesh that splits
        # their classes (None: unsharded); membership view counter +
        # bounded purge log for invalidating in-flight plans
        self.device = resolve_device(device)
        self.mesh = mesh
        self._view = 0
        self._purge_log: Deque[Tuple[int, int]] = deque(maxlen=256)

    @classmethod
    def for_serving(cls, n_pods: int, n_sessions: int,
                    epoch_ms: Optional[float] = None, *,
                    device="cuda", mesh=None) -> "PlacementPlanner":
        """The serving-stack construction (growable session space, pinned
        ``SERVE_PLAN_DEFAULTS``, optional epoch override) — the one used by
        ``launch/serve.py`` and the benches."""
        cfg = SERVE_PLAN_DEFAULTS if epoch_ms is None else \
            replace(SERVE_PLAN_DEFAULTS, epoch_ms=epoch_ms)
        return cls(n_pods, n_sessions, cfg, grow=True, device=device,
                   mesh=mesh)

    # -- view change ---------------------------------------------------------
    def purge_node(self, node: int) -> None:
        """A member failed: drop every planner trace of it.

        Without this the planner keeps steering at a ghost — the dead
        node's affinity rows still attract moves toward it, and history
        entries naming it mis-gate live moves (a class moved *to* the dead
        node recently would refuse its rescue move back as a "reversal").
        Executors already skip dead targets, so this is about not wasting
        the bounded plan (top-K slots, byte budget) on them and not
        blocking the survivors.  Idempotent: every surviving replica's
        view-change handler may call it.

        Also bumps the membership view: a :class:`PendingPlan` begun before
        this purge scored against the dead node's affinity rows, so
        :meth:`finish` drops its moves that name the node (the async
        epoch's invalidation seam).
        """
        self.affinity.purge_node(node)
        self._history = deque(
            h for h in self._history if h[2] != node and h[3] != node)
        self._view += 1
        self._purge_log.append((self._view, node))

    # -- hysteresis ----------------------------------------------------------
    def _reverses_recent(self, cc: int, dst: int, epoch: int) -> bool:
        w = self.cfg.hysteresis_epochs
        for (ep, c, src, _d) in self._history:
            if c == cc and src == dst and epoch - ep < w:
                return True
        return False

    def _prune_history(self) -> None:
        w = self.cfg.hysteresis_epochs
        while self._history and self.epoch - self._history[0][0] >= w:
            self._history.popleft()

    # -- the plan ------------------------------------------------------------
    def begin(
        self,
        now: float,
        owner: np.ndarray,          # [C] int, -1 = unowned (skipped)
        state_bytes: np.ndarray,    # [C] bytes a move of class c ships
        fwd_cost: np.ndarray,       # [C] per-access forward cost
        move_cost: np.ndarray,      # [C] one-time migration cost
        cpu: np.ndarray,            # [N]
    ) -> PendingPlan:
        """Kick one epoch's scoring; return without waiting for it.

        Snapshots every input (including the decayed affinity rates at
        ``now``) and dispatches the evaluation on ``self.device`` — a side
        stream on the card — so the caller's decode steps overlap the
        device work.  :meth:`finish` harvests; ``finish(begin(...))``
        with nothing in between IS the synchronous plan.
        """
        cfg = self.cfg
        self.epoch += 1
        self._prune_history()
        c = len(owner)
        owner = np.asarray(owner, dtype=np.int32).copy()
        if c == 0:
            return PendingPlan(epoch=self.epoch, view=self._view, c=0,
                               owner=owner, state_bytes=np.zeros((0,)),
                               scores=None)
        # pow2-pad the class axis, as the reference does for its jit cache
        # (the serving session space grows dynamically): the port scores
        # the same padded shapes
        cap = 1
        while cap < c:
            cap *= 2
        owner_p = np.full((cap,), -1, dtype=np.int32)
        owner_p[:c] = owner
        # float32 like the cost/rate producers: the scorer computes in
        # float32, and float64 here would put [cap]-sized host conversions
        # back on the kick path
        pad = lambda a: np.pad(np.asarray(a, np.float32), (0, cap - c))
        rates = self.affinity.rates(now, cap)
        co = (self.affinity.co_rates(now, cap)
              if cfg.co_gain > 0.0 else None)
        scores = score_moves_async(
            rates, owner_p, pad(fwd_cost), pad(move_cost), cpu,
            horizon_ms=cfg.horizon_ms, margin=cfg.margin,
            min_frac=cfg.min_frac, min_rate=cfg.min_events / cfg.tau_ms,
            load_gain=cfg.load_gain,
            co_gain=cfg.co_gain, co_rates=co, max_cpu=cfg.max_cpu,
            overload_ctrl=cfg.overload_ctrl, device=self.device,
            mesh=self.mesh)
        return PendingPlan(
            epoch=self.epoch, view=self._view, c=c, owner=owner,
            state_bytes=np.asarray(state_bytes, dtype=np.float64).copy(),
            scores=scores)

    def finish(self, pending: PendingPlan) -> PlacementPlan:
        """Harvest a :meth:`begin` dispatch into the bounded plan.

        Pure host work over the epoch-stamped snapshot: materialize the
        scores (the only wait), argmax per class, rank by score per shipped
        byte, bound by top-K / byte budget / hysteresis.  Nodes purged
        since ``begin`` (``pending.view``) invalidate their moves — the
        snapshot scored against a membership view that no longer exists.
        """
        cfg = self.cfg
        plan = PlacementPlan(epoch=pending.epoch)
        c = pending.c
        if c == 0:
            return plan
        scores = pending.scores.wait()[:c]
        purged = {node for (v, node) in self._purge_log
                  if v > pending.view}

        # one candidate per class: its argmax target
        best_n = np.argmax(scores, axis=1)
        best_s = scores[np.arange(c), best_n]
        cand = np.flatnonzero(np.isfinite(best_s) & (best_s > cfg.min_score))
        plan.n_candidates = int(cand.size)
        if not cand.size:
            return plan
        sb = pending.state_bytes
        # rank by score per shipped byte: a lease prefetch (0 bytes) beats
        # any re-home of equal score, small caches beat grown ones
        rank = best_s[cand] / np.maximum(sb[cand], 1.0)
        order = cand[np.argsort(-rank)]

        spent = np.zeros((self.n_nodes,), dtype=np.float64)
        for idx in order:
            if len(plan.moves) >= cfg.top_k:
                break
            cc, dst = int(idx), int(best_n[idx])
            src, bytes_ = int(pending.owner[idx]), float(sb[idx])
            if src in purged or dst in purged:
                continue
            if spent[dst] + bytes_ > cfg.node_budget_bytes:
                continue
            if self._reverses_recent(cc, dst, pending.epoch):
                continue
            plan.moves.append(PlannedMove(
                cc=cc, src=src, dst=dst, state_bytes=bytes_,
                score=float(best_s[idx])))
            spent[dst] += bytes_
        return plan

    def plan(
        self,
        now: float,
        owner: np.ndarray,
        state_bytes: np.ndarray,
        fwd_cost: np.ndarray,
        move_cost: np.ndarray,
        cpu: np.ndarray,
    ) -> PlacementPlan:
        """Synchronous epoch: ``finish(begin(...))`` at zero distance."""
        return self.finish(self.begin(
            now, owner, state_bytes, fwd_cost, move_cost, cpu))

    def committed(self, moves: List[PlannedMove]) -> None:
        """Record the moves a consumer actually executed.

        Hysteresis and the planned_moves/planned_bytes counters track
        *executed* work: a move the executor skipped (dead target, stale
        ownership) must neither block its class's real move as a phantom
        "reversal" nor inflate the accounting."""
        for m in moves:
            self._history.append((self.epoch, m.cc, m.src, m.dst))
        self.planned_moves += len(moves)
        self.planned_bytes += sum(m.state_bytes for m in moves)
