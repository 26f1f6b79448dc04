"""Proactive placement planner — self-optimizing lease circulation.

The port of :mod:`repro.plan`.  The reactive DTD and the serving router
only move a lease when a transaction or request is already stalled on it;
this package is the proactive counterpart, run as a background control
loop:

* :mod:`repro_torch.plan.affinity` watches commit/forward/abort events
  (the simulator) or touch/forward metrics (the serving stack) and keeps a
  decayed conflict-class ↔ node affinity matrix plus class ↔ class
  co-access rates (a copy of the reference module);
* :mod:`repro_torch.plan.score` scores every [class, target-node]
  candidate move in one evaluation on the planner's device (a side CUDA
  stream on the card), bit for bit the reference's numpy twin;
* :mod:`repro_torch.plan.planner` turns scores into a bounded,
  hysteresis-damped :class:`PlacementPlan` (top-K moves per epoch,
  per-node byte budget, no move that reverses a recent one).

Consumers execute plans off the critical path: the cluster simulator as
background lease prefetches through the lease managers, the serving
engine as KV prefetch + session re-homes priced onto pod busy clocks.
"""
from .affinity import AffinityTracker
from .planner import (PendingPlan, PlacementPlan, PlacementPlanner,
                      PlanConfig, PlannedMove, SERVE_PLAN_DEFAULTS,
                      SIM_PLAN_DEFAULTS)
from .score import (PendingScores, price_move_costs, score_moves,
                    score_moves_async, score_moves_np)

__all__ = [
    "AffinityTracker", "PendingPlan", "PendingScores", "PlacementPlan",
    "PlacementPlanner", "PlanConfig", "PlannedMove", "SERVE_PLAN_DEFAULTS",
    "SIM_PLAN_DEFAULTS", "price_move_costs", "score_moves",
    "score_moves_async", "score_moves_np",
]
