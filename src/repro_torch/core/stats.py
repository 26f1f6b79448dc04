"""Access-frequency and CPU-utilization statistics (DTD inputs).

The paper gathers, per node, the access frequencies F(j, x) — transactions/s
originated on node j touching conflict class x — and CPU utilization, both
piggybacked on commit / lease-request messages.  We model the piggybacking by
updating every replica's *view* of these statistics at message-delivery time
(the cluster calls :meth:`on_commit_delivered`), so views are as stale as the
message latency, exactly like the real system.

Frequencies use exponentially-decayed counters: an event at time t adds 1 to
a counter that decays as exp(-Δt/τ); the rate estimate is counter/τ.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable

import numpy as np


class DecayedFrequency:
    """F[j, x] matrix of exponentially-decayed event rates.

    The single decayed-counter implementation of the repo: the simulator's
    per-replica access frequencies, the serving router's per-session touch
    rates, and the placement planner's affinity matrices
    (:mod:`repro.plan.affinity`) are all instances of this class, decayed
    against one caller-supplied clock (the event queue's ``now`` in the
    simulator, the engine-ticked router clock in serving).

    ``grow_cols=True`` lets the column space grow on demand in power-of-two
    steps (sessions appear dynamically; conflict classes are fixed), so one
    matrix replaces a dict of per-column trackers without recompiling
    consumers on every new column.
    """

    def __init__(self, n_nodes: int, n_classes: int, tau_ms: float = 200.0,
                 *, grow_cols: bool = False) -> None:
        self.tau = tau_ms
        self.grow_cols = grow_cols
        self.counts = np.zeros((n_nodes, n_classes), dtype=np.float64)
        self.last_t = 0.0

    @property
    def n_cols(self) -> int:
        return self.counts.shape[1]

    def ensure_col(self, col: int) -> None:
        """Grow the column space (power-of-two steps) to include ``col``."""
        n = self.counts.shape[1]
        if col < n:
            return
        if not self.grow_cols:
            raise IndexError(f"column {col} out of range (n_cols={n})")
        m = max(1, n)
        while m <= col:
            m *= 2
        grown = np.zeros((self.counts.shape[0], m), dtype=np.float64)
        grown[:, :n] = self.counts
        self.counts = grown

    def _decay_to(self, t: float) -> None:
        if t > self.last_t:
            self.counts *= math.exp(-(t - self.last_t) / self.tau)
            self.last_t = t

    def record(self, t: float, origin: int, ccs: Iterable[int],
               weight: float = 1.0) -> None:
        self._decay_to(t)
        for cc in ccs:
            if cc >= self.counts.shape[1]:
                self.ensure_col(cc)
            self.counts[origin, cc] += weight

    def rates(self, t: float) -> np.ndarray:
        """F(j, x) in events/ms, shape [n_nodes, n_classes]."""
        self._decay_to(t)
        return self.counts / self.tau

    def zero_col(self, col: int) -> None:
        """Forget a column (e.g. an evicted session)."""
        if col < self.counts.shape[1]:
            self.counts[:, col] = 0.0

    # zero_col under its control-plane name: eviction *frees* the column
    # for reuse by a recycled id (the epoch tombstone lives with the
    # consumer; see repro.serve.router.LocalityRouter.evict)
    free_col = zero_col

    def shrink_to(self, n_cols: int, *, floor: int = 64) -> None:
        """Shrink the grown column space to the pow2 covering ``n_cols``.

        The grow-only policy means a burst of high session ids pins memory
        forever; after mass evictions the consumer passes its highest live
        id + 1 and the matrix drops back.  Hysteresis: only shrink when at
        least 4x over target, so churn around a boundary never thrashes
        reallocation.  No-op for fixed-width matrices.
        """
        if not self.grow_cols:
            return
        target = max(1, floor)
        while target < n_cols:
            target *= 2
        if target * 4 <= self.counts.shape[1]:
            self.counts = self.counts[:, :target].copy()


class CpuMeter:
    """EWMA utilization of a node's execution slots."""

    def __init__(self, n_slots: int, tau_ms: float = 50.0) -> None:
        self.n_slots = max(1, n_slots)
        self.tau = tau_ms
        self.value = 0.0
        self.busy = 0
        self.extra_load = 0.0  # injected background jobs (overload experiment)
        self.last_t = 0.0

    def _advance(self, t: float) -> None:
        if t > self.last_t:
            inst = min(1.0, self.busy / self.n_slots + self.extra_load)
            a = math.exp(-(t - self.last_t) / self.tau)
            self.value = a * self.value + (1 - a) * inst
            self.last_t = t

    def acquire(self, t: float) -> None:
        self._advance(t)
        self.busy += 1

    def release(self, t: float) -> None:
        self._advance(t)
        self.busy -= 1
        assert self.busy >= 0

    def utilization(self, t: float) -> float:
        # extra_load is already folded into the EWMA target by _advance;
        # adding it here again would double-count the injected load and trip
        # the constraint-(3) valve at ~half the configured threshold
        self._advance(t)
        return min(1.0, self.value)
