"""Schedule-space explorer: model-checking the lease protocol.

Stateless model checking over the deterministic simulator.  A *model* is a
re-constructible simulation (a full :class:`~repro_torch.core.cluster.Cluster`,
or a scripted protocol scenario from :mod:`repro_torch.analysis.scenarios`);
the explorer re-executes it once per schedule with a recording
:class:`~repro_torch.core.events.SchedulePolicy` that controls dispatch order
among
the *enabled* events — the same-instant group plus message deliveries within
a bounded commutation window.  Eligibility (TO total order, opt-before-TO,
per-sender FIFO) is enforced by the policy seam, so every explored schedule
is one the real GCS could have produced.

Strategies
----------
* ``exhaustive`` — depth-first enumeration of all legal interleavings with
  **sleep-set partial-order reduction** (two deliveries whose conflict-class
  key sets are disjoint commute; exploring both orders is redundant) and
  **state dedup** on a canonical protocol-state fingerprint
  (:mod:`repro_torch.analysis.fingerprint`).
* ``pct`` — randomized priority schedules (PCT-style): each run draws lazy
  per-event priorities from a seeded RNG and occasionally demotes the
  running winner, probing deep reorderings exhaustive search can't reach
  within budget.
* ``replay`` — re-run one recorded schedule exactly (counterexample replay).

Every schedule runs with the
:class:`~repro_torch.analysis.sanitizer.LeaseSanitizer` installed, plus a
terminal **quiescence** check: once the closed-loop
simulation drains, any surviving waiter or in-flight transaction is a lease
circulation deadlock no per-event invariant can see.  On a violation the
decision trace is delta-debugged (``ddmin``) to a minimal set of deviations
from the default FIFO order and written as a JSON artifact that
``repro-torch-explore replay <trace.json>`` reproduces deterministically.

This is the port of :mod:`repro.analysis.explore`.  Scenarios and the smoke
grid take a ``device`` ("cuda" by default): the explored clusters keep
their version tables there, and with ``jax_min`` 1 (:data:`KERNEL_CELL`)
every drain of every explored schedule launches the drain kernel and every
settle runs on the device.  Run it as ``python -m
repro_torch.analysis.explore`` (``--device cpu`` on a host without a card).
Traces are the reference's JSON: a counterexample saved by either package
replays in the other.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from ..core.events import SchedulePolicy, _Event
from .fingerprint import cluster_fingerprint, digest
from .sanitizer import SanitizerError
from .trace import Cand, Decision, Trace, ddmin, load_trace, save_trace


# --------------------------------------------------------------------------
# Configuration / results
# --------------------------------------------------------------------------

@dataclass
class ExploreConfig:
    """Exploration knobs; also the ``SimConfig.explore`` payload.

    ``policy`` is runtime plumbing, not a knob: the explorer re-constructs
    the model per schedule and injects its recording policy through this
    field (see ``SimConfig.explore`` / ``Cluster.__init__``).
    """

    strategy: str = "exhaustive"       # exhaustive | pct | replay
    window_ms: float = 0.0             # delivery commutation window
    max_schedules: int = 2000
    max_depth: int = 1 << 30           # branching depth bound (decisions)
    por: bool = True                   # sleep-set partial-order reduction
    dedup: bool = True                 # fingerprint state dedup
    minimize: bool = True              # ddmin counterexamples
    pct_seeds: int = 16
    pct_change: float = 0.1            # priority-demotion probability
    seed: int = 0
    check_quiescence: bool = True
    max_events: int = 500_000          # per-schedule dispatch bound
    policy: Optional[SchedulePolicy] = field(
        default=None, repr=False, compare=False)


@dataclass
class ExploreStats:
    schedules: int = 0                 # completed (non-pruned) runs
    pruned_sleep: int = 0              # runs cut by sleep sets
    states_deduped: int = 0            # runs cut by fingerprint dedup
    branches: int = 0                  # alternatives enqueued
    decisions: int = 0                 # total branching points visited
    truncated: bool = False            # hit max_schedules with work left

    @property
    def runs(self) -> int:
        """Everything started, including pruned runs."""
        return self.schedules + self.pruned_sleep + self.states_deduped


@dataclass
class ExploreResult:
    stats: ExploreStats
    violation: Optional[Trace] = None      # first counterexample, as run
    minimized: Optional[Trace] = None      # ddmin'd counterexample

    @property
    def ok(self) -> bool:
        return self.violation is None


class ReplayDivergence(RuntimeError):
    """A forced choice was absent or ineligible — the model diverged."""


class _Pruned(Exception):
    """Internal: this schedule is redundant; abandon the run."""

    def __init__(self, why: str) -> None:
        self.why = why
        super().__init__(why)


def _indep(a: Optional[FrozenSet[int]], b: Optional[FrozenSet[int]]) -> bool:
    """Commutation oracle: disjoint, known conflict-class footprints."""
    return a is not None and b is not None and not (a & b)


# --------------------------------------------------------------------------
# The recording policy
# --------------------------------------------------------------------------

class RecorderPolicy(SchedulePolicy):
    """A :class:`SchedulePolicy` that forces a prefix and records the rest.

    Modes (mutually exclusive):

    * *explore* (default): replay ``prefix`` choices, then pick the first
      eligible non-sleeping candidate (or by PCT priorities when ``rng`` is
      set), recording every decision.  Sleep-set filtering and fingerprint
      dedup activate only once the forced prefix is consumed — the prefix
      deterministically re-creates the branch point, it is not a new
      exploration.
    * *deviation* (``devs``): follow default FIFO order except at the given
      ``{decision index: seq}`` overrides — the ddmin replay primitive.
    """

    def __init__(self, window: float = 0.0,
                 prefix: Optional[List[int]] = None,
                 sleep: Optional[Dict[int, Optional[FrozenSet[int]]]] = None,
                 devs: Optional[Dict[int, int]] = None,
                 rng=None, change_prob: float = 0.0) -> None:
        super().__init__()
        self.window = window
        self.prefix = list(prefix or [])
        self.init_sleep = dict(sleep or {})
        self.devs = devs
        self.rng = rng
        self.change_prob = change_prob
        self.use_sleep = devs is None and rng is None
        # recording
        self.decisions: List[Decision] = []
        self.choices: List[int] = []
        self.sleep_at: List[Optional[Dict[int, Optional[FrozenSet[int]]]]] = []
        # live sleep set (seq -> keys); armed once the prefix is consumed
        self.sleep: Dict[int, Optional[FrozenSet[int]]] = {}
        self._armed = False
        self._prio: Dict[int, float] = {}
        # dedup plumbing, injected by the explorer after model construction
        self.fingerprint_fn: Optional[Callable[[], str]] = None
        self.seen: Optional[Set[str]] = None
        self.stats: Optional[ExploreStats] = None

    # -- helpers -------------------------------------------------------------
    def _arm(self) -> None:
        if not self._armed and len(self.choices) >= len(self.prefix):
            self.sleep = dict(self.init_sleep)
            self._armed = True

    def _forced(self, k: int) -> Optional[int]:
        if self.devs is not None:
            return self.devs.get(k)
        if k < len(self.prefix):
            return self.prefix[k]
        return None

    def _choose(self, free: List[int], pool: List[_Event]) -> int:
        if self.rng is None:
            return free[0]
        best, bestp = free[0], -1.0
        for i in free:
            s = pool[i].seq
            p = self._prio.get(s)
            if p is None:
                p = float(self.rng.random())
                self._prio[s] = p
            if p > bestp:
                best, bestp = i, p
        if self.change_prob and self.rng.random() < self.change_prob:
            # PCT change point: demote the winner so later decisions differ
            self._prio[pool[best].seq] = float(self.rng.random()) * 0.01
        return best

    # -- SchedulePolicy hooks ------------------------------------------------
    def select(self, pool: List[_Event]) -> int:
        cands = []
        eligible: List[int] = []
        for i, ev in enumerate(pool):
            ok = self.eligible(ev)
            if ok:
                eligible.append(i)
            m = ev.meta
            cands.append(Cand(
                seq=ev.seq, time=round(ev.time, 9),
                kind="local" if m is None else m.kind,
                node=-1 if m is None else m.node,
                label="" if m is None else m.label,
                keys=None if m is None or m.keys is None
                else tuple(sorted(m.keys)),
                eligible=ok))
        if not eligible:
            return 0  # unreachable for well-formed metadata; fail open
        default = pool[eligible[0]].seq
        k = len(self.choices)
        want = self._forced(k)
        if want is not None:
            idx = next((i for i, ev in enumerate(pool)
                        if ev.seq == want), None)
            if idx is None or idx not in eligible:
                raise ReplayDivergence(
                    f"decision {k}: forced seq {want} "
                    f"{'absent' if idx is None else 'ineligible'} in pool "
                    f"[{', '.join(c.label or str(c.seq) for c in cands)}]")
            snap = None
        else:
            self._arm()
            if self.fingerprint_fn is not None:
                # the queue's _pick pops the candidate pool off the heap
                # before select runs, so the model's pending-event view
                # excludes it — hash the pool into the key (labels
                # identify deliveries schedule-robustly; raw seqs only
                # identify opaque unlabeled locals)
                pool_view = tuple(
                    (c.time, c.kind, c.node, c.label) if c.label
                    else (c.time, c.kind, c.node, c.seq) for c in cands)
                fp = digest(self.fingerprint_fn(), pool_view)
                if fp in self.seen:
                    if self.stats is not None:
                        self.stats.states_deduped += 1
                    raise _Pruned("dedup")
                self.seen.add(fp)
            if self.use_sleep:
                free = [i for i in eligible if pool[i].seq not in self.sleep]
                if not free:
                    if self.stats is not None:
                        self.stats.pruned_sleep += 1
                    raise _Pruned("sleep")
            else:
                free = eligible
            idx = self._choose(free, pool)
            snap = dict(self.sleep) if self.use_sleep else {}
        ev = pool[idx]
        self.decisions.append(Decision(
            time=round(ev.time, 9), cands=cands, chosen=ev.seq,
            default=default))
        self.choices.append(ev.seq)
        self.sleep_at.append(snap)
        if self.stats is not None:
            self.stats.decisions += 1
        return idx

    def on_dispatch(self, ev: _Event) -> None:
        super().on_dispatch(ev)
        if not self.use_sleep:
            return
        self._arm()
        if not self._armed:
            return
        if ev.seq in self.sleep:
            # a sleeping event fired with no competition: this whole
            # continuation was already covered from the sibling branch
            if self.stats is not None:
                self.stats.pruned_sleep += 1
            raise _Pruned("sleep")
        k = None if ev.meta is None else ev.meta.keys
        if self.sleep:
            self.sleep = {s: sk for s, sk in self.sleep.items()
                          if _indep(sk, k)}


# --------------------------------------------------------------------------
# Models
# --------------------------------------------------------------------------

class ClusterModel:
    """A full :class:`~repro_torch.core.cluster.Cluster` run as an explorable
    model.

    The config is forced to ``sanitize=True`` and the recording policy is
    injected through ``SimConfig.explore``.  ``go()`` runs the configured
    duration + drain, then keeps draining to quiescence (the loop is closed
    once ``_stopped`` is set, so the queue empties unless the protocol
    wedged) and re-verifies every surviving replica's full lease state.
    """

    def __init__(self, cfg, workload, policy: SchedulePolicy,
                 fail_at: Optional[Tuple[float, int]] = None,
                 max_events: int = 500_000) -> None:
        from ..core.cluster import Cluster

        cfg = replace(cfg, sanitize=True,
                      explore=ExploreConfig(policy=policy))
        self.cluster = Cluster(cfg, workload)
        self.events = self.cluster.events
        self.max_events = max_events
        if fail_at is not None:
            t, node = fail_at
            self.events.schedule(
                t, (lambda c=self.cluster, n=node: c.gcs.fail(n)))

    def go(self) -> None:
        c = self.cluster
        c.run()
        horizon = c.cfg.duration_ms + c.cfg.drain_ms + 60_000.0
        c.events.run(horizon, max_events=self.max_events)
        for r in c.replicas:
            if c.gcs.alive(r.node):
                r.lm.verify_full()

    def fingerprint(self) -> str:
        return cluster_fingerprint(self.cluster)

    def wedged(self) -> List[str]:
        if not self.cluster.events.empty():
            return ["event queue never quiesced (dispatch bound hit)"]
        return self.cluster.wedged()


# --------------------------------------------------------------------------
# Single-schedule execution
# --------------------------------------------------------------------------

def _execute(model, cfg: ExploreConfig) -> Optional[Tuple[str, str]]:
    """Run one schedule to completion; return the violation, if any.

    Raises :class:`_Pruned` / :class:`ReplayDivergence` through (the caller
    decides what they mean); converts sanitizer and assertion failures into
    ``(invariant, detail)`` tuples and appends the quiescence check.
    """
    try:
        model.go()
    except (_Pruned, ReplayDivergence):
        raise
    except SanitizerError as e:
        return (e.invariant, e.detail)
    except AssertionError as e:
        return ("assertion", str(e))
    if cfg.check_quiescence:
        w = model.wedged()
        if w:
            return ("quiescence", "; ".join(w))
    return None


def _run_one(build, cfg: ExploreConfig, stats: ExploreStats,
             prefix: List[int],
             sleep: Dict[int, Optional[FrozenSet[int]]],
             seen: Optional[Set[str]], rng=None):
    """Execute one schedule; returns (outcome, policy, violation)."""
    pol = RecorderPolicy(cfg.window_ms, prefix=prefix,
                         sleep=sleep if cfg.por else {},
                         rng=rng, change_prob=cfg.pct_change)
    if not cfg.por:
        pol.use_sleep = False
    model = build(pol)
    if cfg.dedup and seen is not None:
        pol.fingerprint_fn = model.fingerprint
        pol.seen = seen
    pol.stats = stats
    try:
        vio = _execute(model, cfg)
    except _Pruned as p:
        return (p.why, pol, None)
    stats.schedules += 1
    return ("done", pol, vio)


# --------------------------------------------------------------------------
# Strategies
# --------------------------------------------------------------------------

def _branches(pol: RecorderPolicy, cfg: ExploreConfig, stats: ExploreStats,
              stack: List) -> None:
    """Enumerate untried alternatives of a completed run (DFS, sleep sets).

    Only decisions at depth >= the forced prefix are branched — shallower
    alternatives were enqueued when the ancestor run completed.
    """
    lo = len(pol.prefix)
    hi = min(len(pol.decisions), cfg.max_depth)
    for k in range(lo, hi):
        d = pol.decisions[k]
        snap = pol.sleep_at[k] or {}
        node_sleep = dict(snap) if cfg.por else {}
        by_seq = {c.seq: c for c in d.cands}
        if cfg.por:
            chosen = by_seq[d.chosen]
            node_sleep[d.chosen] = (None if chosen.keys is None
                                    else frozenset(chosen.keys))
        for c in d.cands:
            if c.seq == d.chosen or not c.eligible:
                continue
            if cfg.por and c.seq in node_sleep:
                continue
            ckeys = None if c.keys is None else frozenset(c.keys)
            child = ({u: ku for u, ku in node_sleep.items()
                      if _indep(ku, ckeys)} if cfg.por else {})
            stack.append((pol.choices[:k] + [c.seq], child))
            stats.branches += 1
            if cfg.por:
                node_sleep[c.seq] = ckeys


def _explore_exhaustive(build, cfg: ExploreConfig, stats: ExploreStats):
    seen: Optional[Set[str]] = set() if cfg.dedup else None
    stack: List = [([], {})]
    while stack:
        if stats.runs >= cfg.max_schedules:
            stats.truncated = True
            return None
        prefix, sleep = stack.pop()
        outcome, pol, vio = _run_one(build, cfg, stats, prefix, sleep, seen)
        if outcome != "done":
            continue
        if vio is not None:
            return (pol, vio)
        _branches(pol, cfg, stats, stack)
    return None


def _explore_pct(build, cfg: ExploreConfig, stats: ExploreStats):
    seen: Optional[Set[str]] = set() if cfg.dedup else None
    for run in range(cfg.pct_seeds):
        if stats.runs >= cfg.max_schedules:
            stats.truncated = True
            return None
        # run 0 is the default FIFO schedule (rng=None): PCT results always
        # include the schedule the plain simulator would have executed
        rng = (None if run == 0
               else np.random.default_rng(cfg.seed * 10_000 + run))
        outcome, pol, vio = _run_one(build, cfg, stats, [], {}, seen,
                                     rng=rng)
        if outcome == "done" and vio is not None:
            return (pol, vio)
    return None


# --------------------------------------------------------------------------
# Minimization + replay
# --------------------------------------------------------------------------

def _run_devs(build, cfg: ExploreConfig,
              devs: Dict[int, int]) -> Tuple[RecorderPolicy,
                                             Optional[Tuple[str, str]]]:
    pol = RecorderPolicy(cfg.window_ms, devs=devs)
    model = build(pol)
    vio = _execute(model, cfg)
    return pol, vio


def minimize(build, cfg: ExploreConfig, trace: Trace) -> Trace:
    """ddmin the trace's deviations-from-FIFO to a 1-minimal counterexample.

    The minimized trace reproduces the *same invariant* (details may differ
    textually).  Falls back to the original trace if the deviation replay
    unexpectedly fails to reproduce (model nondeterminism would be a bug —
    tests pin against it).
    """
    assert trace.violation is not None
    target = trace.violation[0]

    def test(subset) -> bool:
        try:
            _, vio = _run_devs(build, cfg, dict(subset))
        except ReplayDivergence:
            return False
        return vio is not None and vio[0] == target

    devs = trace.deviations()
    if not test(devs):
        return trace
    mind = ddmin(devs, test) if devs else devs
    pol, vio = _run_devs(build, cfg, dict(mind))
    return Trace(model=trace.model, args=trace.args,
                 window_ms=cfg.window_ms, decisions=pol.decisions,
                 violation=vio)


def replay_trace(build, trace: Trace,
                 cfg: Optional[ExploreConfig] = None) -> Optional[Tuple[str, str]]:
    """Re-run a recorded schedule exactly; return the violation observed."""
    cfg = cfg or ExploreConfig(strategy="replay", window_ms=trace.window_ms)
    pol = RecorderPolicy(trace.window_ms, prefix=trace.chosen)
    pol.use_sleep = False
    model = build(pol)
    return _execute(model, cfg)


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def explore(build, cfg: ExploreConfig, model: str = "model",
            args: Optional[Dict] = None) -> ExploreResult:
    """Explore the schedule space of ``build(policy) -> model``.

    ``model``/``args`` name a :mod:`repro_torch.analysis.scenarios` entry so
    the
    emitted counterexample traces are replayable from the CLI.
    """
    stats = ExploreStats()
    if cfg.strategy == "exhaustive":
        hit = _explore_exhaustive(build, cfg, stats)
    elif cfg.strategy == "pct":
        hit = _explore_pct(build, cfg, stats)
    else:
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if hit is None:
        return ExploreResult(stats=stats)
    pol, vio = hit
    trace = Trace(model=model, args=dict(args or {}),
                  window_ms=cfg.window_ms, decisions=pol.decisions,
                  violation=vio)
    minimized = minimize(build, cfg, trace) if cfg.minimize else None
    return ExploreResult(stats=stats, violation=trace, minimized=minimized)


def explore_scenario(name: str, cfg: ExploreConfig,
                     args: Optional[Dict] = None) -> ExploreResult:
    """Explore a registered scenario by name (see analysis/scenarios.py)."""
    from .scenarios import get_scenario

    build = get_scenario(name)
    a = dict(args or {})
    return explore(lambda pol: build(a, pol), cfg, model=name, args=a)


# --------------------------------------------------------------------------
# Smoke grid (CI): explore tiny real-cluster configs, expect NO violations
# --------------------------------------------------------------------------

SMOKE_CELLS: List[Tuple[str, Dict, ExploreConfig]] = [
    # exhaustive on a 2-node / 4-class bank, both control planes x handoffs
    # (1.5 ms of simulated traffic: sized so the POR+dedup exploration
    # COMPLETES well under the budget while the naive enumeration blows
    # through it — the --check reduction-ratio gate measures exactly that)
    *[
        ("smoke-bank", {"lease_mode": lm, "handoff": ho,
                        "duration_ms": 1.5},
         ExploreConfig(strategy="exhaustive", window_ms=0.4,
                       max_schedules=600))
        for lm in ("sequential", "batched")
        for ho in ("drain", "pipelined")
    ],
    # randomized priorities on the planner-on failure-injection config
    ("smoke-planner-failure", {},
     ExploreConfig(strategy="pct", pct_seeds=12, window_ms=0.4,
                   max_schedules=64)),
]

# The batched/drain bank cell of SMOKE_CELLS with ``jax_min`` 1: every drain
# of every explored schedule launches the drain kernel and every lease
# settle runs on the device.  Kept out of SMOKE_CELLS, which (as in the
# reference) force the numpy paths so the grid stays cheap anywhere.
KERNEL_CELL: Tuple[str, Dict, ExploreConfig] = (
    "smoke-bank", {"lease_mode": "batched", "handoff": "drain",
                   "duration_ms": 1.5, "jax_min": 1},
    ExploreConfig(strategy="exhaustive", window_ms=0.4, max_schedules=600))


def run_smoke(out_dir: Optional[str] = None,
              max_schedules: Optional[int] = None,
              check_reduction: bool = False,
              quiet: bool = False, device: str = "cuda",
              record: Optional[List] = None) -> int:
    """Run the CI exploration grid on ``device``; returns a process exit
    code.

    Writes any counterexample traces into ``out_dir`` (CI uploads them as
    artifacts).  With ``check_reduction``, also measures sleep-set POR
    pruning on the first exhaustive cell and fails unless it cuts the naive
    schedule count at least 2x.  ``record``, when given, receives one
    ``(name, args, ExploreResult, seconds)`` per cell and, with
    ``check_reduction``, ``("naive", args, ExploreStats, seconds)``.
    """
    import os
    import time

    failures = 0
    reduced_runs: Dict[int, int] = {}
    say = (lambda *a: None) if quiet else print
    for i, (name, args, cfg) in enumerate(SMOKE_CELLS):
        if max_schedules is not None:
            cfg = replace(cfg, max_schedules=max_schedules)
        t0 = time.perf_counter()
        res = explore_scenario(name, cfg, dict(args, device=device))
        dt = time.perf_counter() - t0
        if record is not None:
            record.append((name, args, res, dt))
        s = res.stats
        reduced_runs[i] = s.runs
        tag = f"{name} {args}" if args else name
        rate = s.runs / dt if dt > 0 else float("inf")
        say(f"[{i + 1}/{len(SMOKE_CELLS)}] {tag}: "
            f"{s.schedules} schedules ({s.pruned_sleep} sleep-pruned, "
            f"{s.states_deduped} deduped, {s.branches} branches) "
            f"in {dt:.2f}s ({rate:.0f} runs/s)"
            f"{' [truncated]' if s.truncated else ''}")
        if not res.ok:
            failures += 1
            inv, detail = res.violation.violation
            say(f"    VIOLATION [{inv}] {detail}")
            if out_dir is not None:
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(out_dir, f"counterexample-{i + 1}.json")
                save_trace(path, res.minimized or res.violation)
                say(f"    minimized counterexample -> {path} "
                    f"(repro-torch-explore replay {path})")
    if check_reduction:
        name, args, cfg = SMOKE_CELLS[0]
        if max_schedules is not None:
            cfg = replace(cfg, max_schedules=max_schedules)
        naive = ExploreStats()
        base = replace(cfg, por=False, dedup=False, minimize=False)
        t0 = time.perf_counter()
        _explore_exhaustive(
            lambda pol: _smoke_build(name, dict(args, device=device), pol),
            base, naive)
        if record is not None:
            record.append(("naive", args, naive, time.perf_counter() - t0))
        red = max(1, reduced_runs.get(0, 1))
        ratio = naive.runs / red
        say(f"POR reduction on {name} {args}: naive {naive.runs} runs vs "
            f"{red} reduced -> {ratio:.1f}x")
        if ratio < 2.0:
            say("    FAIL: reduction ratio below 2x")
            failures += 1
    return 1 if failures else 0


def _smoke_build(name: str, args: Dict, pol: SchedulePolicy):
    from .scenarios import get_scenario

    return get_scenario(name)(dict(args), pol)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _main_replay(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-explore replay",
        description="Deterministically re-run a counterexample trace.")
    ap.add_argument("trace", help="trace JSON emitted by the explorer")
    ap.add_argument("--trace-out", "--trace", dest="trace_out", default=None,
                    metavar="OUT.json",
                    help="also export a repro_torch.obs timeline of the "
                         "replay (Perfetto trace_event JSON): per-delivery "
                         "dispatch instants on per-node tracks, so the "
                         "minimized counterexample is visually "
                         "inspectable")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the replayed model runs (overrides the "
                         "trace's)")
    ns = ap.parse_args(argv)
    from .scenarios import get_scenario

    trace = load_trace(ns.trace)
    build = get_scenario(trace.model)
    rec = None
    if ns.trace_out:
        # installed module-wide so the scenario's EventQueue (constructed
        # inside replay_trace) captures it at construction
        from ..obs import trace as obs_trace

        rec = obs_trace.TraceRecorder()
        obs_trace.install(rec)
    try:
        vio = replay_trace(
            lambda pol: build(dict(trace.args, device=ns.device), pol),
            trace)
    except ReplayDivergence as e:
        print(f"replay DIVERGED: {e}")
        return 2
    finally:
        if rec is not None:
            from ..obs import trace as obs_trace

            obs_trace.uninstall()
            rec.export(ns.trace_out)
            print(f"timeline: {len(rec)} events -> {ns.trace_out}")
    want = trace.violation
    if vio is None and want is None:
        print("replay clean (trace recorded no violation)")
        return 0
    if vio is not None and want is not None and vio[0] == want[0]:
        print(f"reproduced [{vio[0]}] {vio[1]}")
        return 0
    print(f"replay MISMATCH: trace recorded {want}, replay got {vio}")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "replay":
        return _main_replay(argv[1:])
    ap = argparse.ArgumentParser(
        prog="repro-torch-explore",
        description="Model-check the lease protocol across event "
                    "interleavings (see README: Schedule-space explorer).")
    ap.add_argument("--smoke", action="store_true",
                    help="run the bounded CI exploration grid")
    ap.add_argument("--check", action="store_true",
                    help="with --smoke: also assert POR reduction >= 2x")
    ap.add_argument("--scenario", help="explore one registered scenario")
    ap.add_argument("--strategy", default="exhaustive",
                    choices=["exhaustive", "pct"])
    ap.add_argument("--window-ms", type=float, default=0.4)
    ap.add_argument("--max-schedules", type=int, default=None)
    ap.add_argument("--pct-seeds", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-por", action="store_true")
    ap.add_argument("--no-dedup", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for counterexample traces")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the explored models run")
    ns = ap.parse_args(argv)
    if ns.list:
        from .scenarios import SCENARIOS

        for name in sorted(SCENARIOS):
            print(name)
        return 0
    if ns.smoke:
        return run_smoke(out_dir=ns.out, max_schedules=ns.max_schedules,
                         check_reduction=ns.check, device=ns.device)
    if ns.scenario:
        cfg = ExploreConfig(
            strategy=ns.strategy, window_ms=ns.window_ms,
            max_schedules=ns.max_schedules or 2000,
            pct_seeds=ns.pct_seeds, seed=ns.seed,
            por=not ns.no_por, dedup=not ns.no_dedup)
        res = explore_scenario(ns.scenario, cfg, {"device": ns.device})
        s = res.stats
        print(f"{ns.scenario}: {s.schedules} schedules "
              f"({s.pruned_sleep} sleep-pruned, {s.states_deduped} deduped)"
              f"{' [truncated]' if s.truncated else ''}")
        if res.ok:
            print("no violation found")
            return 0
        inv, detail = res.violation.violation
        print(f"VIOLATION [{inv}] {detail}")
        tr = res.minimized or res.violation
        print(f"minimized to {len(tr.deviations())} deviation(s) from the "
              f"default schedule")
        if ns.out:
            import os

            os.makedirs(ns.out, exist_ok=True)
            path = os.path.join(ns.out, f"counterexample-{ns.scenario}.json")
            save_trace(path, tr)
            print(f"trace -> {path} (repro-torch-explore replay {path})")
        return 1
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
