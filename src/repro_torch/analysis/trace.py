"""Replayable schedule traces + delta-debugging minimization.

A trace is the full record of one explored schedule's branching decisions:
at every point where more than one enabled event was dispatchable, the
candidate pool (with delivery metadata) and the chosen event.  Traces are
JSON so a counterexample survives as a CI artifact and replays with
``repro-torch-explore replay <trace.json>`` — the recording policy re-runs the
model forcing each recorded choice, which is deterministic because event
``seq`` numbers are a pure function of the choice prefix.

``ddmin`` is the classic minimizing delta debugger (Zeller): applied here
to the schedule's *deviations from the default order* — the decisions
where the explored schedule departed from first-eligible-FIFO — so a
minimized counterexample reads as "the default schedule plus these K
reorderings".
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Cand:
    """One dispatchable candidate at a decision point."""

    seq: int
    time: float
    kind: str = "local"
    node: int = -1
    label: str = ""
    keys: Optional[Tuple[int, ...]] = None
    eligible: bool = True


@dataclass
class Decision:
    """One branching point: the pool, the choice, and the FIFO default."""

    time: float
    cands: List[Cand]
    chosen: int                    # seq of the dispatched event
    default: int                   # seq first-eligible FIFO would have picked


@dataclass
class Trace:
    model: str
    args: Dict = field(default_factory=dict)
    window_ms: float = 0.0
    decisions: List[Decision] = field(default_factory=list)
    violation: Optional[Tuple[str, str]] = None   # (invariant, detail)

    @property
    def chosen(self) -> List[int]:
        return [d.chosen for d in self.decisions]

    def deviations(self) -> List[Tuple[int, int]]:
        """(decision index, chosen seq) where the run departed from FIFO."""
        return [(i, d.chosen) for i, d in enumerate(self.decisions)
                if d.chosen != d.default]

    # -- JSON ----------------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "version": 1,
            "model": self.model,
            "args": self.args,
            "window_ms": self.window_ms,
            "violation": (None if self.violation is None
                          else {"invariant": self.violation[0],
                                "detail": self.violation[1]}),
            "decisions": [
                {
                    "t": d.time,
                    "chosen": d.chosen,
                    "default": d.default,
                    "cands": [
                        {"seq": c.seq, "t": c.time, "kind": c.kind,
                         "node": c.node, "label": c.label,
                         "keys": None if c.keys is None else sorted(c.keys),
                         "eligible": c.eligible}
                        for c in d.cands
                    ],
                }
                for d in self.decisions
            ],
        }

    @classmethod
    def from_json(cls, obj: Dict) -> "Trace":
        vio = obj.get("violation")
        return cls(
            model=obj["model"],
            args=dict(obj.get("args") or {}),
            window_ms=float(obj.get("window_ms", 0.0)),
            violation=None if vio is None
            else (vio["invariant"], vio["detail"]),
            decisions=[
                Decision(
                    time=float(d["t"]),
                    chosen=int(d["chosen"]),
                    default=int(d["default"]),
                    cands=[
                        Cand(seq=int(c["seq"]), time=float(c["t"]),
                             kind=c.get("kind", "local"),
                             node=int(c.get("node", -1)),
                             label=c.get("label", ""),
                             keys=None if c.get("keys") is None
                             else tuple(c["keys"]),
                             eligible=bool(c.get("eligible", True)))
                        for c in d["cands"]
                    ],
                )
                for d in obj.get("decisions", [])
            ],
        )


def save_trace(path, trace: Trace) -> None:
    with open(path, "w") as f:
        json.dump(trace.to_json(), f, indent=1, sort_keys=True)
        f.write("\n")


def load_trace(path) -> Trace:
    with open(path) as f:
        return Trace.from_json(json.load(f))


def ddmin(items: Sequence, test: Callable[[List], bool]) -> List:
    """Zeller's minimizing delta debugger.

    ``test(subset)`` must return True iff the failure still reproduces
    with only that subset applied; ``test(items)`` must be True on entry.
    Returns a 1-minimal failing subset (removing any single element makes
    the failure vanish).
    """
    items = list(items)
    n = 2
    while len(items) >= 2:
        size = len(items)
        chunk = max(1, size // n)
        chunks = [items[i: i + chunk] for i in range(0, size, chunk)]
        reduced = False
        for c in chunks:
            if len(c) < size and test(c):
                items, n, reduced = c, 2, True
                break
        if not reduced:
            for c in chunks:
                comp = [x for x in items if x not in c]
                if 0 < len(comp) < size and test(comp):
                    items, n, reduced = comp, max(n - 1, 2), True
                    break
        if not reduced:
            if n >= size:
                break
            n = min(size, 2 * n)
    return items
