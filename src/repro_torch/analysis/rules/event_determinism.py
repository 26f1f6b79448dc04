"""event-determinism: core/ event code must be schedule-reproducible.

The explorer (repro_torch.analysis.explore) re-executes the simulator once
per schedule and trusts that a run is a pure function of its decision trace.
Three bug classes silently break that contract, and each has bitten a
model checker before:

* **wall-clock reads** (``time.time`` & friends) — real time differs
  between runs, so any branch on it makes replay diverge;
* **unordered set iteration feeding scheduling decisions** — ``for x in
  some_set: events.schedule(...)`` dispatches in hash order, which varies
  with PYTHONHASHSEED and insertion history (iterate ``sorted(s)``);
* **id()-based ordering** — ``sorted(key=id)`` or ``id(a) < id(b)`` orders
  by allocation address, fresh every process.  Plain ``id()`` *membership*
  (``id(x) in seen``) is deterministic within a run and stays legal.

The rule only patrols ``core/`` — analysis/benchmark code may time itself.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .. import astutil
from ..lint import FileCtx, Violation

WALL_CLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}

# attribute-call names that commit a scheduling decision
SCHED_CALLS = {"schedule", "at", "oa_broadcast", "ur_broadcast", "send",
               "broadcast", "call_later"}

ORDERING_FNS = {"sorted", "min", "max", "sort"}


def _is_set_expr(e: ast.expr, set_names: Set[str]) -> bool:
    """Conservatively: is this expression an unordered set?"""
    if isinstance(e, ast.Set):
        return True
    if isinstance(e, ast.Call):
        fn = astutil.call_name(e).split(".")[-1]
        return fn in ("set", "frozenset")
    if isinstance(e, ast.Name):
        return e.id in set_names
    if isinstance(e, ast.BinOp) and isinstance(
            e.op, (ast.BitAnd, ast.BitOr, ast.Sub)):
        return _is_set_expr(e.left, set_names) or \
            _is_set_expr(e.right, set_names)
    return False


def _local_set_names(fn: ast.AST) -> Set[str]:
    """Names bound to set literals / set() calls inside this function."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            if _is_set_expr(node.value, out):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _schedules_inside(body) -> Optional[ast.Call]:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                name = astutil.call_name(node).split(".")[-1]
                if name in SCHED_CALLS:
                    return node
    return None


def _is_id_func(e: Optional[ast.expr]) -> bool:
    return isinstance(e, ast.Name) and e.id == "id"


class Rule:
    id = "event-determinism"
    doc = ("core/ event code must be schedule-reproducible: no wall-clock "
           "reads, no unordered-set iteration feeding scheduling calls, "
           "no id()-based ordering")

    def check(self, ctx: FileCtx) -> List[Violation]:
        if "/core/" not in f"/{ctx.rel}":
            return []
        out: List[Violation] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = astutil.call_name(node)
                if name in WALL_CLOCK or name.split(".", 1)[-1] in WALL_CLOCK:
                    out.append(ctx.violation(
                        node, self.id,
                        f"wall-clock read '{name}' — the simulator runs on "
                        f"virtual time; real time diverges across replays"))
                    continue
                # sorted/min/max(..., key=id) and .sort(key=id)
                tail = name.split(".")[-1]
                if tail in ORDERING_FNS and \
                        _is_id_func(astutil.kwarg(node, "key")):
                    out.append(ctx.violation(
                        node, self.id,
                        f"'{tail}' ordered by id() — allocation addresses "
                        f"are fresh every process; order by a stable field"))
            elif isinstance(node, ast.Compare):
                # id(a) < id(b) is address ordering; id(x) in seen is a
                # legal identity-membership idiom and stays quiet
                operands = [node.left] + list(node.comparators)
                if any(isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
                       for op in node.ops) and \
                        any(isinstance(o, ast.Call) and _is_id_func(o.func)
                            for o in operands):
                    out.append(ctx.violation(
                        node, self.id,
                        "comparison of id() values orders by allocation "
                        "address — fresh every process"))
        # unordered iteration feeding scheduling (set-bound names resolved
        # file-wide; conservative but deterministic)
        set_names = _local_set_names(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.For):
                continue
            if not _is_set_expr(node.iter, set_names):
                continue
            call = _schedules_inside(node.body)
            if call is not None:
                out.append(ctx.violation(
                    node, self.id,
                    f"iterating an unordered set drives "
                    f"'{astutil.call_name(call).split('.')[-1]}' — "
                    f"dispatch order follows hash order; iterate "
                    f"sorted(...)"))
        return out


RULE = Rule()
