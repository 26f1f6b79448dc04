"""state-mutation: replicated protocol state has exactly one owner module.

``VersionedStore`` arrays and the lease managers' queue/cell state are
replicated via total order — an out-of-band write at one replica silently
diverges the cluster.  Everyone outside the owning module goes through the
manager API (``apply_batch``, ``grow_to``, the ``on_*`` protocol events).
"""
from __future__ import annotations

import ast
from typing import List

from ..lint import FileCtx, Violation

# VersionedStore internals (owner: core/stm.py)
STORE_ATTRS = {"values", "versions", "clock", "n_items"}
# lease-manager structural state (owners: core/lease.py,
# core/lease_batched.py); n_slots is deliberately absent — too generic
# (CpuMeter, KVStore slabs) and never moves without slot_of/qlen anyway
LEASE_STRICT = {"cq", "qlen", "slot_of", "row_of",
                "_by_req", "_pending_opt", "_pending_cnt", "_dead"}
# per-cell arrays: common names, so only subscripted stores are flagged
LEASE_CELLS = {"blocked", "active", "req", "proc"}

OWNERS = ("core/stm.py", "core/lease.py", "core/lease_batched.py")


def _flat_targets(node):
    tgts = []
    if isinstance(node, ast.Assign):
        tgts = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        tgts = [node.target]
    out = []
    while tgts:
        t = tgts.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            tgts.extend(t.elts)
        else:
            out.append(t)
    return out


class Rule:
    id = "state-mutation"
    doc = ("VersionedStore / lease-manager replicated state is mutated "
           "only by its owning core module; use the manager API elsewhere")

    def check(self, ctx: FileCtx) -> List[Violation]:
        if ctx.rel.endswith(OWNERS):
            return []
        out: List[Violation] = []
        for node in ast.walk(ctx.tree):
            for t in _flat_targets(node):
                sub = isinstance(t, ast.Subscript)
                base = t.value if sub else t
                if not isinstance(base, ast.Attribute):
                    continue
                a = base.attr
                if a in STORE_ATTRS or a in LEASE_STRICT \
                        or (sub and a in LEASE_CELLS):
                    out.append(ctx.violation(
                        node, self.id,
                        f"mutation of protected protocol state '.{a}' "
                        f"outside its owning module"))
        return out


RULE = Rule()
