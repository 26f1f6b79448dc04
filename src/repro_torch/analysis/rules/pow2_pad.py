"""pow2-pad: compact axes feeding a kernel dispatch are pow2-padded.

The port has no jit to retrace, but its dispatches still take bucketed
shapes, for two reasons.  The drain's staging area is laid out from the
packed widths (``kernels/lease_validate.py``'s ``drain_layout``) and
grows only in powers of two, so one area serves every drain of its store
and the launcher's variant choice sees few distinct (B, R, W); and the
packing is the reference's, bucket for bucket (``_pad_bucket`` at
``core/stm.py:262``, ``_pow2`` at ``core/lease_batched.py:44``), so the
CPU tests hold the two packages to each other shape for shape and the
drain and settle verdicts bit for bit.  Feeding a dispatch arrays sized by
raw ``len(...)``/``.size`` breaks both.  Every compact axis that crosses
the boundary is blessed through ``_pow2``/``_pad_bucket`` first.  Only
allocations actually passed to a dispatch call are checked — host-side
temporaries may size freely.  ``dispatchers`` names the dispatch calls
(the reference's rule names its jit'd ones).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from .. import astutil
from ..lint import FileCtx, Violation

# kernels/ops.py's dispatches, core/stm.py's entry, and the wrappers that
# launch the kernels (kernels/lease_validate.py, flash_attention.py,
# ssd_scan.py)
DISPATCHERS = {"settle_lease_batch", "validate_transactions",
               "validate_batch", "certify_drain", "attention", "ssd",
               "moe_combine", "lease_validate", "lease_drain",
               "flash_attention", "ssd_scan", "tc_states", "tc_outputs"}
ALLOC = {"full", "zeros", "empty", "ones"}
BLESS = re.compile(r"pow2|pad_bucket|next_pow|round_up")


class Rule:
    id = "pow2-pad"
    doc = ("arrays passed to a kernel dispatch must have their compact "
           "axes blessed through _pow2/_pad_bucket, not raw len()/.size")

    def __init__(self, dispatchers=frozenset(DISPATCHERS)) -> None:
        self.dispatchers = set(dispatchers)

    def check(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        for fn in (n for n in ast.walk(ctx.tree)
                   if isinstance(n, ast.FunctionDef)):
            dispatch_args: Set[str] = set()
            for c in ast.walk(fn):
                if isinstance(c, ast.Call) and astutil.call_name(
                        c).split(".")[-1] in self.dispatchers:
                    for a in list(c.args) + [kw.value for kw in c.keywords]:
                        for sub in ast.walk(a):
                            if isinstance(sub, ast.Name):
                                dispatch_args.add(sub.id)
            if not dispatch_args:
                continue
            # last-wins local dataflow: name -> source callee/attr
            env: Dict[str, str] = {}
            targets = astutil.assign_targets(fn)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    v = node.value
                    if isinstance(v, ast.Call):
                        env[node.targets[0].id] = \
                            astutil.call_name(v).split(".")[-1]
                    elif isinstance(v, ast.Attribute):
                        env[node.targets[0].id] = v.attr
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call) and astutil.call_name(
                        node).split(".")[-1] in ALLOC and node.args):
                    continue
                if targets.get(id(node)) not in dispatch_args:
                    continue
                shape = node.args[0]
                elts = shape.elts if isinstance(
                    shape, (ast.Tuple, ast.List)) else [shape]
                for e in elts:
                    bad = None
                    if isinstance(e, ast.Call) and astutil.call_name(
                            e) == "len":
                        bad = "len(...)"
                    elif isinstance(e, ast.Attribute) and e.attr == "size":
                        bad = ".size"
                    elif isinstance(e, ast.Name):
                        src = env.get(e.id, "")
                        if src in ("len", "size", "shape"):
                            bad = f"'{e.id}' (= {src})"
                        elif src and BLESS.search(src):
                            continue
                    if bad:
                        out.append(ctx.violation(
                            node, self.id,
                            f"unpadded compact axis {bad} allocated for "
                            f"kernel dispatch in '{fn.name}' — bless "
                            f"through _pow2/_pad_bucket"))
        return out


RULE = Rule()
