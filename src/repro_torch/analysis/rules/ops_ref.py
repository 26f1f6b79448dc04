"""ops-ref-parity: every public op in kernels/ops.py has a numpy twin.

The equivalence contract the whole port leans on: each kernel dispatch
(``kernels/ops.py``) must reach a plain twin in the port's own
``kernels/ref.py`` (what a CPU tensor runs, and the oracle the card
checks each kernel against), and a test under tests/ must actually
exercise the op by name.  An op without a twin has no oracle; an op
without a test has an unpinned one.  ``ref_path`` names the twin file
(the reference's rule reads ``src/repro/kernels/ref.py``).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from ..lint import FileCtx, Violation


REF_PATH = "src/repro_torch/kernels/ref.py"


class Rule:
    id = "ops-ref-parity"
    doc = ("every public op in kernels/ops.py must reach a kernels/ref.py "
           "twin and be exercised by name in a test under tests/")

    def __init__(self, ref_path: str = REF_PATH) -> None:
        self.ref_path = ref_path

    def check(self, ctx: FileCtx) -> List[Violation]:
        if not ctx.rel.endswith("kernels/ops.py"):
            return []
        ref_src = ctx.project.read_text(self.ref_path)
        if ref_src is None:
            return [Violation(ctx.rel, 0, self.id,
                              "kernels/ref.py missing: no twin registry")]
        ref_defs = {n.name for n in ast.parse(ref_src).body
                    if isinstance(n, ast.FunctionDef)}
        fns = {n.name: n for n in ctx.tree.body
               if isinstance(n, ast.FunctionDef)}
        refs: Dict[str, Set[str]] = {}
        calls: Dict[str, Set[str]] = {}
        for name, fn in fns.items():
            rr: Set[str] = set()
            cc: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "ref" \
                        and node.attr in ref_defs:
                    rr.add(node.attr)
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name):
                    cc.add(node.func.id)
            refs[name], calls[name] = rr, cc
        # propagate twin reachability through module-local helpers
        changed = True
        while changed:
            changed = False
            for name in fns:
                for callee in calls[name] & fns.keys():
                    extra = refs[callee] - refs[name]
                    if extra:
                        refs[name] |= extra
                        changed = True
        tests = ctx.project.tests_text()
        out: List[Violation] = []
        for name, fn in fns.items():
            if name.startswith("_"):
                continue
            if not refs[name]:
                out.append(ctx.violation(
                    fn, self.id,
                    f"public op '{name}' reaches no kernels/ref.py twin — "
                    f"no oracle"))
            elif name not in tests:
                out.append(ctx.violation(
                    fn, self.id,
                    f"public op '{name}' is never exercised by name in "
                    f"tests/ — parity unpinned"))
        return out


RULE = Rule()
