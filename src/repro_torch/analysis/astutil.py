"""Shared AST helpers for the lint rules (stdlib-only by design)."""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Union

# name tokens that mark an array as carrying protocol identifiers
# (conflict classes, sessions, queue slots, requests, replicas, items)
ID_TOKENS = {"cc", "sid", "slot", "req", "rid", "proc", "owner", "item",
             "cls", "lor"}

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]

# Modules whose code runs on the device's stream per step or per drain.
# Every function of the first group is a hot body; in the second only the
# device paths are, the functions that name ``torch`` (the rest of
# serve/ and the core modules is host bookkeeping over numpy and lists).
HOT_EVERYWHERE = ("kernels/", "models/", "plan/score.py")
HOT_DEVICE_PATHS = ("serve/", "core/stm.py", "core/lease_batched.py")
NOT_HOT = ("kernels/nvcc.py",)      # the build, not a step


def is_id_name(name: Optional[str]) -> bool:
    """True if ``name`` reads like a protocol-id binding (``ccs_l``,
    ``head_rid``, ``_item_cc``, ...)."""
    if not name:
        return False
    for tok in name.lower().split("_"):
        if tok in ID_TOKENS or (tok.endswith("s") and tok[:-1] in ID_TOKENS):
            return True
    return False


def _in(rel: str, parts) -> bool:
    rel = "/" + rel
    return any(f"/{p}" in rel if p.endswith("/") else rel.endswith(f"/{p}")
               for p in parts)


def outer_functions(tree: ast.AST) -> Iterator[FunctionNode]:
    """Module-level functions and methods (nested defs stay inside the
    function that holds them)."""
    stack = list(getattr(tree, "body", []))
    while stack:
        node = stack.pop(0)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
        elif isinstance(node, ast.ClassDef):
            stack[:0] = node.body


def names_torch(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) and n.id == "torch"
               for n in ast.walk(fn))


def hot_functions(rel: str, tree: ast.AST) -> List[FunctionNode]:
    """The hot bodies of the file at repo-relative ``rel``: every function
    of ``kernels/`` (but ``nvcc.py``), ``models/`` and ``plan/score.py``;
    the functions that name ``torch`` in ``serve/``, ``core/stm.py`` and
    ``core/lease_batched.py``; nothing elsewhere."""
    if _in(rel, NOT_HOT):
        return []
    if _in(rel, HOT_EVERYWHERE):
        return list(outer_functions(tree))
    if _in(rel, HOT_DEVICE_PATHS):
        return [f for f in outer_functions(tree) if names_torch(f)]
    return []


def call_name(node: ast.Call) -> str:
    """Dotted callee name: ``np.full(...)`` -> ``"np.full"`` ('' if exotic)."""
    f = node.func
    parts: List[str] = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    elif parts:
        parts.append("?")
    return ".".join(reversed(parts))


def call_line(node: ast.Call) -> int:
    """The line CPython reports for a call while it runs: a method call
    whose attribute sits below the start of the expression
    (``foo(...)\\n    .cpu()``) reports the attribute's line."""
    if isinstance(node.func, ast.Attribute):
        return node.func.end_lineno or node.lineno
    return node.lineno


def kwarg(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def assign_targets(tree: ast.AST) -> Dict[int, str]:
    """Map id(call-node) -> the simple name it is assigned to, for calls
    (possibly nested) on the RHS of single-target assignments."""
    out: Dict[int, str] = {}
    for node in ast.walk(tree):
        tgt = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            tgt = node.target
        value = getattr(node, "value", None)
        if tgt is None or value is None:
            continue
        if isinstance(tgt, ast.Name):
            name = tgt.id
        elif isinstance(tgt, ast.Attribute):
            name = tgt.attr
        else:
            continue
        for sub in ast.walk(value):
            if isinstance(sub, ast.Call):
                out[id(sub)] = name
    return out
