"""id-dtype: protocol id arrays are int32 end to end.

The bug class: an int32 read-log buffer viewed through ``np.frombuffer``
without an explicit dtype reads at the platform default width (int64),
silently interleaving garbage ids.  The rule bans dtype-less
``frombuffer`` everywhere (numpy's and ``torch.frombuffer``) and flags
id-named arrays and tensors (class/slot/sid/req/proc/owner/item) created
or cast as int64: ``np.int64`` and ``torch.int64`` / ``torch.long``
dtypes, ``.astype``/``.view``/``.to``/``.type`` casts and ``.long()``.
Every kernel boundary takes ids as int32 (the ctypes launchers read
``int32_t``), so int64 id tensors are a per-dispatch conversion at best
and a width bug at worst.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .. import astutil
from ..lint import FileCtx, Violation

# creator -> positional index of its dtype argument (None: kwarg-only)
CREATORS = {"asarray": 1, "array": 1, "empty": 1, "zeros": 1, "ones": 1,
            "full": 2, "fromiter": 1, "arange": None, "tensor": None,
            "as_tensor": None}
# creators whose first positional argument is a shape, not data — names in
# a shape (counts like n_items) are not id payloads
SHAPE_FIRST = {"empty", "zeros", "ones", "full"}


def _is_int64(e: Optional[ast.expr]) -> bool:
    if e is None:
        return False
    return (isinstance(e, ast.Attribute) and e.attr in ("int64", "long")) \
        or (isinstance(e, ast.Name) and e.id == "int64") or \
        (isinstance(e, ast.Constant) and e.value == "int64")


def _mentioned_id(exprs) -> Optional[str]:
    for expr in exprs:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and astutil.is_id_name(sub.id):
                return sub.id
            if isinstance(sub, ast.Attribute) \
                    and astutil.is_id_name(sub.attr):
                return sub.attr
    return None


class Rule:
    id = "id-dtype"
    doc = ("np/torch.frombuffer needs an explicit dtype, and id-named "
           "arrays and tensors (cc/sid/slot/req/proc/owner/item) must not "
           "be created or cast as int64 (torch.long, .long()) — ids are "
           "int32 end to end")

    def check(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        targets = astutil.assign_targets(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node)
            attr = name.split(".")[-1]
            if attr == "frombuffer":
                if astutil.kwarg(node, "dtype") is None \
                        and len(node.args) < 2:
                    out.append(ctx.violation(
                        node, self.id,
                        f"{name} without an explicit dtype views the "
                        f"buffer at a default width"))
                continue
            dty = None
            data_args: List[ast.expr] = []
            if attr in CREATORS:
                dty = astutil.kwarg(node, "dtype")
                pos = CREATORS[attr]
                if dty is None and pos is not None and len(node.args) > pos:
                    dty = node.args[pos]
                skip = 1 if attr in SHAPE_FIRST else 0
                data_args = [a for a in node.args[skip:] if a is not dty]
            elif attr in ("astype", "view", "to", "type", "long") \
                    and isinstance(node.func, ast.Attribute):
                if attr == "long":
                    dty = ast.Constant("int64")
                else:
                    dty = astutil.kwarg(node, "dtype") or (
                        node.args[0] if node.args else None)
                data_args = [node.func.value]
            else:
                continue
            if not _is_int64(dty):
                continue
            # binding name first (`versions = np.zeros(..., np.int64)` is a
            # version vector even if a count like n_items sits in its
            # shape), then id names in the *data* arguments — shapes and
            # dtypes never carry id payloads
            ident = targets.get(id(node))
            if not astutil.is_id_name(ident):
                ident = _mentioned_id(data_args)
            if ident:
                out.append(ctx.violation(
                    node, self.id,
                    f"int64 id array '{ident}' — protocol ids are int32 "
                    f"end to end"))
        return out


RULE = Rule()
