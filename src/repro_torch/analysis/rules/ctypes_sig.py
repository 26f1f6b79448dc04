"""ctypes-sig: each ctypes launcher table matches its ``extern "C"`` source.

The port's silent declaration.  A kernel library is declared as
``CudaLibrary(name, {fname: (argtypes, restype)})`` and built from
``csrc/<name>.cu``; ctypes trusts the table.  A dropped argument shifts
every later one into the wrong register, and ``c_int`` where the C side
takes ``long long`` passes half a value: the call goes through and the
kernel reads garbage — as a jax ``static_argnames`` entry that names no
parameter is silently ignored (the reference's ``static-args`` rule).

Each table entry must name an ``extern "C"`` function of the library's
source with the same arity and, position by position, the matching kind:
a pointer to anything but ``int`` / ``long long`` / ``void*`` ↔
``c_void_p``; ``int`` ↔ ``c_int``; ``long long`` ↔ ``c_longlong``;
``float`` ↔ ``c_float``; ``double`` ↔ ``c_double``; ``int*`` /
``long long*`` / ``void**`` ↔ ``POINTER(c_int / c_longlong / c_void_p)``;
and the return type likewise.  The table is evaluated from the source
text (list literals, ``*`` and ``+``, module-level aliases); the C
signatures are read with a regex over ``extern "C" <type> <name>(...)``.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional

from .. import astutil
from ..lint import FileCtx, Violation

EXTERN_RE = re.compile(
    r'extern\s+"C"\s+([A-Za-z_][\w\s\*]*?)\s*\b([A-Za-z_]\w*)\s*\(([^)]*)\)',
    re.S)
CTYPES = {"c_void_p": "void*", "c_int": "int", "c_int32": "int",
          "c_longlong": "long long", "c_int64": "long long",
          "c_float": "float", "c_double": "double"}
POINTEES = {"int", "long long", "void*"}


def c_kind(decl: str) -> str:
    """The ctypes kind a C parameter or return type needs: ``void*`` for an
    opaque pointer, ``int*`` / ``long long*`` / ``void**`` for the pointers
    ctypes types with POINTER, else the scalar type."""
    decl = re.sub(r"\b(const|volatile|restrict|__restrict__)\b", " ", decl)
    stars = decl.count("*")
    words = decl.replace("*", " ").split()
    # the last word is the parameter's name unless the type stands alone
    if len(words) > 1 and words[-1] not in ("int", "long", "float",
                                            "double", "void", "char"):
        words = words[:-1]
    base = " ".join(w for w in words if w not in ("signed",))
    base = {"long long int": "long long", "int32_t": "int",
            "int64_t": "long long"}.get(base, base)
    if stars == 0:
        return base
    pointee = base + "*" * (stars - 1)
    return pointee + "*" if pointee in POINTEES else "void*"


def c_signatures(text: str) -> Dict[str, tuple]:
    """``{name: (return kind, [parameter kinds])}`` of every ``extern "C"``
    function in ``text`` (comments stripped)."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", " ", text, flags=re.S)
    out = {}
    for ret, name, params in EXTERN_RE.findall(text):
        params = params.strip()
        kinds = [] if params in ("", "void") else \
            [c_kind(p) for p in params.split(",")]
        out[name] = (c_kind(ret), kinds)
    return out


class _Table:
    """Evaluates argtypes expressions to lists of C kinds."""

    def __init__(self, aliases: Dict[str, ast.expr]) -> None:
        self.aliases = aliases

    def kind(self, e: ast.expr) -> Optional[str]:
        if isinstance(e, ast.Name) and e.id in self.aliases:
            return self.kind(self.aliases[e.id])
        if isinstance(e, (ast.Name, ast.Attribute)):
            name = e.id if isinstance(e, ast.Name) else e.attr
            return CTYPES.get(name)
        if isinstance(e, ast.Call) and \
                astutil.call_name(e).split(".")[-1] == "POINTER" and e.args:
            inner = self.kind(e.args[0])
            return None if inner is None else inner + "*"
        return None

    def kinds(self, e: ast.expr) -> Optional[List[str]]:
        if isinstance(e, ast.Name) and e.id in self.aliases:
            return self.kinds(self.aliases[e.id])
        if isinstance(e, (ast.List, ast.Tuple)):
            out = [self.kind(x) for x in e.elts]
            return None if None in out else out
        if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add):
            a, b = self.kinds(e.left), self.kinds(e.right)
            return None if a is None or b is None else a + b
        if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Mult):
            seq, n = e.left, e.right
            if isinstance(seq, ast.Constant):
                seq, n = n, seq
            items = self.kinds(seq)
            if items is None or not isinstance(n, ast.Constant) \
                    or not isinstance(n.value, int):
                return None
            return items * n.value
        return None


class Rule:
    id = "ctypes-sig"
    doc = ("each CudaLibrary(name, {fname: (argtypes, restype)}) entry must "
           "name an extern \"C\" function of csrc/<name>.cu with the same "
           "arity and matching argument and return kinds")

    def check(self, ctx: FileCtx) -> List[Violation]:
        aliases = {t.id: n.value for n in ctx.tree.body
                   if isinstance(n, ast.Assign)
                   for t in n.targets if isinstance(t, ast.Name)}
        table = _Table(aliases)
        out: List[Violation] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and astutil.call_name(
                    node).split(".")[-1] == "CudaLibrary"
                    and len(node.args) >= 2
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[1], ast.Dict)):
                continue
            lib = node.args[0].value
            src = Path(ctx.path).parent / "csrc" / f"{lib}.cu"
            try:
                sigs = c_signatures(src.read_text())
            except OSError:
                out.append(ctx.violation(
                    node, self.id, f"library '{lib}' has no csrc/{lib}.cu"))
                continue
            for key, entry in zip(node.args[1].keys, node.args[1].values):
                if not isinstance(key, ast.Constant):
                    continue
                out.extend(self._entry(ctx, lib, key.value, entry, sigs,
                                       table))
        return out

    def _entry(self, ctx, lib, fname, entry, sigs, table) -> List[Violation]:
        def bad(msg):
            return [ctx.violation(entry, self.id,
                                  f"{lib}.{fname}: {msg}")]

        if fname not in sigs:
            return bad(f"no extern \"C\" function '{fname}' in "
                       f"csrc/{lib}.cu")
        if not (isinstance(entry, ast.Tuple) and len(entry.elts) == 2):
            return bad("entry is not an (argtypes, restype) pair")
        want_ret, want = sigs[fname]
        got = table.kinds(entry.elts[0])
        got_ret = table.kind(entry.elts[1])
        if got is None or got_ret is None:
            return bad("argtypes/restype the lint cannot evaluate")
        if len(got) != len(want):
            return bad(f"{len(got)} argtypes, the C function takes "
                       f"{len(want)}")
        out = []
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                out += bad(f"argument {i} is declared {g}, the C "
                           f"function takes {w}")
        if got_ret != want_ret:
            out += bad(f"restype is {got_ret}, the C function returns "
                       f"{want_ret}")
        return out


RULE = Rule()
