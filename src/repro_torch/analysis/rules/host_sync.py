"""host-sync: the host waits on the device only where it means to.

Eager PyTorch enqueues device work and returns at once.  A call that needs
a device value on the host stalls the host until the stream has drained
to it: ``.item()``, ``.tolist()``, ``.cpu()`` or ``.to("cpu")`` of a
device value, ``float()``/``int()``/``bool()`` of a device tensor, a
blocking host->device copy (``.to(dev)`` of a host tensor,
``torch.tensor(..., device=dev)``), an explicit ``synchronize()``, and the
ops whose output size depends on the data (``nonzero``, ``unique``,
``bincount``, ``masked_select``, ``argwhere``, a one-argument
``torch.where``, ``repeat_interleave`` with tensor repeats and no
``output_size``).  While the host waits, the device idles; a step that
waits cannot be captured in a CUDA graph.

The rule patrols *hot bodies* (:func:`..astutil.hot_functions`): the code
that runs on the device's stream per step or per drain.  Where a value
lives is inferred per function, flow-insensitively: host (numpy, Python
scalars, shapes, ``torch.from_numpy``, what ``.cpu()`` returns, torch
factories without ``device=``), device (``torch`` ops on device values,
factories with a device, parameters annotated ``Tensor``) or unknown.
Copies out (``.item()``, ``.tolist()``, ``.cpu()``) are flagged unless
the value is known to be on the host; casts, copies in and ``.numpy()``
only when it is known which side each value is on.  A sync the inference
cannot see is what the card's sync debug mode reports: chip_smoke holds
every site it observes to this rule.  A wait inside a ctypes library (the
drain's) or on a ``torch.cuda.Event`` is invisible to the debug mode; the
latter is flagged here all the same.

An intended sync carries ``# lint: allow(host-sync): <why>``.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional

from .. import astutil
from ..lint import FileCtx, Violation

HOST, DEV, UNK = "host", "device", "unknown"

HOST_MODULES = ("numpy", "math", "ctypes")
SCALAR_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad"}
SCALAR_METHODS = {"dim", "numel", "size", "element_size", "data_ptr",
                  "stride", "is_contiguous", "nelement", "get_device",
                  "storage_offset", "item", "tolist", "cpu", "numpy"}
HOST_BUILTINS = {"len", "int", "float", "bool", "str", "range", "isinstance",
                 "repr", "hash", "id", "type", "round", "divmod", "tuple",
                 "list", "dict", "set", "sorted", "enumerate", "zip"}
JOIN_BUILTINS = {"min", "max", "sum", "abs"}
# torch factories: on the CPU unless given a device
FACTORIES = {"tensor", "as_tensor", "zeros", "ones", "empty", "full",
             "arange", "rand", "randn", "randint", "eye", "linspace",
             "empty_strided", "scalar_tensor"}
COPY_OUT = {"item", "tolist", "cpu"}
DATA_SIZED = {"nonzero", "unique", "unique_consecutive", "bincount",
              "masked_select", "argwhere"}
CASTS = {"float", "int", "bool"}


def _join(kinds: Iterable[str]) -> str:
    kinds = list(kinds)
    if DEV in kinds:
        return DEV
    return HOST if all(k == HOST for k in kinds) else UNK


def _annotation_kind(ann: Optional[ast.expr]) -> str:
    if ann is None:
        return UNK
    text = ast.unparse(ann)
    if "Tensor" in text:
        return DEV
    if "ndarray" in text or text in ("int", "float", "bool", "str"):
        return HOST
    return UNK


def _is_cpu(e: Optional[ast.expr]) -> bool:
    if isinstance(e, ast.Constant):
        return e.value == "cpu"
    if isinstance(e, ast.Call) and astutil.call_name(e) == "torch.device" \
            and e.args:
        return _is_cpu(e.args[0])
    return False


def _nonblocking(c: ast.Call) -> bool:
    nb = astutil.kwarg(c, "non_blocking")
    return isinstance(nb, ast.Constant) and nb.value is True


def _to_target(c: ast.Call) -> Optional[str]:
    """What a ``.to(...)`` call moves to: "cpu", "device" or None (a dtype
    change, or nothing this can tell)."""
    dev = astutil.kwarg(c, "device")
    if dev is None and c.args:
        a = c.args[0]
        text = ast.unparse(a).lower()
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            dev = a
        elif "dtype" not in text and ("dev" in text or "cuda" in text):
            dev = a
    if dev is None:
        return None
    return "cpu" if _is_cpu(dev) else "device"


def _end(node: ast.AST) -> tuple:
    return (node.end_lineno or 0, node.end_col_offset or 0)


class _Placement:
    """Where each name of one function lives (host / device / unknown).

    A name read at some point takes the kind of its last binding above
    that point in the text (``flat = torch.from_numpy(...)`` then ``flat =
    flat.to(dev)``: the copy's receiver is the host tensor); a name read
    before any of its bindings (a loop-carried one) takes all of them."""

    def __init__(self, fn: astutil.FunctionNode, modules: Dict[str, str],
                 globals_: Dict[str, str]) -> None:
        self.modules = modules
        self.globals = globals_
        # name -> [(position the binding takes effect, thunk of its kind)]
        self.binds: Dict[str, List[tuple]] = {}
        self._memo: Dict[int, str] = {}
        self._busy: set = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                a = node.args
                at = (node.lineno, 0)
                for p in a.posonlyargs + a.args + a.kwonlyargs:
                    self._add(p.arg, at, lambda p=p: _annotation_kind(
                        p.annotation))
                for p in (a.vararg, a.kwarg):
                    if p is not None:
                        self._add(p.arg, at, lambda: UNK)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    self._bind(t, node.value, _end(node))
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                    and node.value is not None:
                self._bind(node.target, node.value, _end(node))
            elif isinstance(node, ast.NamedExpr):
                self._bind(node.target, node.value, _end(node))
            elif isinstance(node, (ast.For, ast.comprehension)):
                self._bind(node.target, node.iter, _end(node.target),
                           each=True)
            elif isinstance(node, ast.withitem) and node.optional_vars:
                self._bind(node.optional_vars, None,
                           _end(node.optional_vars))
        for bs in self.binds.values():
            bs.sort(key=lambda b: b[0])

    def _add(self, name: str, at: tuple, thunk) -> None:
        self.binds.setdefault(name, []).append((at, thunk))

    def _bind(self, target, value, at: tuple, each: bool = False) -> None:
        if isinstance(target, ast.Name):
            if value is None:
                self._add(target.id, at, lambda: UNK)
            elif each:
                self._add(target.id, at, lambda: self.element(value))
            else:
                self._add(target.id, at, lambda: self.kind(value))
        elif isinstance(target, (ast.Tuple, ast.List)):
            if each and isinstance(value, ast.Call) and \
                    astutil.call_name(value) in ("enumerate", "zip"):
                parts = list(value.args)
                if astutil.call_name(value) == "enumerate":
                    parts = [ast.Constant(0)] + parts[:1]
                if len(parts) == len(target.elts):
                    for t, v in zip(target.elts, parts):
                        self._bind(t, v, at,
                                   each=not isinstance(v, ast.Constant))
                    return
            if not each and isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._bind(t, v, at)
                return
            for t in target.elts:
                self._bind(t, value, at, each)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, value, at, each)

    def name_kind(self, name: str, at: tuple) -> str:
        bs = self.binds.get(name)
        if not bs:
            return self.globals.get(name, UNK)
        prior = [b for b in bs if b[0] <= at]
        return _join(self._eval(b) for b in (prior[-1:] or bs))

    def _eval(self, bind: tuple) -> str:
        key = id(bind)
        if key not in self._memo:
            if key in self._busy:       # a binding that reads itself
                return UNK
            self._busy.add(key)
            self._memo[key] = bind[1]()
            self._busy.discard(key)
        return self._memo[key]

    def element(self, it: ast.expr) -> str:
        """The kind of what iterating ``it`` yields."""
        if isinstance(it, ast.Call) and astutil.call_name(it) == "range":
            return HOST
        return self.kind(it)

    def module_of(self, e: ast.expr) -> Optional[str]:
        """The module a dotted name's root is bound to, if it is one."""
        while isinstance(e, ast.Attribute):
            e = e.value
        if isinstance(e, ast.Name):
            return self.modules.get(e.id)
        return None

    def kind(self, e: Optional[ast.expr]) -> str:
        if e is None or isinstance(e, (ast.Constant, ast.JoinedStr,
                                       ast.Lambda, ast.Dict)):
            return HOST
        if isinstance(e, ast.Name):
            return self.name_kind(e.id, (e.lineno, e.col_offset))
        if isinstance(e, ast.Attribute):
            if e.attr in SCALAR_ATTRS or self.module_of(e) is not None:
                return HOST
            return self.kind(e.value)
        if isinstance(e, ast.Subscript):
            return self.kind(e.value)
        if isinstance(e, (ast.Starred, ast.UnaryOp)):
            return self.kind(getattr(e, "value", None)
                             or getattr(e, "operand", None))
        if isinstance(e, ast.BinOp):
            return _join([self.kind(e.left), self.kind(e.right)])
        if isinstance(e, ast.BoolOp):
            return _join(self.kind(v) for v in e.values)
        if isinstance(e, ast.Compare):
            return _join([self.kind(e.left)]
                         + [self.kind(c) for c in e.comparators])
        if isinstance(e, ast.IfExp):
            return _join([self.kind(e.body), self.kind(e.orelse)])
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return _join(self.kind(x) for x in e.elts)
        if isinstance(e, ast.Call):
            return self.call_kind(e)
        return UNK

    def call_kind(self, c: ast.Call) -> str:
        f = c.func
        args = list(c.args) + [kw.value for kw in c.keywords]
        if isinstance(f, ast.Name):
            if f.id in HOST_BUILTINS:
                return HOST
            if f.id in JOIN_BUILTINS:
                return _join(self.kind(a) for a in args)
            return UNK
        if not isinstance(f, ast.Attribute):
            return UNK
        mod = self.module_of(f)
        if mod is not None:
            if mod.split(".")[0] in HOST_MODULES:
                return HOST
            if mod.split(".")[0] != "torch":
                return UNK
            name = astutil.call_name(c)
            if ".cuda." in f".{name}." or f.attr == "from_numpy":
                return HOST
            dev = astutil.kwarg(c, "device")
            if f.attr in FACTORIES or f.attr.endswith("_like"):
                if dev is not None:
                    return HOST if _is_cpu(dev) else DEV
                if f.attr in ("tensor", "as_tensor") \
                        or f.attr.endswith("_like"):
                    return self.kind(c.args[0]) if c.args else HOST
                return HOST
            return _join(self.kind(a) for a in args)
        if f.attr in SCALAR_METHODS:
            return HOST
        if f.attr == "cuda":
            return DEV
        if f.attr == "to":
            where = _to_target(c)
            if where is not None:
                return HOST if where == "cpu" else DEV
        return self.kind(f.value)


def _modules(tree: ast.AST) -> Dict[str, str]:
    """Names bound to modules anywhere in the file (imports inside
    functions included): ``np`` -> ``numpy``, ``F`` ->
    ``torch.nn.functional``, ``ops`` -> ``..kernels.ops``."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            for a in node.names:
                out[a.asname or a.name] = f"{base}.{a.name}"
    return out


class Rule:
    id = "host-sync"
    doc = ("no host waits on the device in hot bodies (kernels/, models/, "
           "serve/, plan/score.py and the device paths of core/stm.py and "
           "core/lease_batched.py): .item()/.tolist()/.cpu() of device "
           "values, blocking copies, synchronize(), float()/int()/bool() "
           "of tensors, data-sized ops (nonzero, unique, bincount, ...)")

    def check(self, ctx: FileCtx) -> List[Violation]:
        fns = astutil.hot_functions(ctx.rel, ctx.tree)
        if not fns:
            return []
        modules = _modules(ctx.tree)
        top = _Placement(ast.Module(body=[], type_ignores=[]), modules, {})
        globals_: Dict[str, str] = {}
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        globals_[t.id] = top.kind(node.value)
        out: List[Violation] = []
        for fn in fns:
            place = _Placement(fn, modules, globals_)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    why = self._why(node, place)
                    if why:
                        out.append(Violation(
                            ctx.rel, astutil.call_line(node), self.id,
                            f"{why} in hot body '{fn.name}'"))
        return out

    def _why(self, c: ast.Call, place: _Placement) -> Optional[str]:
        f = c.func
        kind = place.kind
        if isinstance(f, ast.Name):
            if f.id in CASTS and len(c.args) == 1 \
                    and kind(c.args[0]) == DEV:
                return f"{f.id}() of a device tensor waits for it"
            return None
        if not isinstance(f, ast.Attribute):
            return None
        name = astutil.call_name(c)
        mod = place.module_of(f)
        recv = None if mod is not None else f.value
        torch_fn = mod is not None and mod.split(".")[0] == "torch"
        if f.attr == "synchronize":
            return f"{name}() waits for the device"
        if recv is not None and f.attr in COPY_OUT \
                and kind(recv) != HOST:
            return f".{f.attr}() copies a device value to the host and waits"
        if recv is not None and f.attr == "numpy" and kind(recv) == DEV:
            return ".numpy() of a device tensor"
        if recv is not None and f.attr in ("to", "cuda") \
                and not _nonblocking(c):
            where = "device" if f.attr == "cuda" else _to_target(c)
            if where == "cpu" and kind(recv) != HOST:
                return ".to('cpu') copies a device value to the host and waits"
            if where == "device" and kind(recv) == HOST:
                return (f".{f.attr}() of a host tensor is a blocking "
                        f"host->device copy")
        if torch_fn and f.attr in ("tensor", "as_tensor"):
            dev = astutil.kwarg(c, "device")
            host_data = f.attr == "tensor" or (
                bool(c.args) and kind(c.args[0]) == HOST)
            if dev is not None and not _is_cpu(dev) and host_data:
                return (f"torch.{f.attr}(..., device=) of host data is a "
                        f"blocking host->device copy")
        if f.attr in DATA_SIZED or (f.attr == "where" and torch_fn
                                    and len(c.args) == 1):
            src = c.args[0] if torch_fn and c.args else recv
            if (torch_fn or recv is not None) and src is not None \
                    and kind(src) != HOST:
                return (f"{f.attr}() sizes its output by the data: the host "
                        f"waits for the count")
        if f.attr == "repeat_interleave" and (torch_fn or recv is not None) \
                and astutil.kwarg(c, "output_size") is None:
            reps = astutil.kwarg(c, "repeats")
            if reps is None and torch_fn and c.args:
                reps = c.args[1] if len(c.args) > 1 else c.args[0]
            elif reps is None:
                reps = c.args[0] if c.args else recv
            if reps is not None and kind(reps) == DEV:
                return ("repeat_interleave() with tensor repeats and no "
                        "output_size: the host waits for the total")
        return None


RULE = Rule()
