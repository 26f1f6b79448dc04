"""event-trace-site: trace call sites must pass static event names.

The tracing contract (repro_torch.obs.trace) is zero-cost when disabled: one
branch per site, nothing evaluated on the untaken path.  An f-string (or
any computed expression) as the event *name* breaks that two ways — the
string is built before the call even when the recorder drops it, and the
trace vocabulary stops being greppable (``rg '"lease-round"'`` must find
every emitter).  Dynamic *track* strings and payload kwargs are fine:
they are only evaluated inside the enabled branch.

The rule fires on ``<recv>.span/instant/abegin/aend/counter(...)`` calls
whose receiver reads like a trace recorder (``tr``, anything containing
``trace``) and whose first positional argument is not a string literal.
It holds the profiler ranges of the model path
(:mod:`repro_torch.obs.regions`) to the same contract: ``region(name)``
(bare, or on a receiver that reads like the trace or regions module) with
a computed ``name`` is a violation too.
"""
from __future__ import annotations

import ast
from typing import List

from ..lint import FileCtx, Violation

RECORDER_METHODS = {"span", "instant", "abegin", "aend", "counter"}
REGION = "region"


def _recv_text(e: ast.expr) -> str:
    try:
        return ast.unparse(e).lower()
    except Exception:  # pragma: no cover - exotic receivers
        return ""


def _is_trace_receiver(e: ast.expr) -> bool:
    text = _recv_text(e)
    return text == "tr" or "trace" in text


def _event_name(node: ast.Call, method: str):
    """The call's event name: its first positional argument, or a
    region's ``name=``; None when it has neither."""
    if node.args:
        return node.args[0]
    for kw in node.keywords:
        if method == REGION and kw.arg == "name":
            return kw.value
    return None


def _site(node: ast.Call):
    """``(method, is a trace site)`` of a call: a recorder method on a
    trace receiver, or ``region`` bare or on a trace receiver."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id, f.id == REGION
    if not isinstance(f, ast.Attribute):
        return None, False
    if f.attr == REGION:
        return f.attr, _is_trace_receiver(f.value) or \
            "region" in _recv_text(f.value)
    return f.attr, f.attr in RECORDER_METHODS and \
        _is_trace_receiver(f.value)


class Rule:
    id = "event-trace-site"
    doc = ("trace recorder call sites must pass a static string event "
           "name — computed names allocate on the disabled path and break "
           "trace-vocabulary grepability")

    def check(self, ctx: FileCtx) -> List[Violation]:
        out: List[Violation] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            method, traced = _site(node)
            if not traced:
                continue
            first = _event_name(node, method)
            if first is None:
                continue
            if isinstance(first, ast.Constant) \
                    and isinstance(first.value, str):
                continue
            kind = ("f-string" if isinstance(first, ast.JoinedStr)
                    else type(first).__name__)
            out.append(ctx.violation(
                node, self.id,
                f"trace .{method}() called with a computed event name "
                f"({kind}) — pass a string literal; put variability in "
                f"the track or payload"))
        return out


RULE = Rule()
