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
"""
from __future__ import annotations

import ast
from typing import List

from ..lint import FileCtx, Violation

RECORDER_METHODS = {"span", "instant", "abegin", "aend", "counter"}


def _recv_text(e: ast.expr) -> str:
    try:
        return ast.unparse(e).lower()
    except Exception:  # pragma: no cover - exotic receivers
        return ""


def _is_trace_receiver(e: ast.expr) -> bool:
    text = _recv_text(e)
    return text == "tr" or "trace" in text


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
            f = node.func
            if not isinstance(f, ast.Attribute) \
                    or f.attr not in RECORDER_METHODS:
                continue
            if not _is_trace_receiver(f.value):
                continue
            if not node.args:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) \
                    and isinstance(first.value, str):
                continue
            kind = ("f-string" if isinstance(first, ast.JoinedStr)
                    else type(first).__name__)
            out.append(ctx.violation(
                node, self.id,
                f"trace .{f.attr}() called with a computed event name "
                f"({kind}) — pass a string literal; put variability in "
                f"the track or payload"))
        return out


RULE = Rule()
