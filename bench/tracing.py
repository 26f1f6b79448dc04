"""The traced run: spans around the calls into each layer, recorded from
the benchmark's side, and the device trace read against them.

Spans.  :class:`Spans` wraps ``ops.attention``, ``ops.ssd`` and
``optimizer.update`` (the module attributes the program calls through)
in ``record_function`` ranges named ``bench.<op>``, and adds up the work
each call needs (:mod:`arith`).  Where a gradient will flow it marks the
op's backward by the autograd work of the call itself: an identity
Function on the output whose backward records ``bench.<op>.bwd_start``,
and one on the inputs whose backward records ``bench.<op>.bwd_end``; the
engine runs the op's backward between the two, on one thread.  Nothing is
attributed by kernel name, so a kernel that replaces another is counted
the same.

Trace.  The profiler (CPU and CUDA activity, nothing else recorded) runs
over the measured window, itself a ``bench.window`` range.  Each device
activity is put on the host thread and time of its launch (the runtime
call with its correlation id, else the op it is linked to), and belongs
to a span when its launch lies inside it on that thread.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

import arith

OPS = ("attention", "ssd", "optimizer")


class _Mark(torch.autograd.Function):
    """Identity whose backward records a zero-length range ``label``."""

    @staticmethod
    def forward(ctx, label, *xs):
        ctx.label = label
        out = tuple(x.view_as(x) for x in xs)
        return out if len(out) > 1 else out[0]

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function(ctx.label):
            pass
        return (None, *grads)


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


class Spans:
    """The wrappers of one traced run, and the work they counted."""

    def __init__(self):
        self.bound_s: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._undo: List[Tuple[object, str, object]] = []

    def reset(self) -> None:
        self.bound_s.clear()
        self.calls.clear()

    def _count(self, op: str, work: Tuple[float, float]) -> None:
        self.bound_s[op] += arith.bound_s(*work)
        self.calls[op] += 1

    def install(self) -> None:
        from repro_torch.kernels import ops
        from repro_torch.train import optimizer

        attention, ssd, update = ops.attention, ops.ssd, optimizer.update

        def attention_span(q, k, v, **kw):
            grad = _wants_grad(q, k, v)
            b, sq, hq, dk = q.shape
            skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
            shape = (b, sq, skv, hq, hkv, dk, dv, q.element_size())
            causal = kw.get("causal", True)
            self._count("attention", arith.attention_work(
                *shape, causal=causal, lse=grad))
            if grad:
                self._count("attention", arith.attention_work(
                    *shape, causal=causal, backward=True))
                q, k, v = _Mark.apply("bench.attention.bwd_end", q, k, v)
            with torch.profiler.record_function("bench.attention"):
                out = attention(q, k, v, **kw)
            if grad:
                out = _Mark.apply("bench.attention.bwd_start", out)
            return out

        def ssd_span(x, dt, a, b_mat, c_mat, **kw):
            grad = _wants_grad(x, dt, a, b_mat, c_mat)
            b, s, h, p = x.shape
            shape = (b, s, h, p, b_mat.shape[-1], kw.get("chunk", 256),
                     x.element_size())
            h0 = kw.get("h0") is not None
            self._count("ssd", arith.ssd_work(*shape, h0=h0))
            if grad:
                self._count("ssd", arith.ssd_work(*shape, backward=True,
                                                  h0=h0))
                x, dt, a, b_mat, c_mat = _Mark.apply(
                    "bench.ssd.bwd_end", x, dt, a, b_mat, c_mat)
            with torch.profiler.record_function("bench.ssd"):
                y, final = ssd(x, dt, a, b_mat, c_mat, **kw)
            if grad:
                y = _Mark.apply("bench.ssd.bwd_start", y)
            return y, final

        def update_span(*args, **kw):
            with torch.profiler.record_function("bench.optimizer"):
                self.calls["optimizer"] += 1
                return update(*args, **kw)

        for mod, name, fn in ((ops, "attention", attention_span),
                              (ops, "ssd", ssd_span),
                              (optimizer, "update", update_span)):
            self._undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

    def remove(self) -> None:
        while self._undo:
            mod, name, fn = self._undo.pop()
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# The profiler, and what its events say
# ---------------------------------------------------------------------------

def profiler():
    """CPU and CUDA activity, nothing else recorded; its events are read
    as kineto gives them (:func:`events`), without the Python event
    tree."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def events(prof) -> list:
    """The kineto events of a stopped :func:`profiler`."""
    return prof.profiler.kineto_results.events()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


class _Ranges:
    """Closed intervals on one thread, looked up by a time."""

    def __init__(self, spans: List[Tuple[int, int]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]


def _activity(e) -> bool:
    """A device activity (kernel, copy, set), not the device-side shadow
    the profiler draws of a host range (``gpu_user_annotation``)."""
    if e.is_user_annotation() or e.name().startswith("bench."):
        return False
    kind = getattr(e, "activity_type", None)
    return kind is None or "annotation" not in str(kind()).lower()


def read(events, spans: Optional[Spans] = None) -> Dict:
    """The window's device time, busy union, idle gaps and the device time
    inside each op's spans, from the kineto events of a run whose window
    is the ``bench.window`` range."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    host, device = [], []
    for e in events:
        if e.device_type() == cuda:
            if _activity(e):
                device.append(e)
            continue
        host.append(e)
        if e.name() == "bench.window":
            window = (e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.start_thread_id())
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1, _ = window

    launches: Dict[int, Tuple[int, int]] = {}
    ops: Dict[int, Tuple[int, int]] = {}
    ranges: Dict[str, Dict[int, List[Tuple[int, int]]]] = {
        op: defaultdict(list) for op in OPS}
    open_bwd: Dict[Tuple[str, int], List[int]] = defaultdict(list)
    spans_host: List[Tuple[int, int, str]] = []
    for e in sorted(host, key=lambda e: e.start_ns()):
        name, t0, tid = e.name(), e.start_ns(), e.start_thread_id()
        t1 = t0 + e.duration_ns()
        if "Launch" in name or name.startswith(("cudaMemcpy", "cudaMemset")):
            launches[e.correlation_id()] = (tid, t0)
        else:
            ops.setdefault(e.correlation_id(), (tid, t0))
        if name.startswith("bench."):
            parts = name.split(".")
            if len(parts) == 2 and parts[1] in OPS:
                ranges[parts[1]][tid].append((t0, t1))
            elif len(parts) == 3 and parts[2] == "bwd_start":
                open_bwd[(parts[1], tid)].append(t0)
            elif len(parts) == 3 and parts[2] == "bwd_end" and \
                    open_bwd[(parts[1], tid)]:
                ranges[parts[1]][tid].append(
                    (open_bwd[(parts[1], tid)].pop(0), t1))
        if w0 <= t0 <= w1 and name != "bench.window":
            spans_host.append((t0, t1, name))
    lookup = {op: {tid: _Ranges(sp) for tid, sp in by_tid.items()}
              for op, by_tid in ranges.items()}

    by_name: Dict[str, int] = defaultdict(int)
    in_op: Dict[str, int] = defaultdict(int)
    in_op_count: Dict[str, int] = defaultdict(int)
    intervals, total, unplaced = [], 0, defaultdict(int)
    for e in device:
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if t1 <= w0 or t0 >= w1 or e.duration_ns() <= 0:
            continue
        t0, t1 = max(t0, w0), min(t1, w1)
        intervals.append((t0, t1))
        total += t1 - t0
        by_name[e.name()] += t1 - t0
        at = launches.get(e.correlation_id()) or \
            ops.get(e.linked_correlation_id())
        if at is None:
            unplaced[e.name()[:80]] += 1
            continue
        tid, tl = at
        for op in OPS:
            look = lookup[op].get(tid)
            if look is not None and look.holds(tl):
                in_op[op] += t1 - t0
                in_op_count[op] += 1
                break
    busy = _union(intervals)
    gaps = [(busy[i][0] - busy[i - 1][1], busy[i - 1][1], busy[i][0])
            for i in range(1, len(busy))]
    if busy:
        gaps += [(busy[0][0] - w0, w0, busy[0][0]),
                 (w1 - busy[-1][1], busy[-1][1], w1)]
    gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:10]
    starts = [t0 for t0, _, _ in spans_host]
    idle = [[_host_at(spans_host, starts, (a + b) // 2), g / 1e9]
            for g, a, b in gaps]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_s": total / 1e9,
        "op_device_s": {op: in_op[op] / 1e9 for op in OPS},
        "op_activities": dict(in_op_count),
        "unplaced": sum(unplaced.values()),
        "unplaced_names": sorted(unplaced.items(), key=lambda kv: -kv[1])[:5],
        "activities": len(intervals),
        "breakdown": {"device_ops": [[n[:160], t / 1e9] for n, t in top],
                      "idle_gaps": idle},
        "bound_s": dict(spans.bound_s) if spans is not None else {},
        "calls": dict(spans.calls) if spans is not None else {},
    }


def _host_at(host: List[Tuple[int, int, str]], starts: List[int],
             t: int) -> str:
    """The innermost host range open at ``t`` on any thread (the one that
    started last), or the window itself."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if host[i][1] >= t:
            return host[i][2]
        i -= 1
    return "bench.window"
