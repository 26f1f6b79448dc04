"""The program's own spans in a traced run: the ``repro.*`` ranges the port
opens while a profiler records (``repro_torch.obs.regions.region``), read
from the same kineto events as :func:`tracing.read`, and the program's
counters (``repro_torch.obs.regions.COUNTERS``).

Attribution.  A device activity is put on the host thread and time of its
launch, as :func:`tracing.read` puts it, and carries every ``repro.*``
range open there on that thread.  Where it was launched inside an
autograd node (``autograd::engine::evaluate_function: ...`` on the
backward's thread), it also carries the ranges that were open around the
node's forward op: the op kineto recorded with the node's
``sequence_nr`` on the forward's thread (the node's ``fwd_thread_id``),
the last one that started (an op that made no node took the same number
before it).  So a mixer's backward kernels count toward the mixer, and
the program adds no autograd node for it.  The train step's and the
prefill's phases (``repro.step``, ``repro.prefill`` and the ranges under
those names) are spans of time instead: an activity carries the phases
open at its launch on any thread, so the backward's kernels count toward
``repro.step.backward``, not toward the forward phase of their ops.

Readings of :func:`read`:

- ``span_device_s``: each range name's device time (an activity counts
  toward every range it carries);
- ``mamba_glue_share``: the device time inside ``repro.mixer.mamba``,
  forward and backward, outside its two GEMMs (``repro.mamba.in_proj``,
  ``repro.mamba.out_proj``) and the SSD (``repro.ssd``), over the
  window's device time: the conv, SiLU, softplus, gating, the gated norm,
  the D skip, casts, pads and copies;
- ``program_idle_share``: the share of the window in which the device is
  idle while some ``repro.*`` range is open on any host thread (the rest
  of ``device_idle_share`` is the harness's);
- ``idle_by_span``: the window's device-idle seconds by the innermost
  program or harness range (``repro.*``, ``bench.*``) open on any thread
  (the one that started last), ``bench.window`` where none is.

    python3 bench/program_spans.py --workload <cell> --seed <n> \\
        --seconds <s>

sets the cell up as ``run.py`` does and traces a window under the
profiler with the benchmark's wrappers installed, as ``--trace 1`` does.
One JSON line: the traced window's ``tokens_per_s``, the counters'
deltas, :func:`read`'s and :func:`tracing.read`'s readings, and the kernel
libraries this process loaded, with their ``nvcc`` seconds where it built
them.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import heapq
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

import tracing

PROGRAM = "repro."
HARNESS = "bench."
WINDOW = "bench.window"
# the benchmark's own zero-work marks of an op's backward (tracing._Mark)
MARKS = (".bwd_start", ".bwd_end")
EVALUATE = "autograd::engine::evaluate_function: "
MAMBA = "repro.mixer.mamba"
# inside the Mamba mixer, what is not its glue: the two GEMMs and the SSD
# (its backward ranges run inside the SSD's own node)
NOT_GLUE = frozenset({"repro.mamba.in_proj", "repro.mamba.out_proj",
                      "repro.ssd", "repro.ssd.bwd"})
PHASES = ("repro.step", "repro.prefill")


def _phase(name: str) -> bool:
    return name in PHASES or name.startswith(("repro.step.",
                                              "repro.prefill."))


class _Stacks:
    """The ranges open on one thread, looked up by a time: each segment
    between two boundaries holds the ``repro.*`` names open over it
    (outermost first) and the innermost autograd node's ``(forward thread,
    sequence_nr)``, or None outside any node."""

    def __init__(self, items: List[Tuple[int, int, str, object]]):
        bounds = []
        for i, (t0, t1, _, _) in enumerate(items):
            bounds.append((t0, 1, i))
            bounds.append((t1, 0, i))      # ends first at a shared time
        bounds.sort()
        self.starts: List[int] = []
        self.states: List[Tuple[Tuple[str, ...], object]] = []
        open_: List[int] = []
        interned: Dict[Tuple, Tuple] = {}
        for k, (t, is_start, i) in enumerate(bounds):
            if is_start:
                open_.append(i)
            else:
                open_.remove(i)
            if k + 1 < len(bounds) and bounds[k + 1][0] == t:
                continue
            names = tuple(items[j][2] for j in open_ if items[j][3] is None)
            node = next((items[j][3] for j in reversed(open_)
                         if items[j][3] is not None), None)
            state = interned.setdefault((names, node), (names, node))
            self.starts.append(t)
            self.states.append(state)

    def at(self, t: int) -> Tuple[Tuple[str, ...], object]:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.states[i] if i >= 0 else ((), None)


def _idle(busy: List[Tuple[int, int]], w0: int, w1: int
          ) -> List[Tuple[int, int]]:
    """The window's intervals with no device activity."""
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < w1:
        out.append((t, w1))
    return out


def _sweep(ranges: List[Tuple[int, int, str]],
           idle: List[Tuple[int, int]]) -> Tuple[Dict[str, float], float]:
    """Idle seconds by the innermost range open on any thread (the one
    that started last), and the idle seconds with a ``repro.*`` range
    open."""
    bounds = sorted([(t0, 1, i) for i, (t0, _, _) in enumerate(ranges)] +
                    [(t1, 0, i) for i, (_, t1, _) in enumerate(ranges)])
    by_span: Dict[str, int] = defaultdict(int)
    program = 0
    heap: List[Tuple[int, int]] = []
    closed = set()
    n_program = 0
    j = 0
    prev = idle[0][0] if idle else 0
    for t, is_start, i in bounds + [(idle[-1][1] if idle else 0, 2, -1)]:
        # the segment [prev, t) under the ranges open now
        if t > prev:
            while heap and heap[0][1] in closed:
                heapq.heappop(heap)
            name = ranges[heap[0][1]][2] if heap else WINDOW
            while j < len(idle) and idle[j][1] <= prev:
                j += 1
            k = j
            while k < len(idle) and idle[k][0] < t:
                part = min(idle[k][1], t) - max(idle[k][0], prev)
                if part > 0:
                    by_span[name] += part
                    if n_program:
                        program += part
                k += 1
            prev = t
        if is_start == 1:
            heapq.heappush(heap, (-ranges[i][0], i))
            n_program += ranges[i][2].startswith(PROGRAM)
        elif is_start == 0:
            closed.add(i)
            n_program -= ranges[i][2].startswith(PROGRAM)
    return ({k: v / 1e9 for k, v in sorted(by_span.items(),
                                           key=lambda kv: -kv[1])},
            program / 1e9)


def read(events: Iterable) -> Dict:
    """The program's spans in the kineto events of a run whose window is
    the ``bench.window`` range (:mod:`tracing`'s profiler)."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    host, device = [], []
    for e in events:
        if e.device_type() == cuda:
            if tracing._activity(e):
                device.append(e)
            continue
        host.append(e)
        if e.name() == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = window

    launches: Dict[int, Tuple[int, int]] = {}
    ops: Dict[int, Tuple[int, int]] = {}
    per_thread: Dict[int, List] = defaultdict(list)
    phases: List = []
    forward_at: Dict[Tuple[int, int], int] = {}
    spans: List[Tuple[int, int, str]] = []
    counts: Dict[str, int] = defaultdict(int)
    for e in sorted(host, key=lambda e: e.start_ns()):
        name, t0, tid = e.name(), e.start_ns(), e.start_thread_id()
        t1 = t0 + e.duration_ns()
        if "Launch" in name or name.startswith(("cudaMemcpy", "cudaMemset")):
            launches[e.correlation_id()] = (tid, t0)
            continue
        ops.setdefault(e.correlation_id(), (tid, t0))
        if name.startswith(PROGRAM):
            (phases if _phase(name) else per_thread[tid]).append(
                (t0, t1, name, None))
            if w0 <= t0 <= w1:
                counts[name] += 1
        elif name.startswith(EVALUATE):
            if e.sequence_nr() >= 0:
                per_thread[tid].append(
                    (t0, t1, name, (e.fwd_thread_id(), e.sequence_nr())))
        elif e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:
            forward_at[(tid, e.sequence_nr())] = t0     # the last one wins
        if name.startswith((PROGRAM, HARNESS)) and name != WINDOW and \
                not name.endswith(MARKS) and t1 > w0 and t0 < w1:
            spans.append((t0, t1, name))
    stacks = {tid: _Stacks(items) for tid, items in per_thread.items()}
    empty = _Stacks([])
    phase = _Stacks(phases)

    def names_at(tid: int, t: int) -> Tuple[str, ...]:
        own, node = stacks.get(tid, empty).at(t)
        own += phase.at(t)[0]
        if node is None:
            return own
        fwd_tid, seq = node
        t_fwd = forward_at.get((fwd_tid, seq))
        if t_fwd is None:
            return own
        return own + stacks.get(fwd_tid, empty).at(t_fwd)[0]

    span_ns: Dict[str, int] = defaultdict(int)
    intervals, total, glue, unplaced = [], 0, 0, 0
    for e in device:
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if t1 <= w0 or t0 >= w1 or e.duration_ns() <= 0:
            continue
        t0, t1 = max(t0, w0), min(t1, w1)
        intervals.append((t0, t1))
        total += t1 - t0
        at = launches.get(e.correlation_id()) or \
            ops.get(e.linked_correlation_id())
        if at is None:
            unplaced += 1
            continue
        names = set(names_at(*at))
        for n in names:
            span_ns[n] += t1 - t0
        if MAMBA in names and not names & NOT_GLUE:
            glue += t1 - t0
    busy = tracing._union(intervals)
    idle = _idle(busy, w0, w1)
    by_span, program_idle = _sweep(spans, idle)
    window_s = (w1 - w0) / 1e9
    return {
        "window_s": window_s,
        "device_s": total / 1e9,
        "idle_s": sum(b - a for a, b in idle) / 1e9,
        "span_device_s": {k: v / 1e9 for k, v in sorted(span_ns.items())},
        "ranges": dict(sorted(counts.items())),
        "mamba_glue_s": glue / 1e9,
        "mamba_glue_share": 100.0 * glue / total
        if total > 0 and span_ns.get(MAMBA) else None,
        "program_idle_s": program_idle,
        "program_idle_share": 100.0 * program_idle / window_s
        if window_s > 0 and counts else None,
        "idle_by_span": by_span,
        "unplaced": unplaced,
    }


def _libraries() -> Dict[str, Dict]:
    """``CudaLibrary.info``'s build record of each kernel library."""
    from repro_torch.kernels import flash_attention, lease_validate, ssd_scan

    return {lib.name: {k: lib.info[k] for k in ("cached", "nvcc_s")
                       if k in lib.info}
            for lib in (flash_attention.LIB, ssd_scan.LIB, lease_validate.LIB)
            if lib.info}


def _delta(after: Dict, before: Dict) -> Dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


# ---------------------------------------------------------------------------
# A cell's traced windows
# ---------------------------------------------------------------------------

def traced_window(workload: str, seed: int, seconds: float, device, *,
                  model: Optional[Dict] = None,
                  mix: Optional[Dict] = None) -> Dict:
    """The cell set up as ``run.run`` sets it up, then one traced window
    (after a full collection) read by :func:`tracing.read` and
    :func:`read`."""
    import importlib

    import run
    from repro_torch.obs import regions

    env = run.environment(workload, seed, device, model=model, mix=mix)
    runner = importlib.import_module(f"kinds.{env.mix['kind']}").Run(env)
    runner.setup()
    run._sync(device)
    gc.collect()
    spans = tracing.Spans()
    spans.install()
    before = regions.COUNTERS.as_dict()
    try:
        with tracing.profiler() as prof:
            units, wall = run._window(runner, seconds)
    finally:
        spans.remove()
    line = {"tokens_per_s": sum(u["tokens"] for u in units) / wall,
            "units": len(units),
            "counters": _delta(regions.COUNTERS.as_dict(), before)}
    t0 = time.perf_counter()
    events = tracing.events(prof)
    summary = tracing.read(events, spans)
    line.update(
        program=read(events), read_s=time.perf_counter() - t0,
        trace={k: summary[k] for k in (
            "window_s", "busy_s", "device_s", "op_device_s",
            "activities", "unplaced")},
        idle_gaps=summary["breakdown"]["idle_gaps"],
        libraries=_libraries())
    del events, prof
    runner.release()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    print(json.dumps(traced_window(args.workload, args.seed, args.seconds,
                                   torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
