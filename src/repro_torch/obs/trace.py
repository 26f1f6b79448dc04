"""Deterministic structured tracing stamped in **simulated** time.

One recorder serves every subsystem: the discrete-event simulator stamps
events with ``EventQueue.now`` (ms), the serving engine with its per-pod
busy clocks and the router's tick clock, the planner with its epoch
boundaries, and the MoE layer with the recorder's last-set time (spans
there fire at jit-trace time — one per compiled (shape, path) cell, which
is exactly when the dispatch verdict is decided).  Because every timestamp
comes from deterministic simulation clocks, two seeded runs export
byte-identical traces (pinned in tests/test_obs.py) and a trace diff is a
meaningful regression signal, not noise.

Event kinds map 1:1 onto the Chrome/Perfetto ``trace_event`` format:

=============  ====  =======================================================
recorder call  ph    use
=============  ====  =======================================================
``span``       X     a closed duration on one track (pod step phases,
                     certifier batches, exec slots)
``instant``    i     a point event (forward, abort, lease free)
``abegin``     b     async span open — overlapping rounds on one track
``aend``       e     async span close (paired by track + id)
``counter``    C     a sampled scalar (queue depths, busy clocks)
=============  ====  =======================================================

Tracks are strings like ``"node0/lease"`` or ``"pod3"``; the component
before the first ``/`` becomes the Perfetto process row, the full string
the thread row.  Export with :meth:`TraceRecorder.export` and load the
JSON straight into https://ui.perfetto.dev (or ``chrome://tracing``).

**Zero-cost when disabled** is a hard contract: hot sites hold a reference
to either a recorder or ``None``/:data:`NULL` and guard with ONE branch —
``if tr is not None: tr.span("name", ...)`` — so the disabled path
allocates nothing (no f-strings, no payload dicts).  The
``event-trace-site`` lint rule (analysis/rules/trace_site.py) additionally
requires every site to pass a *static* event name, keeping the taken path
cheap and the trace vocabulary greppable.

The module-level :data:`TRACE` singleton exists for call sites with no
object to thread a recorder through (``models/moe.py``, the event queue's
replay capture).  ``install()``/``uninstall()`` swap it; everything else
threads explicit recorder instances.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

# internal event tuple layout: (ph, name, track, ts_ms, dur_ms, aid, payload)
_Event = Tuple[str, str, str, float, float, Any, Optional[Dict[str, Any]]]


class NullRecorder:
    """The disabled recorder: every method is a no-op, ``enabled`` False.

    Sites that cannot hold ``None`` (the module global) hold this instead;
    the one-branch contract is then ``if tr.enabled: ...``.
    """

    enabled = False
    time = 0.0

    def set_time(self, ts_ms: float) -> None:  # pragma: no cover - trivial
        pass

    def span(self, name, track, ts, dur, **payload) -> None:
        pass

    def instant(self, name, track, ts=None, **payload) -> None:
        pass

    def abegin(self, name, track, aid, ts=None, **payload) -> None:
        pass

    def aend(self, name, track, aid, ts=None, **payload) -> None:
        pass

    def counter(self, name, track, ts, value) -> None:
        pass


NULL = NullRecorder()

# module-level recorder for sites with nothing to thread through (moe,
# EventQueue replay capture).  Rebinding via install() is visible to every
# site because they read it through the module attribute.
TRACE = NULL


def install(recorder: "TraceRecorder") -> None:
    """Make ``recorder`` the module-level :data:`TRACE` singleton."""
    global TRACE
    TRACE = recorder


def uninstall() -> None:
    """Restore the no-op singleton."""
    global TRACE
    TRACE = NULL


class TraceRecorder:
    """Append-only span/instant recorder; export to Perfetto JSON.

    Timestamps are whatever simulated clock the caller passes (ms); pass
    ``ts=None`` to instants/async events to stamp the recorder's last
    ``set_time`` value (used by jit-trace-time sites that have no clock of
    their own).  Insertion order is preserved end to end, which together
    with sim-time stamps makes the export a pure function of the run.
    """

    enabled = True

    def __init__(self) -> None:
        self._events: List[_Event] = []
        self.time = 0.0       # last set_time() value, the ts=None fallback

    # -- recording -----------------------------------------------------------
    def set_time(self, ts_ms: float) -> None:
        self.time = ts_ms

    def span(self, name: str, track: str, ts: float, dur: float,
             **payload) -> None:
        """A closed [ts, ts+dur] slice on ``track`` (ms)."""
        self._events.append(
            ("X", name, track, ts, dur, None, payload or None))

    def instant(self, name: str, track: str, ts: Optional[float] = None,
                **payload) -> None:
        self._events.append(
            ("i", name, track, self.time if ts is None else ts, 0.0, None,
             payload or None))

    def abegin(self, name: str, track: str, aid,
               ts: Optional[float] = None, **payload) -> None:
        """Open an async span; overlapping spans coexist on one track."""
        self._events.append(
            ("b", name, track, self.time if ts is None else ts, 0.0, aid,
             payload or None))

    def aend(self, name: str, track: str, aid,
             ts: Optional[float] = None, **payload) -> None:
        self._events.append(
            ("e", name, track, self.time if ts is None else ts, 0.0, aid,
             payload or None))

    def counter(self, name: str, track: str, ts: float, value) -> None:
        self._events.append(
            ("C", name, track, ts, 0.0, None, {"value": value}))

    def __len__(self) -> int:
        return len(self._events)

    # -- export --------------------------------------------------------------
    def _track_ids(self) -> Dict[str, Tuple[int, int]]:
        """track -> (pid, tid), assigned in first-use order (deterministic)."""
        pids: Dict[str, int] = {}
        tids: Dict[str, Tuple[int, int]] = {}
        for (_ph, _name, track, _ts, _dur, _aid, _p) in self._events:
            if track in tids:
                continue
            proc = track.split("/", 1)[0]
            pid = pids.setdefault(proc, len(pids) + 1)
            tid = sum(1 for t in tids.values() if t[0] == pid) + 1
            tids[track] = (pid, tid)
        return tids

    def to_events(self) -> List[Dict[str, Any]]:
        """The Chrome ``trace_event`` dict list (ts/dur in microseconds)."""
        tids = self._track_ids()
        out: List[Dict[str, Any]] = []
        named_procs = set()
        for track, (pid, tid) in tids.items():
            proc = track.split("/", 1)[0]
            if proc not in named_procs:
                named_procs.add(proc)
                out.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": proc}})
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": track}})
        for (ph, name, track, ts, dur, aid, payload) in self._events:
            pid, tid = tids[track]
            ev: Dict[str, Any] = {"ph": ph, "name": name, "cat": "repro",
                                  "pid": pid, "tid": tid,
                                  "ts": round(ts * 1000.0, 3)}
            if ph == "X":
                ev["dur"] = round(dur * 1000.0, 3)
            elif ph == "i":
                ev["s"] = "t"
            elif ph in ("b", "e"):
                ev["id"] = str(aid)
            if payload:
                ev["args"] = payload
            out.append(ev)
        return out

    def export(self, path: str) -> None:
        """Write ``{"traceEvents": [...]}`` — Perfetto/Chrome loadable."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.to_events(),
                       "displayTimeUnit": "ms"}, f, separators=(",", ":"))


# --------------------------------------------------------------------------
# Offline helpers: load / summarize / diff exported traces
# --------------------------------------------------------------------------

def load(path: str) -> List[Dict[str, Any]]:
    """Load an exported trace; accepts the object or bare-list JSON forms."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a trace_event JSON")
    return events


def summarize(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-name aggregate rows: count, total/p50/p99 duration (us).

    Durations come from complete (``X``) events and from matched async
    ``b``/``e`` pairs; instants contribute counts only.
    """
    durs: Dict[str, List[float]] = {}
    counts: Dict[str, int] = {}
    open_async: Dict[Tuple[str, str], float] = {}
    for ev in events:
        ph = ev.get("ph")
        name = ev.get("name", "?")
        if ph == "X":
            counts[name] = counts.get(name, 0) + 1
            durs.setdefault(name, []).append(float(ev.get("dur", 0.0)))
        elif ph == "i":
            counts[name] = counts.get(name, 0) + 1
        elif ph == "b":
            counts[name] = counts.get(name, 0) + 1
            open_async[(name, str(ev.get("id")))] = float(ev["ts"])
        elif ph == "e":
            t0 = open_async.pop((name, str(ev.get("id"))), None)
            if t0 is not None:
                durs.setdefault(name, []).append(float(ev["ts"]) - t0)
    rows = []
    for name in sorted(counts):
        ds = sorted(durs.get(name, []))
        row = {"name": name, "count": counts[name],
               "total_us": sum(ds) if ds else 0.0}
        if ds:
            row["p50_us"] = _q(ds, 0.5)
            row["p99_us"] = _q(ds, 0.99)
        rows.append(row)
    return rows


def _q(sorted_vals: List[float], q: float) -> float:
    """Exact linear-interpolated quantile (numpy 'linear' semantics)."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def diff(a: List[Dict[str, Any]], b: List[Dict[str, Any]]
         ) -> List[Dict[str, Any]]:
    """Per-name deltas between two summarized traces (b minus a)."""
    sa = {r["name"]: r for r in summarize(a)}
    sb = {r["name"]: r for r in summarize(b)}
    rows = []
    for name in sorted(set(sa) | set(sb)):
        ra, rb = sa.get(name), sb.get(name)
        rows.append({
            "name": name,
            "count_a": ra["count"] if ra else 0,
            "count_b": rb["count"] if rb else 0,
            "d_count": (rb["count"] if rb else 0) - (ra["count"] if ra else 0),
            "d_total_us": (rb["total_us"] if rb else 0.0)
                          - (ra["total_us"] if ra else 0.0),
        })
    return rows
