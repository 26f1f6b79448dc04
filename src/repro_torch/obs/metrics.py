"""Counters, gauges, and quantile histograms behind one registry.

The serving stack previously tracked everything as loose dataclass
fields (``EngineMetrics``, ``CertifierMetrics``) which made per-pod
breakdowns and latency distributions bolt-ons.  This module is the
single source of truth those migrate onto:

- :class:`Counter` / :class:`Gauge` — plain scalars with a name.
- :class:`Histogram` — keeps **raw samples** (exact quantiles, numpy
  'linear' interpolation semantics) plus pow2 log-bucket counts
  ``[2^k, 2^(k+1))`` for cheap shape summaries, and an SLO-attainment
  helper (fraction of samples ≤ limit).
- :class:`Registry` — name → metric, with ``as_dict()``.
- :class:`MetricSet` — an attribute facade over a registry so existing
  call sites (``m.forwards += 1``) and tests keep working unchanged
  while the values live in the registry.
- :class:`MonotonicSampler` — the one sanctioned wall-clock seam.  Sim
  metrics are deterministic by construction; anything that *must* read
  host time (planner scoring runs on the host CPU, so its wall block
  time is real) goes through a sampler instance, which tests can swap
  for a fake.  This keeps the ``event-determinism`` lint honest: no
  bare ``time.*`` reads in step loops.

Everything here is stdlib-only; numpy is used nowhere so the registry
can be imported from lint/CI contexts without heavyweight deps.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional


class Counter:
    """A monotonically-meant (but not enforced) named scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0):
        self.name = name
        self.value = value

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """A named last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0.0):
        self.name = name
        self.value = value

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Exact-quantile histogram with pow2 log-bucket counts.

    ``observe(v)`` appends the raw sample (quantiles stay exact — the
    sample counts here are tool-scale, not telemetry-scale) and bumps
    the log bucket ``k = floor(log2(v))``, i.e. bucket ``k`` covers
    ``[2^k, 2^(k+1))``.  Non-positive samples land in the reserved
    ``"le_zero"`` bucket.
    """

    __slots__ = ("name", "samples", "buckets")

    def __init__(self, name: str):
        self.name = name
        self.samples: List[float] = []
        self.buckets: Dict[Any, int] = {}

    def observe(self, v: float, n: int = 1) -> None:
        for _ in range(n):
            self.samples.append(v)
        if v > 0.0:
            k = math.floor(math.log2(v))
        else:
            k = "le_zero"
        self.buckets[k] = self.buckets.get(k, 0) + n

    @property
    def count(self) -> int:
        return len(self.samples)

    def quantile(self, q: float) -> Optional[float]:
        """Exact quantile, numpy ``method='linear'`` semantics."""
        if not self.samples:
            return None
        s = sorted(self.samples)
        n = len(s)
        if n == 1:
            return s[0]
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def slo_attainment(self, limit: float) -> Optional[float]:
        """Fraction of samples ``<= limit`` (the SLO-met rate)."""
        if not self.samples:
            return None
        return sum(1 for v in self.samples if v <= limit) / len(self.samples)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": self.count}
        for label, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
            v = self.quantile(q)
            if v is not None:
                out[label] = v
        return out


class Registry:
    """Flat name → metric map with factory accessors."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def counter(self, name: str, value=0) -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name, value)
        return m

    def gauge(self, name: str, value=0.0) -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Gauge(name, value)
        return m

    def histogram(self, name: str) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name)
        return m

    def get(self, name: str):
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return list(self._metrics)

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out


class MetricSet:
    """Attribute facade over a :class:`Registry`.

    Subclasses declare ``FIELDS = {"forwards": 0, ...}``; reads and
    writes of those attribute names route to registry counters/gauges,
    so pre-existing idioms like ``metrics.forwards += 1`` keep working
    while the registry is the single source of truth.  Attributes not
    in ``FIELDS`` behave normally (stored on the instance).
    """

    FIELDS: Dict[str, Any] = {}

    def __init__(self, registry: Optional[Registry] = None,
                 prefix: str = "") -> None:
        # bypass our own __setattr__ while bootstrapping
        object.__setattr__(self, "registry", registry or Registry())
        object.__setattr__(self, "_prefix", prefix)
        for name, default in type(self).FIELDS.items():
            self.registry.counter(prefix + name, default)

    def _key(self, name: str) -> str:
        return self._prefix + name

    def __getattr__(self, name: str):
        # only called when normal lookup fails — i.e. FIELDS entries
        fields = type(self).FIELDS
        if name in fields:
            return self.registry.counter(self._prefix + name).value
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name in type(self).FIELDS:
            self.registry.counter(self._prefix + name).value = value
        else:
            object.__setattr__(self, name, value)

    def as_dict(self) -> Dict[str, Any]:
        return {name: self.registry.counter(self._prefix + name).value
                for name in type(self).FIELDS}


class MonotonicSampler:
    """The sanctioned host-clock read: ``elapsed = s.lap()`` pairs.

    ``clock`` is injectable (tests pass a fake) and defaults to
    ``time.perf_counter``.  Call :meth:`mark` to open an interval and
    :meth:`lap` to close it and get the elapsed seconds.
    """

    __slots__ = ("_clock", "_t0")

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0: Optional[float] = None

    def mark(self) -> None:
        self._t0 = self._clock()

    def lap(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = self._clock() - self._t0
        self._t0 = None
        return dt
