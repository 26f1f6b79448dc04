"""repro_torch.obs.metrics: a pinned copy of repro.obs.metrics.

The copy equals the reference module byte for byte, the port's package
exports the same metric names, and the reference's metrics tests
(``tests/test_obs.py``) run here against the port.
"""
import math
from pathlib import Path

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricSet,
                                     MonotonicSampler, Registry)

REPO = Path(__file__).resolve().parents[1]


def test_metrics_is_a_pinned_copy():
    assert (REPO / "src/repro_torch/obs/metrics.py").read_text() == \
        (REPO / "src/repro/obs/metrics.py").read_text()


@pytest.mark.parametrize("name", ["Counter", "Gauge", "Histogram",
                                  "MetricSet", "MonotonicSampler",
                                  "Registry", "TraceRecorder", "NULL"])
def test_obs_exports_match_reference(name):
    assert hasattr(jobs, name) and hasattr(tobs, name)
    assert type(getattr(tobs, name)).__name__ == \
        type(getattr(jobs, name)).__name__


def test_histogram_summaries_equal_reference():
    rng = np.random.default_rng(3)
    samples = np.concatenate([rng.exponential(2e-4, 300), [0.0, -1.0]])
    hists = []
    for mod in (jobs, tobs):
        reg = mod.Registry()
        h = reg.histogram("lat")
        for v in samples:
            h.observe(float(v))
        reg.counter("n").inc(3)
        reg.gauge("g").set(0.5)
        hists.append((reg.as_dict(), dict(h.buckets),
                      h.slo_attainment(1e-4)))
    assert hists[0] == hists[1]


# -- the reference's metrics tests (tests/test_obs.py), on the port --------

def test_histogram_quantiles_match_numpy():
    rng = np.random.default_rng(0)
    for samples in (rng.exponential(3.0, 257), rng.normal(10.0, 2.0, 64),
                    np.array([4.2]), np.arange(100.0)):
        h = Histogram("lat")
        for v in samples:
            h.observe(float(v))
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            want = float(np.percentile(samples, 100.0 * q))
            assert h.quantile(q) == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_histogram_pow2_bucket_edges():
    h = Histogram("b")
    # exact powers of two land in their own bucket [2^k, 2^(k+1)),
    # just-below values in the one underneath
    for v in (1.0, 2.0, 4.0, 8.0):
        h.observe(v)
    h.observe(3.999999)
    h.observe(0.0)
    h.observe(-1.5)
    assert h.buckets[0] == 1          # [1, 2)
    assert h.buckets[1] == 2          # [2, 4): 2.0 and 3.999999
    assert h.buckets[2] == 1          # [4, 8)
    assert h.buckets[3] == 1          # [8, 16)
    assert h.buckets["le_zero"] == 2  # 0.0 and -1.5
    assert h.count == 7
    # fractional values bucket by floor(log2): 0.3 -> k=-2
    h.observe(0.3)
    assert h.buckets[math.floor(math.log2(0.3))] == 1


def test_histogram_slo_attainment_and_summary():
    h = Histogram("lat")
    assert h.quantile(0.5) is None
    assert h.slo_attainment(1.0) is None
    for v in range(1, 11):
        h.observe(float(v))
    assert h.slo_attainment(5.0) == 0.5
    assert h.slo_attainment(10.0) == 1.0
    assert h.slo_attainment(0.5) == 0.0
    s = h.summary()
    assert s["count"] == 10
    assert s["p50"] == pytest.approx(np.percentile(range(1, 11), 50))
    assert set(s) == {"count", "p50", "p90", "p99"}


def test_registry_and_scalar_metrics():
    r = Registry()
    c = r.counter("steps")
    c.inc()
    c.inc(4)
    assert r.counter("steps").value == 5       # same object on re-access
    g = r.gauge("depth")
    g.set(3.5)
    r.histogram("lat").observe(2.0)
    d = r.as_dict()
    assert d["steps"] == 5 and d["depth"] == 3.5
    assert d["lat"]["count"] == 1
    assert "steps" in r and "missing" not in r
    assert isinstance(r.counter("steps"), Counter)
    assert isinstance(r.gauge("depth"), Gauge)


def test_metricset_facade_routes_to_registry():
    class M(MetricSet):
        FIELDS = {"forwards": 0, "wire_s": 0.0}

    m = M()
    m.forwards += 1
    m.forwards += 2
    m.wire_s += 0.25
    assert m.forwards == 3
    assert m.registry.counter("forwards").value == 3
    assert m.as_dict() == {"forwards": 3, "wire_s": 0.25}
    # non-FIELDS attributes behave like normal instance attributes
    m.note = "x"
    assert m.note == "x" and "note" not in m.registry
    with pytest.raises(AttributeError):
        _ = m.nonexistent


def test_monotonic_sampler_with_fake_clock():
    ticks = iter([10.0, 10.5, 11.0, 13.25])
    s = MonotonicSampler(clock=lambda: next(ticks))
    assert s.lap() == 0.0            # lap before mark is a no-op
    s.mark()
    assert s.lap() == pytest.approx(0.5)
    assert s.lap() == 0.0            # interval consumed
    s.mark()
    assert s.lap() == pytest.approx(2.25)
