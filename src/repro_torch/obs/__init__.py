"""repro_torch.obs — deterministic sim-time tracing and quantile metrics.

Copies of the reference modules:

- :mod:`repro_torch.obs.trace`: span/instant recorder stamped in sim
  time, Perfetto ``trace_event`` JSON export, module-level ``TRACE``
  no-op singleton for siteless call points.
- :mod:`repro_torch.obs.metrics`: counters / gauges / exact-quantile
  histograms behind a registry, the ``MetricSet`` attribute facade, and
  the ``MonotonicSampler`` wall-clock seam.

The port's own, on the device trace's clock:

- :mod:`repro_torch.obs.regions`: the model path's ``repro.*`` profiler
  ranges, open only while a torch profiler records, and the counters kept
  meanwhile (GC pauses, the allocator's calls over a step or a prefill).
"""
from .trace import (  # noqa: F401
    NULL,
    NullRecorder,
    TraceRecorder,
    install,
    uninstall,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricSet,
    MonotonicSampler,
    Registry,
)
