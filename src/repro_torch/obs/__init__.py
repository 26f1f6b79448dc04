"""repro_torch.obs — deterministic sim-time tracing (copy of repro.obs.trace).

:mod:`repro_torch.obs.trace` is a verbatim copy of the reference module;
the metrics half of :mod:`repro.obs` belongs to the serving slice.
"""
from .trace import (  # noqa: F401
    NULL,
    NullRecorder,
    TraceRecorder,
    install,
    uninstall,
)
