"""Profiler ranges of the model path, on the device trace's clock.

:mod:`repro_torch.obs.trace` stamps its events in simulated time (the
cluster simulator, the serving engine, the planner), so they cannot be laid
against a device trace; it is also a verbatim copy of the reference's
module.  This is its other half.  The model path (the train step, AdamW,
prefill, the mixers, the kernel calls and their ctypes launches) marks
itself with :func:`region`: a ``torch.profiler.record_function`` range,
opened only while a torch profiler records (``torch.autograd.
_profiler_enabled()``), else a shared no-op context that allocates nothing.
There is no switch: any ``torch.profiler.profile`` over the program records
the ``repro.*`` ranges on the clock of the CUDA activity it traces
(kineto), and under ``torch.autograd.profiler.emit_nvtx`` they are NVTX
ranges.  The recorder's one-branch contract holds (a site costs one
``_profiler_enabled()`` call when no profiler runs), and the
``event-trace-site`` lint rule holds ``region`` names to string literals.

While a profiler records, :data:`COUNTERS` (a :class:`~repro_torch.obs.
metrics.Registry`) also counts the Python GC's pauses (each one a
``repro.gc`` range, from a ``gc.callbacks`` entry) and the caching
allocator's ``cudaMalloc`` / ``cudaFree`` calls and retries over the
regions given a ``device`` (``COUNTERS.as_dict()`` before and after a
window gives its deltas).  Nothing here imports torch until the first
:func:`region` call, so the lint and the CLI import :mod:`repro_torch.obs`
without it.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Dict, List

from .metrics import MonotonicSampler, Registry


# counted while a profiler records: GC pauses, the allocator over a region
# given a device
COUNTERS = Registry()

_OFF = contextlib.nullcontext()
# torch.autograd._profiler_enabled and torch.profiler.record_function,
# bound at the first region() call
_profiling = None
_record = None
_gc_open = None            # the record_function of the collection running
_gc_clock = MonotonicSampler()

# torch.cuda.memory_stats() keys counted over a region given a device:
# the caching allocator's cudaMalloc and cudaFree calls, and its
# synchronizing retries (free the cache, wait, allocate again)
ALLOC_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def _bind() -> None:
    global _profiling, _record
    import torch

    _record = torch.profiler.record_function
    _profiling = torch.autograd._profiler_enabled
    gc.callbacks.append(_on_gc)


def region(name: str, device=None):
    """A ``record_function(name)`` range while a torch profiler records,
    else a shared no-op context.  ``name`` is a string literal (the
    ``event-trace-site`` rule).  With a CUDA ``device`` the region also
    adds the allocator's :data:`ALLOC_KEYS` deltas over it, and one to
    ``<name>.count``, to :data:`COUNTERS`."""
    if _profiling is None:
        _bind()
    if not _profiling():
        return _OFF
    if device is None or device.type != "cuda":
        return _record(name)
    return _AllocRegion(name, device)


class _AllocRegion:
    """A profiler range that counts the allocator's calls over it."""

    __slots__ = ("name", "device", "before", "rf")

    def __init__(self, name: str, device) -> None:
        self.name, self.device = name, device

    def _counts(self) -> List[int]:
        import torch

        stats = torch.cuda.memory_stats(self.device)
        return [stats.get(k, 0) for k in ALLOC_KEYS]

    def __enter__(self) -> None:
        self.before = self._counts()
        self.rf = _record(self.name)
        self.rf.__enter__()

    def __exit__(self, *exc) -> bool:
        self.rf.__exit__(*exc)
        for key, a, b in zip(ALLOC_KEYS, self._counts(), self.before):
            COUNTERS.counter(self.name + "." + key).inc(a - b)
        COUNTERS.counter(self.name + ".count").inc()
        return False


def _on_gc(phase: str, info: Dict[str, int]) -> None:
    """``gc.callbacks`` entry: each collection a ``repro.gc`` range, its
    count and host seconds, while a profiler records."""
    global _gc_open
    if phase == "start":
        if _profiling():
            _gc_open = _record("repro.gc")
            _gc_open.__enter__()
            _gc_clock.mark()
    elif _gc_open is not None:
        rf, _gc_open = _gc_open, None
        rf.__exit__(None, None, None)
        COUNTERS.counter("gc.pauses").inc()
        COUNTERS.counter("gc.seconds").inc(_gc_clock.lap())
