"""repro_torch.analysis — runtime checks of the lease/certification stack.

The port of :mod:`repro.analysis`'s runtime engines:

* :mod:`repro_torch.analysis.sanitizer` — runtime lease-protocol invariant
  checker (``SimConfig.sanitize=True`` / ``StepCertifier(sanitize=True)``)
  asserting Algorithm 1's invariants per delivery instant, and the drain's
  verdicts against the lease layer's ownership view.
* :mod:`repro_torch.analysis.explore` — the schedule-space explorer
  (``python -m repro_torch.analysis.explore``), a stateless model checker
  over legal delivery reorderings of the simulator.

The reference's static lint (``repro.analysis.lint`` and its rules) reads
jit/jnp idioms in source text and has no counterpart here.

The sanitizer import is deferred so importing the package pulls in nothing.
"""
from __future__ import annotations

__all__ = ["LeaseSanitizer", "SanitizerError", "check_write_locks"]


def __getattr__(name):
    if name in __all__:
        from . import sanitizer

        return getattr(sanitizer, name)
    raise AttributeError(name)
