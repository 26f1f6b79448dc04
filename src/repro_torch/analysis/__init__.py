"""repro_torch.analysis — runtime and static checks of the port.

The port of :mod:`repro.analysis`'s runtime engines:

* :mod:`repro_torch.analysis.sanitizer` — runtime lease-protocol invariant
  checker (``SimConfig.sanitize=True`` / ``StepCertifier(sanitize=True)``)
  asserting Algorithm 1's invariants per delivery instant, and the drain's
  verdicts against the lease layer's ownership view.
* :mod:`repro_torch.analysis.explore` — the schedule-space explorer
  (``python -m repro_torch.analysis.explore``), a stateless model checker
  over legal delivery reorderings of the simulator.

and the static lint:

* :mod:`repro_torch.analysis.lint` — repo-specific AST checks
  (``python -m repro_torch.analysis.lint``), stdlib-only, over
  ``src/repro_torch`` with an empty baseline: the reference's framework
  and six of its rules pointed at the port, ``host-sync`` rewritten for
  eager torch (host waits in the bodies that run per step or per drain)
  and ``ctypes-sig`` for the kernels' ctypes tables.

The sanitizer import is deferred so importing the package pulls in nothing.
"""
from __future__ import annotations

__all__ = ["LeaseSanitizer", "SanitizerError", "check_write_locks"]


def __getattr__(name):
    if name in __all__:
        from . import sanitizer

        return getattr(sanitizer, name)
    raise AttributeError(name)
