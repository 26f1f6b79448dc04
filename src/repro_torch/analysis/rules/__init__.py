"""Lint rule registry.  Each module exposes a RULE with id/doc/check."""
from __future__ import annotations

from . import (ctypes_sig, event_determinism, host_sync, id_dtype, ops_ref,
               pow2_pad, state_mut, trace_site)

ALL_RULES = [
    host_sync.RULE,
    id_dtype.RULE,
    ops_ref.RULE,
    state_mut.RULE,
    ctypes_sig.RULE,
    pow2_pad.RULE,
    event_determinism.RULE,
    trace_site.RULE,
]
