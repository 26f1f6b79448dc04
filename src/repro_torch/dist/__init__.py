"""Distribution layer of the port: the DTD's locality pricing in bytes.

:mod:`repro_torch.dist.locality` is a copy of :mod:`repro.dist.locality`
(stdlib only).  The reference's SPMD sharding rules
(``repro.dist.sharding``) are not ported yet: ROADMAP queue 1 item 9.
"""
from . import locality

__all__ = ["locality"]
