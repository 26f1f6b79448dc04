"""Distribution layer of the port: locality pricing and the sharding rules.

The serving / training analogue of the paper's Distributed Transactional
Dispatcher (DTD), which chooses per transaction between migrating the
work to the state's owner and fetching the state to the work:

* :mod:`repro_torch.dist.locality` (a copy of :mod:`repro.dist.locality`,
  stdlib only) re-expresses that choice in bytes over the interconnect;
* :mod:`repro_torch.dist.sharding` supplies the placement rules
  (parameter, batch and KV-cache specs) that make the owner of every
  tensor explicit, and this rank's block of it;
* :mod:`repro_torch.dist.comm` runs the reference's ``shard_map``
  collectives as per-rank code over a ``DeviceMesh``.
"""
from . import comm, locality, sharding

__all__ = ["comm", "locality", "sharding"]
