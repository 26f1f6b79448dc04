"""Per-device counts of the port's own code: the dry run's counting pass.

The counterpart of :mod:`repro.launch.hlo_count`, which reads dot FLOPs,
elementwise FLOPs and collectives out of a compiled module's optimized
HLO, multiplying each ``while`` body by its trip count.  The port has no
HLO to read: it counts while its own code runs, normally on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, dtypes and
devices, no data and no memory) over a world of fake ranks
(:func:`repro_torch.launch.mesh.make_production_mesh`), so one host
process counts what one rank of a 16 x 16 mesh does.  Eager code has no
``while``: every layer runs and is counted, so nothing is multiplied.

* **dot FLOPs** — ``torch.utils.flop_counter.FlopCounterMode``: every
  matrix product (``mm``, ``bmm``, the einsums, attention's products),
  forward and backward;
* **elementwise FLOPs** — one per output element of every pointwise op
  and reduction (``hlo_count``'s rule);
* **collectives** — the ``(op, dtype, result shape, group size)`` records
  of :func:`repro_torch.dist.comm.recording`, priced by
  :func:`repro_torch.launch.roofline.collective_bytes`;
* **peak bytes** — ``torch.distributed._tools.mem_tracker.MemTracker``'s
  peak of the live tensors, the ``external`` ones (parameters, optimizer
  state, caches, made before the pass) included.

The same counts come from a world of real ranks running the same code on
real tensors (the CPU tests hold the two equal).

Example::

    with FakeTensorMode():
        w = torch.zeros(4096, 4096)
        with counting(external=[w]) as c:
            torch.zeros(8, 4096) @ w
    c.dot_flops, c.peak_bytes
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.dist import comm

from .roofline import CollectiveStats, collective_bytes

_REDUCTIONS = {torch.ops.aten.sum, torch.ops.aten.mean, torch.ops.aten.amax,
               torch.ops.aten.amin, torch.ops.aten.max, torch.ops.aten.min,
               torch.ops.aten.logsumexp, torch.ops.aten.prod,
               torch.ops.aten.cumsum, torch.ops.aten._softmax,
               torch.ops.aten._log_softmax}


@dataclass
class Counts:
    """What one rank did inside :func:`counting`."""

    dot_flops: float = 0.0
    elemwise_flops: float = 0.0
    records: List[tuple] = field(default_factory=list)
    peak_bytes: int = 0

    @property
    def flops(self) -> float:
        return self.dot_flops + self.elemwise_flops

    def collectives(self) -> CollectiveStats:
        return collective_bytes(self.records)


class _Elementwise(TorchDispatchMode):
    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.Tag.pointwise in func.tags or \
                func.overloadpacket in _REDUCTIONS:
            self.counts.elemwise_flops += float(sum(
                t.numel() for t in tree_leaves(out)
                if isinstance(t, torch.Tensor)))
        return out


def _total_peak(snapshot) -> int:
    return int(sum(v.get("Total", 0) for v in snapshot.values()))


@contextlib.contextmanager
def counting(external: Iterable[torch.Tensor] = ()) -> Iterator[Counts]:
    """Count everything run inside the block into the yielded
    :class:`Counts` (filled in when the block ends)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    counts = Counts()
    tracker = MemTracker()
    ext = list(external)
    if ext:
        tracker.track_external(*ext)
    flops = FlopCounterMode(display=False)
    with comm.recording() as records, tracker, flops, _Elementwise(counts):
        yield counts
    counts.dot_flops = float(flops.get_total_flops())
    counts.records = list(records)
    counts.peak_bytes = _total_peak(tracker.get_tracker_snapshot("peak"))
