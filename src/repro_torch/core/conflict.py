"""Conflict-class abstraction (the lease granularity indirection of ALC).

ALC/Lilac-TM associate leases with *conflict classes* rather than raw data
items: ``getConflictClasses`` maps a set of data items to the set of classes
that must be leased before the transaction can be certified.  The mapping
granularity trades accuracy (aliasing) for efficiency (lease-table size) —
exactly the knob discussed in the paper (§1, [3]).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, FrozenSet


@dataclass(frozen=True)
class ConflictClassMap:
    """Hash-partitioned item → conflict-class map.

    ``n_classes`` conflict classes; item ``k`` belongs to class
    ``(k * _MIX) % n_classes`` unless an explicit ``partition_of`` override is
    installed (used by the Bank benchmark to align classes with account
    partitions so that locality in *items* translates into locality in
    *leases*).
    """

    n_classes: int
    stride: int = 1  # items per contiguous class block (1 = pure modulo)

    def of_item(self, item: int) -> int:
        return (item // self.stride) % self.n_classes

    def get_conflict_classes(self, items: Iterable[int]) -> FrozenSet[int]:
        """The paper's ``getConflictClasses`` primitive."""
        return frozenset(self.of_item(i) for i in items)
