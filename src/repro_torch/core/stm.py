"""TL2-style local software transactional memory over a versioned array store.

Each replica holds a full copy of the replicated data set (values + version
stamps).  Transactions execute optimistically against a snapshot; at commit
time the read-set is validated (every read item's version must still equal the
version observed at read time).  Commits bump the global version clock and
stamp written items.

The per-item state lives in numpy arrays on the host for the
discrete-event simulator (execution reads single items there), and the
version table is mirrored as an int32 tensor on the store's device.
**Batched** validation — the certification hot loop used when a replica
validates many remote/forwarded transactions at once — runs on that
device table (:func:`validate_batch`), through the hand-written CUDA kernel
``repro_torch.kernels.lease_validate`` on the card: a drain packs its
transactions, the store's written versions and the lease layer's class
owners into the store's staging area, and one launch flushes and
certifies.
"""
from __future__ import annotations

import array
import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device


@dataclass
class ReadSetEntry:
    item: int
    version: int


def _read_log() -> array.array:
    return array.array("i")


@dataclass
class Transaction:
    """A transaction's footprint, as captured by its first (local) execution.

    The read log lives in one interleaved ``array.array`` int32 buffer
    (item, version, item, version, ...) rather than a list of records:
    appends are C-speed in the execution path, and the batched certification
    pipeline packs a whole batch with a single ``bytes.join`` memcpy instead
    of per-entry attribute walks (which would cost as much as the python
    validation loop the batching replaces).
    """

    txid: int
    origin: int
    read_log: array.array = field(default_factory=_read_log)
    write_set: Dict[int, float] = field(default_factory=dict)
    read_only: bool = False
    # conflict classes, filled by the replication manager via getConflictClasses
    ccs: frozenset = frozenset()
    # benchmark payload (e.g. bank partition id) used by OPT policies & stats
    tag: int = -1
    result: float = 0.0

    def log_read(self, item: int, version: int) -> None:
        self.read_log.append(item)
        self.read_log.append(version)

    @property
    def n_reads(self) -> int:
        return len(self.read_log) // 2

    @property
    def read_items(self) -> array.array:
        """The logged items (a copy; hot paths use ``read_log`` directly)."""
        return self.read_log[0::2]

    @property
    def read_set(self) -> List[ReadSetEntry]:
        """Record view of the read log (compat / inspection path)."""
        rl = self.read_log
        return [ReadSetEntry(rl[k], rl[k + 1])
                for k in range(0, len(rl), 2)]


class VersionedStore:
    """A replica's local copy of the replicated data: values + versions.

    ``values`` (float64) and ``versions`` (int64) live on the host.
    ``versions_dev`` is the int32 device mirror of ``versions`` that batched
    certification reads.  Every mutation site records the items it wrote
    (``_dirty``, int32), and a drain flushes only those, inside its own
    launch (:func:`validate_batch`); :meth:`device_versions` is the same
    flush for readers outside a drain.  Either way a drain moves the items
    written since the last flush, not the table.  ``staging`` is the
    store's drain area
    (:class:`~repro_torch.kernels.lease_validate.DrainStaging`), made at
    the first drain.  Write ``versions`` only through these methods
    (or :meth:`set_versions`).
    """

    def __init__(self, n_items: int, init_value: float = 0.0,
                 device="cuda") -> None:
        self.n_items = n_items
        self.init_value = init_value
        self.device = resolve_device(device)
        self.values = np.full((n_items,), init_value, dtype=np.float64)
        self.versions = np.zeros((n_items,), dtype=np.int64)
        self.versions_dev = torch.zeros((n_items,), dtype=torch.int32,
                                        device=self.device)
        self._dirty = array.array("i")   # items written since the last flush
        self.staging = None
        self.clock = 0  # global version clock (per replica copy)

    @classmethod
    def from_numpy(cls, values: np.ndarray, versions: np.ndarray,
                   device="cuda", clock: int | None = None,
                   init_value: float = 0.0) -> "VersionedStore":
        """A store holding copies of ``values``/``versions`` (e.g. a
        reference replica's state); ``clock`` defaults to the newest
        version."""
        values = np.asarray(values, dtype=np.float64)
        store = cls(values.shape[0], init_value, device)
        store.values[:] = values
        store.set_versions(versions)
        store.clock = int(store.versions.max(initial=0)) if clock is None \
            else int(clock)
        return store

    def set_versions(self, versions: np.ndarray) -> None:
        """Replace the whole version table (seeding a store) and re-upload
        its device mirror."""
        versions = np.asarray(versions, dtype=np.int64)
        if versions.shape != (self.n_items,):
            raise ValueError(f"versions has shape {versions.shape}, store "
                             f"holds {self.n_items} items")
        self.versions[:] = versions
        self.versions_dev = torch.from_numpy(
            versions.astype(np.int32)).to(self.device)
        del self._dirty[:]

    def device_versions(self) -> torch.Tensor:
        """The int32 device version table, with pending writes flushed."""
        if self._dirty:
            idx = np.unique(np.frombuffer(self._dirty, np.int32)).astype(
                np.int64)
            del self._dirty[:]
            # one host->device copy carries indices and versions together
            pair = torch.from_numpy(np.stack(
                [idx, self.versions[idx].astype(np.int32)])).to(self.device)
            self.versions_dev[pair[0]] = pair[1].to(torch.int32)
        return self.versions_dev

    def grow_to(self, n: int) -> None:
        """Grow capacity to at least ``n`` items (power-of-two steps),
        preserving contents.  The supported way for consumers to extend a
        store — direct writes to values/versions outside this module are
        lint-gated (state-mutation rule).  Pending writes stay pending: the
        next flush writes them into the grown table."""
        if n <= self.n_items:
            return
        cap = max(1, self.n_items)
        while cap < n:
            cap *= 2
        values = np.full((cap,), self.init_value, dtype=np.float64)
        versions = np.zeros((cap,), dtype=np.int64)
        values[: self.n_items] = self.values
        versions[: self.n_items] = self.versions
        versions_dev = torch.zeros((cap,), dtype=torch.int32,
                                   device=self.device)
        versions_dev[: self.n_items] = self.versions_dev
        self.values = values
        self.versions = versions
        self.versions_dev = versions_dev
        self.n_items = cap

    # -- execution-side API -------------------------------------------------
    def read(self, txn: Transaction, item: int) -> float:
        txn.log_read(item, int(self.versions[item]))
        if item in txn.write_set:
            return txn.write_set[item]
        return float(self.values[item])

    def write(self, txn: Transaction, item: int, value: float) -> None:
        txn.write_set[item] = value

    # -- certification ------------------------------------------------------
    def validate(self, txn: Transaction) -> bool:
        """TL2 read-set validation against the current store."""
        versions = self.versions
        rl = txn.read_log
        for k in range(0, len(rl), 2):
            if versions[rl[k]] != rl[k + 1]:
                return False
        return True

    def apply(self, write_set: Dict[int, float]) -> int:
        """Apply a validated write-set; returns the commit version."""
        self.clock += 1
        for item, value in write_set.items():
            self.values[item] = value
            self.versions[item] = self.clock
        self._dirty.extend(write_set)
        return self.clock

    def apply_versioned(self, write_set: Dict[int, float], version: int) -> None:
        """Apply a replicated write-set stamping items with the writer's txid.

        Txids are globally unique and conflicting commits are serialized by
        the lease layer, so per-item version sequences are identical at every
        replica regardless of URB delivery interleaving of non-conflicting
        commits — which is what makes cross-replica (forwarded) validation
        sound.
        """
        for item, value in write_set.items():
            self.values[item] = value
            self.versions[item] = version
        self._dirty.extend(write_set)
        self.clock = max(self.clock, version)

    def apply_batch(
        self,
        write_sets: Sequence[Dict[int, float]],
        versions: Sequence[int],
    ) -> None:
        """Apply many validated write-sets in one vectorized scatter.

        Equivalent to ``apply_versioned(ws, v)`` called in order — later
        write-sets win on item overlap (last-writer-wins is resolved
        explicitly, not left to fancy-indexing order), so the batched commit
        phase produces byte-identical ``values``/``versions`` arrays to the
        one-at-a-time path.
        """
        n = sum(len(ws) for ws in write_sets)
        if n == 0:
            return
        items = np.fromiter(
            (i for ws in write_sets for i in ws), np.int32, count=n)
        vals = np.fromiter(
            (v for ws in write_sets for v in ws.values()), np.float64, count=n)
        vers = np.repeat(
            np.asarray(list(versions), dtype=np.int64),
            [len(ws) for ws in write_sets],
        )
        # keep only the last write per item, preserving batch order
        _, first_in_rev = np.unique(items[::-1], return_index=True)
        keep = n - 1 - first_in_rev
        self.values[items[keep]] = vals[keep]
        self.versions[items[keep]] = vers[keep]
        self._dirty.frombytes(items[keep].tobytes())
        self.clock = max(self.clock, int(vers.max()))

    def total(self) -> float:
        return float(self.values.sum())


# ----------------------------------------------------------------------------
# Batched validation on the device — the certification hot loop.
# ----------------------------------------------------------------------------

def _pad_bucket(n: int, lo: int = 8) -> int:
    """Smallest power of two >= n (floored at ``lo``).

    Packing widths are quantized to power-of-two buckets, as in the
    reference (whose jit'd validation and Pallas kernel are
    shape-specialized), so both packages hand their kernels the same
    shapes.
    """
    b = lo
    while b < n:
        b <<= 1
    return b


def _scatter_rows(
    lens: np.ndarray, flat_a: np.ndarray, flat_b: np.ndarray | None,
    r: int, fill_a: int,
) -> Tuple[np.ndarray, np.ndarray | None]:
    """Scatter flat per-row segments into padded [B, r] arrays.

    ``flat_b`` may be None to pack a single column.
    """
    b = lens.shape[0]
    if b and int(lens[0]) == r and bool((lens == r).all()):
        # uniform rows fill the padded shape exactly: pure reshape+cast
        return (flat_a.astype(np.int32).reshape(b, r),
                None if flat_b is None else
                flat_b.astype(np.int32).reshape(b, r))
    items = np.full((b, r), fill_a, dtype=np.int32)
    vals = None if flat_b is None else np.zeros((b, r), dtype=np.int32)
    total = int(lens.sum())
    if total:
        rows = np.repeat(np.arange(b), lens)
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        cols = np.arange(total) - np.repeat(starts, lens)
        items[rows, cols] = flat_a
        if vals is not None:
            vals[rows, cols] = flat_b
    return items, vals


def pack_read_sets(
    txns: Sequence[Transaction], pad_to: int | None = None,
    pow2: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-transaction read sets into padded [B, R] arrays.

    ``pow2=True`` (the default) rounds R up to a power-of-two bucket; pass
    ``pad_to`` to force a wider row.  The per-entry work is a C-level
    buffer copy (``array.array.extend`` + one vectorized scatter), keeping
    packing far below the per-entry cost of the python validation loop.
    """
    b = len(txns)
    lens = np.fromiter((len(t.read_log) for t in txns), np.int64,
                       count=b) >> 1
    r = max(1, int(lens.max()) if b else 1)
    if pad_to is not None:
        r = max(r, pad_to)
    if pow2:
        r = _pad_bucket(r)
    # buffer-protocol copies pack the whole batch: each interleaved int32
    # log lands in a preallocated numpy buffer (no per-txn allocations),
    # deinterleaved by a vectorized reshape
    out = np.empty(int(lens.sum()) * 2, np.int32)
    mv = memoryview(out)
    pos = 0
    for t in txns:
        n = len(t.read_log)
        mv[pos:pos + n] = t.read_log
        pos += n
    flat = out.reshape(-1, 2)
    return _scatter_rows(lens, flat[:, 0], flat[:, 1], r, -1)


def pack_write_sets(
    txns: Sequence[Transaction], pad_to: int | None = None,
    pow2: bool = True,
) -> np.ndarray:
    """Pack per-transaction write *items* into a padded [B, W] array.

    -1 padded like the read-set packing so the certification kernels can
    mask them; the lock check only needs the items (write values stay in
    the per-transaction dicts that ``apply_batch`` consumes).
    """
    b = len(txns)
    lens = np.fromiter((len(t.write_set) for t in txns), np.int64, count=b)
    w = max(1, int(lens.max()) if b else 1)
    if pad_to is not None:
        w = max(w, pad_to)
    if pow2:
        w = _pad_bucket(w)
    flat_i = _read_log()
    for t in txns:
        flat_i.extend(t.write_set.keys())
    return _scatter_rows(
        lens,
        np.frombuffer(flat_i, dtype=np.int32) if flat_i else np.empty(0, np.int32),
        None, w, -1)[0]


class ClassLocks(NamedTuple):
    """The lease layer's ownership view for a drain's write check: a write
    item is locked when ``owners[item_cc[item]]`` is another replica."""
    item_cc: torch.Tensor   # [n_items] int32 item -> class, store's device
    owners: np.ndarray      # [n_classes] int32, -1 unowned
    node: int               # the certifying replica


def pack_drain(store: VersionedStore, txns: Sequence[Transaction],
               class_locks: ClassLocks | None = None):
    """Pack one drain into ``store.staging``; returns its views.

    The store's pending writes (their current versions), the class owners,
    the read rows and the write rows, with the power-of-two widths and -1
    padding of :func:`pack_read_sets` / :func:`pack_write_sets` and the row
    count bucketed to a power of two (padded rows certify True).  Each
    transaction's interleaved read log is copied as it is into its row of
    (item, version) pairs, and its write items, converted in one call, into
    theirs: one buffer copy a row and no per-row numpy call.  Without
    ``class_locks`` no write rows are packed (W = 0).
    """
    from ..kernels.lease_validate import DrainStaging

    if store.staging is None:
        store.staging = DrainStaging(store.device)
    r = _pad_bucket(max(len(t.read_log) for t in txns) >> 1)
    if class_locks is None:
        w, owners, node = 0, None, 0
    else:
        w = _pad_bucket(max(len(t.write_set) for t in txns))
        owners, node = class_locks.owners, class_locks.node
    dirty = np.frombuffer(store._dirty, np.int32)
    v = store.staging.begin(
        dirty.shape[0], _pad_bucket(len(txns)), r, w,
        0 if owners is None else owners.shape[0], node)
    v.dirty_idx[:] = dirty
    v.dirty_ver[:] = store.versions[dirty]
    v.read_items.fill(-1)
    v.read_versions.fill(0)
    rows = memoryview(v.reads.reshape(-1))
    for i, t in enumerate(txns):
        rows[2 * r * i:2 * r * i + len(t.read_log)] = t.read_log
    if owners is not None:
        v.owners[:] = owners
        v.write_items.fill(-1)
        rows = memoryview(v.write_items.reshape(-1))
        sets = [t.write_set for t in txns]
        lens = [len(ws) for ws in sets]
        flat = memoryview(np.fromiter(itertools.chain.from_iterable(sets),
                                      np.int32, sum(lens)))
        pos = 0
        for i, n in enumerate(lens):
            rows[w * i:w * i + n] = flat[pos:pos + n]
            pos += n
    return v


def validate_batch(store: VersionedStore, txns: Sequence[Transaction],
                   locks: torch.Tensor | None = None, *,
                   class_locks: ClassLocks | None = None) -> np.ndarray:
    """Batched TL2 certification of ``txns`` against ``store``.

    Two routes, by what the caller hands over:

    - ``locks``, an [n_items] 0/1 int32 tensor of write locks on the
      store's device (the reference's form): the rows are packed, the
      store's pending writes flushed (:meth:`VersionedStore.device_versions`)
      and :func:`repro_torch.kernels.ops.validate_transactions` dispatched:
      the ``gather`` kernel on the card, the torch twin on the CPU.
    - otherwise a drain (:func:`pack_drain`, then
      :func:`repro_torch.kernels.ops.certify_drain`): the ``drain`` kernel
      flushes and certifies in one launch and one wait on the card, its
      twin on the CPU.  ``class_locks`` gives the write check; without it
      every write check passes.

    A transaction writing a locked item fails certification.
    """
    if not txns:
        return np.zeros((0,), dtype=bool)
    if locks is not None:
        if class_locks is not None:
            raise ValueError("pass locks or class_locks, not both")
        return _validate_gather(store, txns, locks)
    from ..kernels.ops import certify_drain

    pack_drain(store, txns, class_locks)
    ok = certify_drain(store.versions_dev, store.staging,
                       None if class_locks is None else class_locks.item_cc)
    # the drain that flushed them is enqueued (and done): only now are the
    # pending writes cleared
    del store._dirty[:]
    return ok[:len(txns)].copy()


def _validate_gather(store: VersionedStore, txns: Sequence[Transaction],
                     locks: torch.Tensor) -> np.ndarray:
    """``validate_batch`` against a per-item lock tensor (``gather``)."""
    from ..kernels.ops import validate_transactions

    items, vers = pack_read_sets(txns)
    witems = pack_write_sets(txns)
    # bucket the row count too, like the reference — padded rows are
    # all-masked (items -1) and certify True, sliced off below
    b = len(txns)
    bp = _pad_bucket(b)
    if bp != b:
        items = np.pad(items, ((0, bp - b), (0, 0)), constant_values=-1)
        vers = np.pad(vers, ((0, bp - b), (0, 0)))
        witems = np.pad(witems, ((0, bp - b), (0, 0)), constant_values=-1)
    # one host->device copy carries every packed row: the kernel reads
    # contiguous views of it
    flat = torch.from_numpy(np.concatenate(
        [items.ravel(), vers.ravel(), witems.ravel()])).to(store.device)
    n_r = items.size
    d_items = flat[:n_r].view(items.shape)
    d_vers = flat[n_r:2 * n_r].view(vers.shape)
    d_witems = flat[2 * n_r:].view(witems.shape)
    out = validate_transactions(
        store.device_versions(), d_items, d_vers,
        write_locks=locks, write_items=d_witems)
    return out[:b].cpu().numpy()
