"""Batched TL2 certification — the hand-written Hopper kernels and wrappers.

Replaces the Pallas TPU kernel ``repro/kernels/lease_validate.py``
(``lease_validate`` / ``_validate_kernel``).  The CUDA source is
``csrc/lease_validate.cu`` (design notes there), with two variants; which
one runs follows from what the caller hands over, and :func:`variant` is
the launchers' twin:

- ``gather`` (:func:`lease_validate`) takes a per-item lock tensor: one
  warp per transaction gathering straight from the L2-resident version
  table, instead of the TPU's chunk-local masked compare.  Bound by bytes;
  at the simulator's shapes by the launch.
- ``drain`` (:func:`lease_drain`) takes the lease layer's class-owner view
  and does a whole certification drain in one launch: it scatters the
  store's written versions into the device table, then certifies every
  transaction against it, locking a write item whose class another replica
  owns.  Its inputs are packed by the host into a :class:`DrainStaging`
  area of pinned, device-mapped memory, and the one ctypes call launches
  and waits.

The shared library is built by :mod:`.nvcc` at first use, keyed by a hash
of the source and flags, into ``build/`` at the repository root, and loaded
with ``ctypes``.  Nothing is built or imported at module import.

Semantics follow :func:`repro_torch.kernels.ref.lease_validate_ref` and
:func:`~repro_torch.kernels.ref.lease_drain_ref`: an item is clipped to
``[0, n_items - 1]`` and a negative slot always passes.  The Pallas kernel
differs for items past the end (it pads the table with -2 and ignores
them); callers never pass such items.
"""
from __future__ import annotations

import contextlib
import ctypes
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .nvcc import CudaLibrary, check_launch

LIB = CudaLibrary("lease_validate", {
    "lease_validate_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        ctypes.c_int),
    "lease_drain_launch": (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
         ctypes.c_void_p],
        ctypes.c_int),
    "lease_drain_empty": ([ctypes.c_void_p], ctypes.c_int),
    "lease_staging_alloc": (
        [ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)],
        ctypes.c_int),
    "lease_staging_free": ([ctypes.c_void_p], ctypes.c_int),
})
VARIANTS = ("gather", "drain")
GATHER_TXNS_PER_CTA = 8        # gather: 8 warps a block
DRAIN_TXNS_PER_CTA = 32        # drain: 1024 threads, one warp a transaction
DRAIN_DIRTY_PER_CTA = 8192     # drain: 8 dirty pairs a thread
DRAIN_MAX_CLUSTER = 8          # drain: the portable cluster size
HEADER_WORDS = 8
# lease_drain_launch's refusals (nothing was launched)
_DRAIN_REFUSALS = {
    -1: "the staging header is malformed",
    -2: "the staging area is smaller than its header says",
    -3: "a dirty item lies outside the version table",
    -4: "item_cc and the header's class count disagree",
    -5: "mapped host memory has no unified address",
}

# kernel launches since the count was last reset (plain integers: the
# wrappers add one where they launch, nowhere else), in all and by variant
launches = 0
variant_launches = {name: 0 for name in VARIANTS}


def variant(b: int, n_dirty: int, *, per_item_locks: bool
            ) -> Tuple[str, int, int]:
    """``(variant, CTAs, kernels)`` the launchers take: their twin.

    A per-item lock tensor goes to ``gather`` (8 transactions a block);
    anything else to ``drain``: one 1024-thread CTA up to 32 transactions
    and 8192 dirty pairs, a thread-block cluster of up to 8 CTAs beyond
    that, and two launches (scatter, then certify) above 8 CTAs.
    """
    if per_item_locks:
        return "gather", -(-b // GATHER_TXNS_PER_CTA), 1
    ctas = max(1, -(-b // DRAIN_TXNS_PER_CTA),
               -(-n_dirty // DRAIN_DIRTY_PER_CTA))
    return "drain", ctas, 1 if ctas <= DRAIN_MAX_CLUSTER else 2


def drain_layout(n_dirty: int, b: int, r: int, w: int, n_classes: int
                 ) -> Tuple[Tuple[int, ...], int]:
    """Word offsets of a staging area's sections and its size in bytes.

    The sections follow an 8-word header ``(n_dirty, B, R, W, node,
    n_classes, 0, 0)``, each padded to 16 bytes: dirty items, their
    versions, the class owners, the reads ``[B, R, 2]`` as (item, version)
    pairs (a read log's own layout), write items ``[B, W]`` and ``ok[B]``
    (bytes).  Twin of ``drain::layout`` in ``csrc/lease_validate.cu``.
    """
    sizes = (n_dirty, n_dirty, n_classes, 2 * b * r, b * w, -(-b // 4))
    offsets, at = [], HEADER_WORDS
    for n in sizes:
        offsets.append(at)
        at += -(-n // 4) * 4
    return tuple(offsets), 4 * at


class DrainViews(NamedTuple):
    """numpy views of one drain's sections of a :class:`DrainStaging`."""
    dirty_idx: np.ndarray       # [n_dirty] int32
    dirty_ver: np.ndarray       # [n_dirty] int32
    owners: np.ndarray          # [n_classes] int32, -1 unowned
    reads: np.ndarray           # [B, R, 2] int32 (item, version) pairs
    read_items: np.ndarray      # [B, R] int32, -1 padded: reads[..., 0]
    read_versions: np.ndarray   # [B, R] int32: reads[..., 1]
    write_items: np.ndarray     # [B, W] int32, -1 padded
    ok: np.ndarray              # [B] bool, written by the certification
    node: int


class DrainStaging:
    """One store's drain area: the inputs of a drain and its verdicts.

    On CUDA it is pinned host memory mapped into the card's address space
    (allocated by the C library, grown in powers of two, freed with the
    object); the host packs straight into it and the drain kernel reads it
    over PCIe and writes ``ok`` back into it.  On the CPU it is a numpy
    buffer, so the packing is the same on both.  One area serves every
    drain of its store: :meth:`begin` may overwrite it only because each
    drain waits for its verdicts before the next one packs.
    """

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.nbytes = 0
        self.words = np.zeros(0, np.int32)
        self.views: Optional[DrainViews] = None
        self.counts = (0, 0)             # (n_dirty, B) of the packed drain
        self.plan = (ctypes.c_int * 2)()   # the launcher's (CTAs, kernels)
        self._host: Optional[int] = None
        self._free = None

    def _reserve(self, nbytes: int) -> None:
        if nbytes <= self.nbytes:
            return
        cap = max(4096, self.nbytes)
        while cap < nbytes:
            cap *= 2
        if self.device.type != "cuda":
            self.words = np.zeros(cap // 4, np.int32)
            self.nbytes = cap
            return
        lib = LIB.load()
        host = ctypes.c_void_p()
        err = lib.lease_staging_alloc(cap, self.device.index,
                                      ctypes.byref(host))
        if err:
            raise RuntimeError(_DRAIN_REFUSALS.get(
                err, f"staging allocation failed: CUDA error {err}"))
        if self._free is not None:
            self._free()
        self._free = weakref.finalize(self, lib.lease_staging_free,
                                      host.value)
        self._host = host.value
        self.words = np.frombuffer(
            (ctypes.c_int32 * (cap // 4)).from_address(host.value), np.int32)
        self.nbytes = cap

    def begin(self, n_dirty: int, b: int, r: int, w: int, n_classes: int,
              node: int) -> DrainViews:
        """Size the area for one drain, write its header, return its views."""
        offsets, nbytes = drain_layout(n_dirty, b, r, w, n_classes)
        self._reserve(nbytes)
        words = self.words
        words[:6] = (n_dirty, b, r, w, node, n_classes)
        self.counts = (n_dirty, b)
        o_di, o_dv, o_own, o_rd, o_wi, o_ok = offsets
        reads = words[o_rd:o_rd + 2 * b * r].reshape(b, r, 2)
        self.views = DrainViews(
            words[o_di:o_di + n_dirty], words[o_dv:o_dv + n_dirty],
            words[o_own:o_own + n_classes], reads, reads[..., 0],
            reads[..., 1], words[o_wi:o_wi + b * w].reshape(b, w),
            words[o_ok:].view(np.bool_)[:b], node)
        return self.views


def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device
           ) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lease_validate(store_versions: torch.Tensor, read_items: torch.Tensor,
                   read_versions: torch.Tensor, write_locks: torch.Tensor,
                   write_items: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``ok[B]`` bool.

    ``store_versions``/``write_locks``: ``[n_items]`` int32 (locks 0/1);
    ``read_items``/``read_versions``: ``[B, R]`` int32, -1 padded;
    ``write_items``: ``[B, W]`` int32, -1 padded.  Raises on anything
    else, on a failed build and on a refused launch.
    """
    global launches
    if store_versions.device.type != "cuda":
        raise ValueError("lease_validate launches on CUDA tensors only; "
                         "CPU callers use ref.lease_validate_ref")
    dev = store_versions.device
    _check("store_versions", store_versions, 1, dev)
    _check("write_locks", write_locks, 1, dev)
    _check("read_items", read_items, 2, dev)
    _check("read_versions", read_versions, 2, dev)
    _check("write_items", write_items, 2, dev)
    n = store_versions.shape[0]
    b, r = read_items.shape
    if n < 1:
        raise ValueError("store_versions is empty")
    if write_locks.shape[0] != n:
        raise ValueError(f"write_locks has {write_locks.shape[0]} items, "
                         f"store_versions {n}")
    if read_versions.shape != read_items.shape:
        raise ValueError(f"read_versions {tuple(read_versions.shape)} != "
                         f"read_items {tuple(read_items.shape)}")
    if write_items.shape[0] != b:
        raise ValueError(f"write_items has {write_items.shape[0]} rows, "
                         f"read_items {b}")
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return ok
    lib = LIB.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lease_validate_launch(
            store_versions.data_ptr(), read_items.data_ptr(),
            read_versions.data_ptr(), write_locks.data_ptr(),
            write_items.data_ptr(), ok.data_ptr(), n, b, r,
            write_items.shape[1], stream)
    check_launch("lease_validate", err)
    launches += 1
    variant_launches["gather"] += 1
    return ok


def lease_drain(table: torch.Tensor, staging: DrainStaging,
                item_cc: Optional[torch.Tensor] = None, *,
                wait: bool = True) -> np.ndarray:
    """One certification drain on the card; returns ``ok[B]`` (a view).

    ``table``: the store's ``[n_items]`` int32 device version table, which
    the drain updates in place with the dirty pairs of ``staging`` (packed
    by :meth:`DrainStaging.begin` and its caller).  ``item_cc``:
    ``[n_items]`` int32 item -> class on the same device, or None when
    there is no class view (every write check passes).  The one ctypes
    call launches on PyTorch's current stream and waits for the verdicts
    (``wait=False`` only to capture the launch in a CUDA graph, which must
    not wait).  The returned view lies in the staging area:
    the next drain overwrites it (or, growing the area, frees it).  Raises
    on bad inputs, on a failed build and on a refused launch.
    """
    global launches
    if table.device.type != "cuda":
        raise ValueError("lease_drain launches on CUDA tensors only; CPU "
                         "callers use ref.lease_drain_ref")
    dev = table.device
    _check("table", table, 1, dev)
    n = table.shape[0]
    if n < 1:
        raise ValueError("table is empty")
    if staging.device != dev or staging.views is None:
        raise ValueError(f"staging area for {staging.device} is not packed "
                         f"for a drain on {dev}")
    n_dirty, b = staging.counts
    if item_cc is not None:
        _check("item_cc", item_cc, 1, dev)
        if item_cc.shape[0] != n:
            raise ValueError(f"item_cc has {item_cc.shape[0]} items, table "
                             f"{n}")
    if b == 0 and n_dirty == 0:
        return staging.views.ok
    _, ctas, kernels = variant(b, n_dirty, per_item_locks=False)
    plan = staging.plan
    lib = LIB.load()
    with _on(dev):
        err = lib.lease_drain_launch(
            staging._host, staging.nbytes, table.data_ptr(), n,
            None if item_cc is None else item_cc.data_ptr(), int(wait), plan,
            _raw_stream(dev))
    if err < 0:
        raise ValueError(f"lease_drain refused: {_DRAIN_REFUSALS[err]}")
    check_launch("lease_drain", err)
    if (plan[0], plan[1]) != (ctas, kernels):
        raise RuntimeError(f"lease_drain: the launcher took {tuple(plan)} "
                           f"(CTAs, kernels), variant() says "
                           f"{(ctas, kernels)}")
    launches += 1
    variant_launches["drain"] += 1
    return staging.views.ok


def empty_drain(device: torch.device) -> None:
    """The drain's floor: an empty kernel through the same ctypes launch
    and wait (a measurement; counts no launch)."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = LIB.load()
    with _on(device):
        err = lib.lease_drain_empty(_raw_stream(device))
    check_launch("lease_drain_empty", err)


def _raw_stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a handle.  The private
    accessor is the one PyTorch's own generated kernels use: the public
    ``current_stream().cuda_stream`` builds a Stream object and costs more
    than the launch itself (PERF.md, PR 15)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _on(device: torch.device):
    """``device`` made current only where it is not already (the switch
    costs a few us a drain: PERF.md, PR 15)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
