"""Batched KV-session store: fixed-slot ring caches + alloc/free ledger.

The port of :mod:`repro.serve.kvcache`.  The engine decodes a *batch* of
sessions at once; each session owns a slot in the batched caches of
``decoder.init_cache``.  Slots are recycled; session -> slot indirection
lives here.  ``export_session`` / ``import_session`` move one session's
cache column between pods (the "migrate state" branch of the locality
router).

In the port's cache layout (one dict per layer) every leaf has the batch at
dim 0, so the reference's ``_map_with_bdim`` (batch at dim 1 in its scanned
``body`` entries) reduces to dim 0 here.  The caches are the same bytes:
``nbytes_session`` equals the reference's for the same config, slots,
length and dtype.

On a mesh (``KVStore(mesh=)``) the store holds this rank's blocks of the
slot rings, laid out by :func:`repro_torch.dist.sharding.cache_pspecs`:
the slots over the batch axes, kv heads over the model axis and each
attention ring cut into seq chunks, so a long session's column is spread
over the seq ranks.  An exported column is this rank's chunk of it (each
chunk a separate wire transfer: ``1 / seq_shards`` of the bytes per hop,
what the router prices); the blob says which layout it came from, and an
import writes it into the same layout, or cuts a whole column into this
rank's chunk.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.dist import comm
from repro_torch.dist import sharding as shd
from repro_torch.models import decoder
from repro_torch.models.common import ModelConfig


@dataclass
class Session:
    sid: int
    slot: int
    length: int = 0              # tokens currently in the cache
    last_token: int = 0


def _leaves(caches):
    for layer in caches:
        for mixer in layer.values():
            yield from mixer.values()


def _map_columns(fn, caches: decoder.Cache, *rest: decoder.Cache):
    """``fn(leaf, *leaves)`` over matching leaves of per-layer cache lists."""
    return [{mixer: {name: fn(leaf, *(r[i][mixer][name] for r in rest))
                     for name, leaf in leaves.items()}
             for mixer, leaves in layer.items()}
            for i, layer in enumerate(caches)]


class KVStore:
    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16, *, device="cuda",
                 mesh=None) -> None:
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.mesh = mesh
        self.device = resolve_device(device)
        # the whole trees' shapes (meta tensors: no memory) and, on a mesh,
        # the ledger's specs of them
        self._whole = decoder.init_cache(cfg, n_slots, max_len, dtype, "meta")
        self._pspecs = None
        if mesh is not None:
            self._pspecs = shd.cache_pspecs(cfg, mesh, self._whole, n_slots)
        self.caches = decoder.init_cache(cfg, n_slots, max_len, dtype,
                                         self.device, mesh=mesh)
        self.free_slots: List[int] = list(range(n_slots))[::-1]
        self.sessions: Dict[int, Session] = {}

    @property
    def seq_shards(self) -> float:
        """Effective parallel-hop divisor for a migrated column's bytes.

        Byte-weighted over the leaves the ledger seq-shards: a leaf with
        the seq axis ships as ``seq``-many parallel chunks, anything
        without a seq dim (the mamba conv/ssm state) ships whole.  A pure
        attention cache on an 8-way seq mesh reports 8.0, a pure mamba
        cache 1.0 whatever the mesh; hybrids land in between.  1 without a
        seq-sharded mesh.
        """
        if self._pspecs is None:
            return 1
        ssize = shd.MeshAxes.for_mesh(self.mesh).seq_size(self.mesh)
        if ssize <= 1:
            return 1
        total = hop = 0.0
        for leaf, spec in zip(_leaves(self._whole), _leaves(self._pspecs)):
            nb = leaf.numel() * leaf.element_size() / self.n_slots
            total += nb
            hop += nb / (ssize if shd.SEQ_AXIS in spec else 1.0)
        return total / hop if hop > 0 else 1

    def _layout(self) -> Optional[Tuple[int, int]]:
        """(seq rank, model rank) of this rank's blocks; None off a mesh."""
        if self.mesh is None:
            return None
        ax = shd.MeshAxes.for_mesh(self.mesh)
        return (comm.rank(self.mesh, ax.seq) if ax.seq else 0,
                comm.rank(self.mesh, ax.model)
                if ax.model in self.mesh.mesh_dim_names else 0)

    def _slot_home(self) -> Tuple[Tuple[str, ...], int]:
        """(the batch axes the slots are cut over, slots per rank)."""
        if self._pspecs is None:
            return (), self.n_slots
        spec = next(iter(_leaves(self._pspecs)))
        axes = comm.axes_of(spec[0] if spec else None)
        return axes, self.n_slots // comm.size(self.mesh, axes)

    # -- session lifecycle -------------------------------------------------
    def alloc(self, sid: int) -> Session:
        if sid in self.sessions:
            return self.sessions[sid]
        if not self.free_slots:
            raise RuntimeError("KV store full")
        s = Session(sid, self.free_slots.pop())
        self.sessions[sid] = s
        return s

    def free(self, sid: int) -> None:
        s = self.sessions.pop(sid, None)
        if s is not None:
            self.free_slots.append(s.slot)

    def has(self, sid: int) -> bool:
        return sid in self.sessions

    # -- cross-pod state migration ------------------------------------------
    def export_session(self, sid: int) -> Dict[str, Any]:
        """Slice one session's cache column out (the bytes a lease move
        ships): a copy, one slot wide on the batch dim.

        On a mesh, this rank's seq / kv-head chunk of the column; where the
        slots are cut over the batch axes, the rank that holds the slot
        broadcasts the column's chunks to the others first.
        """
        s = self.sessions[sid]
        axes, per = self._slot_home()
        owner, at = divmod(s.slot, per)

        def column(leaf):
            col = leaf[at:at + 1].clone()
            if axes:
                comm.broadcast_(col, self.mesh, axes, owner)
            return col

        return {
            "sid": sid,
            "length": s.length,
            "last_token": s.last_token,
            "seq_shards": self.seq_shards,
            "layout": self._layout(),
            "tree": _map_columns(column, self.caches),
        }

    def import_session(self, blob: Dict[str, Any]) -> Session:
        """Write an exported column into this store's slot for its session
        (allocated if new), in place.

        On a mesh the column lands in this rank's chunks: a blob of the
        same layout writes as it is, a whole column (exported off a mesh)
        is cut to this rank's block; another seq / model layout raises.
        """
        s = self.alloc(blob["sid"])
        s.length = blob["length"]
        s.last_token = blob["last_token"]
        axes, per = self._slot_home()
        owner, at = divmod(s.slot, per)
        if axes and comm.rank(self.mesh, axes) != owner:
            return s                     # another rank holds this slot
        mine = self._layout()
        whole = blob.get("layout") is None and mine is not None
        if not whole and blob.get("layout") != mine:
            raise ValueError(f"a column of layout {blob.get('layout')} does "
                             f"not land in this store's {mine}")
        specs = self._pspecs

        def put(dst, src, spec=None):
            if whole:
                src = shd.local_shard(src, (None,) + tuple(spec[1:]),
                                      self.mesh)
            dst[at] = src[0].to(device=dst.device, dtype=dst.dtype)

        if whole:
            _map_columns(put, self.caches, blob["tree"], specs)
        else:
            _map_columns(put, self.caches, blob["tree"])
        return s

    def nbytes_session(self) -> float:
        """Bytes shipped per exported session (for the cost model): the
        whole column's, on a mesh too."""
        total = 0
        for leaf in _leaves(self._whole):
            total += leaf.numel() * leaf.element_size() / self.n_slots
        return total
