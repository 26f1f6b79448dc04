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
length and dtype.  A mesh (the seq-sharded columns) is ROADMAP queue 1
item 9.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from repro_torch import resolve_device
from repro_torch.models import decoder
from repro_torch.models.common import ModelConfig


@dataclass
class Session:
    sid: int
    slot: int
    length: int = 0              # tokens currently in the cache
    last_token: int = 0


def _leaves(caches: decoder.Cache):
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
        if mesh is not None:
            raise NotImplementedError("a seq-sharded KVStore is not ported "
                                      "yet (ROADMAP queue 1 item 9)")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.mesh = mesh
        self.device = resolve_device(device)
        self.caches = decoder.init_cache(cfg, n_slots, max_len, dtype,
                                         self.device)
        self.free_slots: List[int] = list(range(n_slots))[::-1]
        self.sessions: Dict[int, Session] = {}

    @property
    def seq_shards(self) -> int:
        """Parallel-hop divisor of a migrated column's bytes: 1 without a
        seq-sharded mesh (the only layout the port has)."""
        return 1

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
        ships): a copy, one slot wide on the batch dim."""
        s = self.sessions[sid]
        return {
            "sid": sid,
            "length": s.length,
            "last_token": s.last_token,
            "seq_shards": self.seq_shards,
            "tree": _map_columns(lambda leaf: leaf[s.slot:s.slot + 1].clone(),
                                 self.caches),
        }

    def import_session(self, blob: Dict[str, Any]) -> Session:
        """Write an exported column into this store's slot for its session
        (allocated if new), in place."""
        s = self.alloc(blob["sid"])
        s.length = blob["length"]
        s.last_token = blob["last_token"]

        def put(dst, src):
            dst[s.slot] = src[0].to(device=dst.device, dtype=dst.dtype)

        _map_columns(put, self.caches, blob["tree"])
        return s

    def nbytes_session(self) -> float:
        """Bytes shipped per exported session (for the cost model)."""
        total = 0
        for leaf in _leaves(self.caches):
            total += leaf.numel() * leaf.element_size() / self.n_slots
        return total
