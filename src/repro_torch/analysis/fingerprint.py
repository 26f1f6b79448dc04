"""Canonical protocol-state fingerprints for the schedule explorer.

Two explored schedules that reach the same protocol state *and* the same
pending-event future will unfold identically from there — the explorer
dedupes on this fingerprint and counts the pruned continuations
(``states_deduped``).

Soundness note: a *false merge* (two genuinely different states hashing
equal) silently prunes schedules, so the fingerprint errs conservative —
it must cover every input the continuation depends on.  Delivery events
are identified schedule-robustly by their
:class:`~repro_torch.core.events.EvMeta`
(kind, chain position, label) with the scheduling ``seq`` excluded, because seqs
legitimately differ between interleavings that reach the same state.
*Unlabeled* local events (``meta is None``) are opaque closures, so for
them the seq IS the identity — including it forfeits some merging but
never merges distinct continuations.  For the full cluster model the state
side additionally covers the hidden inputs of future behavior: workload
RNG states, id counters, per-transaction phase, per-replica slot/stat
state, and the GCS sequencer clock.

The port's changes: :func:`_blob` canonicalises a ``torch.Tensor`` by
dtype, shape and bytes (``repr`` elides a large tensor's middle, so two
different states would hash equal) and a ``torch.device`` by name.  A
replica's store is hashed by its host ``values``/``versions``, which are
authoritative: the device table is flushed from them.  An object whose
repr is the default one (type and address; the planner's
``AffinityTracker``) is identified by a serial number given when a
fingerprint first meets it, not by its address: an address is reused once
its object is freed, so an object of one explored run could hash equal to
another run's (a false merge, and a dedup count that depended on the
allocator: the planner cell's runs differed between processes).
"""
from __future__ import annotations

import hashlib
import itertools
import weakref
from typing import Tuple

import numpy as np
import torch


def digest(*parts) -> str:
    """Stable short hex digest of canonical (repr-able) state tuples."""
    h = hashlib.blake2b(digest_size=12)
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()


# serial numbers of the default-repr objects fingerprints have met
_SERIALS: "weakref.WeakKeyDictionary[object, int]" = weakref.WeakKeyDictionary()
_NEXT_SERIAL = itertools.count()


def _identity(o):
    """A default-repr object's identity that no later object can take."""
    if o not in _SERIALS:
        _SERIALS[o] = next(_NEXT_SERIAL)
    return ("object", type(o).__qualname__, _SERIALS[o])


def _blob(o):
    """Canonicalize arbitrary small state for hashing (arrays by bytes)."""
    if isinstance(o, np.ndarray):
        return ("nd", str(o.dtype), o.shape, o.tobytes())
    if isinstance(o, torch.Tensor):
        return ("tensor", str(o.dtype), tuple(o.shape),
                o.detach().cpu().contiguous().reshape(-1)
                .view(torch.uint8).numpy().tobytes())
    if isinstance(o, torch.device):
        return ("device", str(o))
    if isinstance(o, dict):
        return tuple(sorted(((repr(k), _blob(v)) for k, v in o.items())))
    if isinstance(o, (list, tuple)):
        return tuple(_blob(x) for x in o)
    if isinstance(o, (set, frozenset)):
        return tuple(sorted(repr(x) for x in o))
    if type(o).__repr__ is object.__repr__ and hasattr(o, "__weakref__"):
        return _identity(o)
    return repr(o)


def queue_state(events) -> Tuple:
    """Canonical view of the pending events of an ``EventQueue``."""
    out = []
    for ev in events.pending():
        m = ev.meta
        t = round(ev.time, 9)
        if m is None:
            out.append((t, "local", ev.seq))
        elif m.kind == "local":
            # labeled local events are identified by their label (the
            # scenario harnesses label every scheduled step)
            out.append((t, m.kind, m.node, m.label, ev.seq if not m.label
                        else -1))
        else:
            out.append((t, m.kind, m.node, m.chain, m.cseq, m.label))
    return tuple(out)


def cluster_state(cluster) -> Tuple:
    """Canonical behavioral state of a ``repro_torch`` ``Cluster``."""
    reps = []
    for r in cluster.replicas:
        store = r.store
        reps.append((
            r.node,
            cluster.gcs.alive(r.node),
            r.lm.protocol_state(),
            int(store.clock),
            digest(store.versions.tobytes(), store.values.tobytes()),
            tuple(sorted(t.txid for (t, _l) in r.waiters)),
            tuple(sorted(r.pending_reqs)),
            len(r.prefetch_waiters),
            tuple(sorted(t.txid for t in r.certify_queue)),
            bool(r.certify_pending),
            r.free_slots,
            len(r.slot_queue),
            round(r.slowdown, 9),
            digest(_blob(vars(r.freq)), r.cpu_view.tobytes(),
                   _blob(vars(r.meter))),
        ))
    txns = tuple(
        (t.txid, t.origin, t.exec_node, t.thread, t.reexecs, t.forwards,
         t.reused, t.early, t.exec_done)
        for t in (cluster._inflight[k] for k in sorted(cluster._inflight)))
    m = cluster.metrics
    counters = (m.commits, m.ro_commits, m.rw_commits, m.aborts, m.forwards,
                m.lease_requests, m.piggybacks, m.rw_certified,
                len(m.commit_times))
    extras = (
        tuple(repr(r.bit_generator.state) for r in cluster.rngs),
        repr(cluster._txid), repr(cluster._reqid),
        round(cluster.gcs._seq_busy_until, 9),
        tuple(cluster.gcs.members),
        None if cluster.planner is None
        else digest(_blob(vars(cluster.planner))),
    )
    return (tuple(reps), txns, counters, extras)


def cluster_fingerprint(cluster) -> str:
    """Behavioral state + pending events, as one dedup key."""
    return digest(cluster_state(cluster), queue_state(cluster.events))
