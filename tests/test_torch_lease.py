"""One delivery schedule replayed through both packages' lease managers.

The reference's FGLLeaseManager (Algorithm 1) and ShardedLeaseManager and
the port's copies of both see the same seeded replicated history — rounds
of opt-deliver, frees, TO-deliver, enablement and FinishedXact, with a view
change mid-run — and must give identical freed streams, finish counts,
owner views and enablement.  ``jax_min=1`` sends every settle through the
device path (the torch ops on the CPU here).
"""
import numpy as np
import pytest

from repro.core import lease as jlease
from repro.core import lease_batched as jbatched
from repro_torch.core import lease as tlease
from repro_torch.core import lease_batched as tbatched


def _rounds(seed, n_rounds=6, per_round=12, n_classes=10, n_procs=3):
    rng = np.random.default_rng(seed)
    rounds, rid = [], 0
    for _ in range(n_rounds):
        reqs = []
        for _ in range(per_round):
            rid += 1
            ccs = rng.choice(n_classes, size=int(rng.integers(1, 4)),
                             replace=False)
            reqs.append((rid, rid % n_procs, tuple(sorted(int(c) for c in ccs))))
        rounds.append(reqs)
    return rounds


def _replay(mgrs, request_cls, rounds, purge_at):
    """Replicated replay in protocol order; returns the observable trace."""
    waiters = [[] for _ in mgrs]
    trace = {"freed": [], "finished": 0, "enabled": []}

    def deliver(frees_by_node):
        keys = [l.key() for fr in frees_by_node for l in fr]
        trace["freed"].extend(keys)
        for m in mgrs:
            m.on_ur_deliver_freed(keys)

    for rnd, raw in enumerate(rounds):
        reqs = [request_cls(req_id=r, proc=p, ccs=c) for (r, p, c) in raw]
        if purge_at == rnd:
            for m in mgrs:
                m.purge_proc(1)
            waiters[1] = []
        deliver([sum((m.on_opt_deliver(r) for r in reqs), []) for m in mgrs])
        for p, m in enumerate(mgrs):
            for r in reqs:
                lors = m.on_to_deliver(r)
                if r.proc == p and lors:
                    waiters[p].append(lors)
        fin = []
        for p, m in enumerate(mgrs):
            mask = m.enabled_mask(waiters[p])
            trace["enabled"].append(list(mask))
            done = [g for g, ok in zip(waiters[p], mask) if ok]
            waiters[p] = [g for g, ok in zip(waiters[p], mask) if not ok]
            trace["finished"] += len(done)
            fin.append(sum((m.finished_xact(g) for g in done), []))
        deliver(fin)
    trace["owners"] = [m.owner_view() for m in mgrs]
    return trace


@pytest.mark.parametrize("seed,purge_at", [(7, 3), (8, None), (9, 0)])
def test_schedule_replay_identical_across_packages(seed, purge_at):
    rounds = _rounds(seed)
    n_procs, n_classes = 3, 10
    traces = [
        _replay([jlease.FGLLeaseManager(p, n_classes)
                 for p in range(n_procs)], jlease.LeaseRequest, rounds,
                purge_at),
        _replay([jbatched.ShardedLeaseManager(p, n_classes, n_shards=2,
                                              jax_min=1)
                 for p in range(n_procs)], jlease.LeaseRequest, rounds,
                purge_at),
        _replay([tlease.FGLLeaseManager(p, n_classes)
                 for p in range(n_procs)], tlease.LeaseRequest, rounds,
                purge_at),
        _replay([tbatched.ShardedLeaseManager(p, n_classes, n_shards=2,
                                              jax_min=1, device="cpu")
                 for p in range(n_procs)], tlease.LeaseRequest, rounds,
                purge_at),
    ]
    assert traces[0]["finished"] > 0 and traces[0]["freed"]
    for t in traces[1:]:
        assert t == traces[0]


def test_settle_device_path_matches_numpy_twin():
    """The port's settle through ops (use_kernel) equals its numpy twin."""
    m = tbatched.ShardedLeaseManager(0, 16, n_shards=4, jax_min=1,
                                     device="cpu")
    groups = []
    for rid, ccs in enumerate([(1, 2), (2, 5), (7,), (1, 9, 12)], start=1):
        groups.append(m.on_to_deliver(
            tlease.LeaseRequest(req_id=rid, proc=rid % 2, ccs=ccs)))
    fresh = np.array([2, 9], np.int32)
    a = m.settle(groups, fresh, use_kernel=True)
    b = m.settle(groups, fresh, use_kernel=False)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a[3].tolist() == [True, False, True, False]
