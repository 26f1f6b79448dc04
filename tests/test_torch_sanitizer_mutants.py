"""Mutation-kill harness on the port: every injected protocol bug is
flagged, on the CPU, with the invariant the reference names.

The reference's ``tests/test_sanitizer_mutants.py`` case for case against
``repro_torch`` (``device="cpu"``), each also run through ``repro`` to pin
the same invariant; then the drain's own forms of a write-lock violation:
a ``validate_batch(class_locks=)`` drain (the drain kernel's twin here)
fed stale owners, and one whose verdict passes a write to a class leased
elsewhere.
"""
import numpy as np
import pytest
import torch

import repro.analysis.sanitizer as JS
import repro.core.lease as JL
import repro.core.lease_batched as JB
import repro.serve.certifier as JC
from repro_torch.analysis.sanitizer import (LeaseSanitizer, SanitizerError,
                                            check_write_locks)
from repro_torch.core.lease import FGLLeaseManager, LeaseRequest
from repro_torch.core.lease_batched import ShardedLeaseManager
from repro_torch.core.stm import (ClassLocks, Transaction, VersionedStore,
                                  validate_batch)
from repro_torch.serve.certifier import StepCertifier

PORT = dict(San=LeaseSanitizer, Err=SanitizerError, FGL=FGLLeaseManager,
            Sharded=lambda *a, **k: ShardedLeaseManager(*a, device="cpu",
                                                        **k),
            Req=LeaseRequest, Cert=lambda *a, **k: StepCertifier(
                *a, device="cpu", **k), cwl=check_write_locks)
REF = dict(San=JS.LeaseSanitizer, Err=JS.SanitizerError,
           FGL=JL.FGLLeaseManager, Sharded=JB.ShardedLeaseManager,
           Req=JL.LeaseRequest, Cert=JC.StepCertifier,
           cwl=JS.check_write_locks)
PKGS = pytest.mark.parametrize("P", [PORT, REF], ids=["port", "reference"])


def _req(P, req_id, proc, ccs):
    return P["Req"](req_id=req_id, proc=proc, ccs=tuple(sorted(ccs)))


def _mgr(P, kind, proc, n_classes=8):
    if kind == "oracle":
        return P["San"](P["FGL"](proc, n_classes))
    return P["San"](P["Sharded"](proc, n_classes, n_shards=2, jax_min=1))


# -- mutant 1: ownership re-place skips its epoch bump -----------------------

@PKGS
@pytest.mark.parametrize("jax_min", [8, 1])
def test_mutant_skipped_epoch_bump_on_replace(P, jax_min):
    owner = {4: 0}
    c = P["Cert"](2, sanitize=True, owner_of=lambda s: owner.get(s, -1),
                  jax_min=jax_min)

    class R:
        sid = 4

    c.bump(4, 1)
    c.enqueue(0, R(), 1)
    owner[4] = 1          # the bug: apply_move updates the router only —
    #                       no certifier.bump, so the stale forward passes
    with pytest.raises(P["Err"]) as e:
        c.drain(0)
    assert e.value.invariant == "owner-at-drain"


# -- mutant 2: prefetch LOR freed/drained while non-head ---------------------

@PKGS
@pytest.mark.parametrize("kind", ["oracle", "sharded"])
def test_mutant_drain_prefetch_lor_while_non_head(P, kind):
    lm = _mgr(P, kind, proc=1)
    lm.on_to_deliver(_req(P, 1, 0, (5,)))       # remote head owns cc=5
    lors = lm.on_to_deliver(_req(P, 2, 1, (5,)))  # own prefetch behind it
    lm.mark_prefetch(lors)
    with pytest.raises(P["Err"]) as e:
        # the bug: draining a prefetch without waiting for is_enabled
        lm.finished_xact(lors)
    assert e.value.invariant == "prefetch-head"


# -- mutant 3: view change drops a surviving member's queued LOR -------------

@PKGS
def test_mutant_view_change_drops_survivor_lor(P):
    class OverPurging(P["FGL"]):
        def purge_proc(self, proc):
            super().purge_proc(proc)
            super().purge_proc(2)   # the bug: an innocent member's LORs go too

    lm = P["San"](OverPurging(0, 8))
    lm.on_to_deliver(_req(P, 1, 1, (3,)))
    lm.on_to_deliver(_req(P, 2, 2, (4,)))
    with pytest.raises(P["Err"]) as e:
        lm.purge_proc(1)
    assert e.value.invariant == "conservation"
    assert "surviving" in e.value.detail


# -- mutant 4: the same request granted twice --------------------------------

@PKGS
@pytest.mark.parametrize("kind", ["oracle", "sharded"])
def test_mutant_double_grant(P, kind):
    lm = _mgr(P, kind, proc=0)
    req = _req(P, 1, 0, (2,))
    lm.on_to_deliver(req)
    with pytest.raises(P["Err"]) as e:
        lm.on_to_deliver(req)   # the bug: duplicate TO delivery not deduped
    assert e.value.invariant == "single-owner"


# -- mutant 5: stale write-lock input to validate_batch ----------------------

class _T:
    def __init__(self, txid, writes):
        self.txid = txid
        self.write_set = {w: 1.0 for w in writes}


@PKGS
def test_mutant_stale_write_locks_input(P):
    owners = np.array([0, 1], np.int32)         # cc=1 leased to proc 1
    item_cc = np.array([0, 1, 1], np.int32)
    stale = np.zeros(3, np.int32)               # the bug: locks not refreshed
    with pytest.raises(P["Err"]) as e:
        P["cwl"](0, owners, item_cc, stale, [], [])
    assert e.value.invariant == "write-locks"
    assert "stale" in e.value.detail


@PKGS
def test_mutant_certified_write_to_leased_away_item(P):
    owners = np.array([0, 1], np.int32)
    item_cc = np.array([0, 1, 1], np.int32)
    with pytest.raises(P["Err"]) as e:
        # the bug: verdict True for a txn writing item 2 (leased to proc 1)
        P["cwl"](0, owners, item_cc, None, [_T(7, [2])], [True])
    assert e.value.invariant == "write-locks"
    assert "txn 7" in e.value.detail


# -- mutant 6: recycled sid resurrects an old epoch --------------------------

@PKGS
def test_mutant_recycled_sid_resurrection(P):
    c = P["Cert"](2, sanitize=True)
    c.bump(5, 7)
    with pytest.raises(P["Err"]) as e:
        c.bump(5, 3)   # the bug: a recycled sid restarts below its tombstone
    assert e.value.invariant == "epoch-monotonicity"


# -- mutant 7: UR-free of a live (unblocked, active) lease -------------------

@PKGS
@pytest.mark.parametrize("kind", ["oracle", "sharded"])
def test_mutant_free_active_lease(P, kind):
    lm = _mgr(P, kind, proc=0)
    lors = lm.on_to_deliver(_req(P, 1, 0, (2, 3)))
    with pytest.raises(P["Err"]) as e:
        lm.on_ur_deliver_freed([lors[0].key()])   # never blocked nor drained
    assert e.value.invariant == "blocked-and-drained"


# -- mutant 8: forged free for a never-granted LOR ---------------------------

@PKGS
def test_mutant_forged_free(P):
    lm = _mgr(P, "oracle", proc=0)
    lm.on_to_deliver(_req(P, 1, 0, (2,)))
    with pytest.raises(P["Err"]) as e:
        lm.on_ur_deliver_freed([(99, 1, (5,))])
    assert e.value.invariant == "conservation"


# -- mutant 9: vectorized enablement diverges from the oracle ----------------

@PKGS
def test_mutant_enabled_mask_divergence(P):
    lm = _mgr(P, "sharded", proc=0)
    g1 = lm.on_to_deliver(_req(P, 1, 0, (1,)))
    lm.on_to_deliver(_req(P, 2, 1, (2,)))
    g2 = lm.on_to_deliver(_req(P, 3, 0, (2,)))  # queued behind proc 1
    inner = lm.inner
    orig = inner.enabled_mask
    # the bug: a settle-kernel defect flips the packed verdicts
    inner.enabled_mask = lambda groups: [not v for v in orig(groups)]
    with pytest.raises(P["Err"]) as e:
        lm.enabled_mask([g1, g2])
    assert e.value.invariant == "enabled-divergence"


# -- the drain's forms: a ClassLocks drain on the store's device -------------

def _drain_case():
    """A 3-item store on the CPU (items 1, 2 in class 1, leased to proc 1
    by the lease layer's view) and a transaction writing item 2."""
    store = VersionedStore(3, device="cpu")
    item_cc = np.array([0, 1, 1], np.int32)
    owners = np.array([0, 1], np.int32)
    t = Transaction(txid=7, origin=0)
    t.log_read(0, 0)
    t.write_set[2] = 1.0
    return store, item_cc, owners, t


def test_drain_with_stale_class_owners_is_flagged():
    """The bug: the drain is handed owners that predate the lease move;
    its verdict passes the write, and the sanitizer names the stale view."""
    store, item_cc, owners, t = _drain_case()
    stale = ClassLocks(torch.from_numpy(item_cc), np.zeros(2, np.int32), 0)
    ok = validate_batch(store, [t], class_locks=stale)
    assert ok.tolist() == [True]
    with pytest.raises(SanitizerError) as e:
        check_write_locks(0, owners, item_cc, stale, [t], ok)
    assert e.value.invariant == "write-locks"
    assert "stale" in e.value.detail and "class 1" in e.value.detail


def test_drain_verdict_passing_a_leased_away_write_is_flagged():
    """The drain decides with an owners view that disagrees with the lease
    layer's; the host recompute of the pass side catches the verdict."""
    store, item_cc, owners, t = _drain_case()
    forged = ClassLocks(torch.from_numpy(item_cc), np.zeros(2, np.int32), 0)
    ok = validate_batch(store, [t], class_locks=forged)
    with pytest.raises(SanitizerError) as e:
        check_write_locks(0, owners, item_cc, None, [t], ok)
    assert e.value.invariant == "write-locks" and "txn 7" in e.value.detail
    # with the live view the drain itself refuses the write: nothing to flag
    live = forged._replace(owners=owners)
    ok = validate_batch(store, [t], class_locks=live)
    assert ok.tolist() == [False]
    assert check_write_locks(0, owners, item_cc, live, [t], ok) == 0
