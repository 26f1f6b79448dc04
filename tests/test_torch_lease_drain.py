"""The certification drain (``lease_validate``'s ``drain`` variant) on the CPU.

A drain flushes a store's written versions into its device table and
certifies a batch against it, locking write items whose class another
replica owns.  Its twin ``ref.lease_drain_ref`` and the port's drain route
(``stm.validate_batch(..., class_locks=...)``) are held bitwise to the
reference's composition: the table as ``repro.core.stm`` holds it, the
per-item locks of ``repro.core.cluster.Cluster._write_locks``, then
``repro.kernels.ref.lease_validate_ref``.  Inputs are seeded numpy arrays
handed to both packages.  The kernel itself runs only on a card
(``test_torch_cuda.py``, over the same ``DRAIN_GRID``).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stm as jstm
from repro.core.cluster import Cluster as JaxCluster
from repro.kernels import ref as jref
from repro_torch.core import stm as tstm
from repro_torch.kernels import lease_validate as lv
from repro_torch.kernels import ops, ref
from test_torch_cuda import (DRAIN_GRID, DRAIN_PLANS, class_outside_owners,
                             drain_inputs, drain_twin, stage_drain)
from test_torch_stm import _mutate, _txns


def _reference_locks(item_cc, owners, node):
    """Per-item locks exactly as the reference's cluster derives them."""
    lm = SimpleNamespace(owner_np=lambda: owners)
    fake = SimpleNamespace(_item_cc=item_cc,
                           replicas={node: SimpleNamespace(lm=lm)})
    return JaxCluster._write_locks(fake, node)


def _reference_drain(case):
    """ok from the reference: the flushed table as its store holds it,
    per-item locks from the class owners, ``lease_validate_ref``."""
    cls = case["classes"]
    locks = None if cls is None else _reference_locks(cls[0], cls[1],
                                                      case["node"])
    ok = jref.lease_validate_ref(
        jnp.asarray(case["versions"]), jnp.asarray(case["read_items"]),
        jnp.asarray(case["read_versions"]),
        None if locks is None else jnp.asarray(locks) > 0,
        None if locks is None else jnp.asarray(case["write_items"]))
    return np.asarray(ok)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", DRAIN_GRID + [c for c, _ in DRAIN_PLANS])
def test_lease_drain_ref_matches_reference_composition(case, seed):
    inputs = drain_inputs(seed, *case)
    ok, table = drain_twin(inputs)
    assert ok.dtype == torch.bool and ok.shape == (case[0],)
    np.testing.assert_array_equal(ok.numpy(), _reference_drain(inputs))
    np.testing.assert_array_equal(table.numpy(), inputs["versions"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lease_drain_ref_fails_closed_on_a_class_outside_the_owners(seed):
    """A write item whose class lies outside the owners counts as locked
    (the kernel's rule); every other slot is judged as the reference's
    composition judges it."""
    case = class_outside_owners(drain_inputs(seed, 16, 8, 4, 4096, 6, 32))
    item_cc, owners = case["classes"]
    ok, _ = drain_twin(case)
    bad_class = (item_cc[np.clip(case["write_items"], 0, None)] < 0) | (
        item_cc[np.clip(case["write_items"], 0, None)] >= owners.size)
    outside = ((case["write_items"] >= 0) & bad_class).any(axis=1)
    assert outside.any() and not ok.numpy()[outside].any()
    inside = dict(case, classes=(np.clip(item_cc, 0, owners.size - 1),
                                 owners))
    keep = ~outside
    np.testing.assert_array_equal(ok.numpy()[keep],
                                  _reference_drain(inside)[keep])


def test_cluster_refuses_a_class_map_outside_n_classes():
    """The cluster checks its item -> class map once, when it builds the
    device table, so no drain sees a class the owners do not cover."""
    import repro_torch.core as T

    cfg = T.SimConfig(n_items=64, n_classes=4, device="cpu")
    wl = T.BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items)
    ccmap = SimpleNamespace(of_item=lambda i: 4 if i == 63 else i % 4)
    with pytest.raises(ValueError, match="outside"):
        T.make_cluster("LILAC-TM-ST", wl, cfg, ccmap=ccmap)


def test_drain_grid_covers_its_edges():
    """Repeated dirty items, reads of items dirtied in the same drain (at
    the new and the old version), item n_items - 1, an empty batch, no
    class map, and both verdicts."""
    small = drain_inputs(0, *DRAIN_GRID[2])
    assert np.unique(small["dirty_idx"]).size < small["dirty_idx"].size
    main = drain_inputs(0, *DRAIN_GRID[0])
    read = main["read_items"]
    dirtied = np.isin(read, main["dirty_idx"]) & (read >= 0)
    fresh = main["versions"][np.clip(read, 0, None)]
    old = main["table"][np.clip(read, 0, None)]
    assert (dirtied & (main["read_versions"] == fresh)).any()
    assert (dirtied & (main["read_versions"] == old)
            & (fresh != old)).any()
    assert read[0, 0] == DRAIN_GRID[0][3] - 1
    assert DRAIN_GRID[4][0] == 0 and DRAIN_GRID[5][4] == 0
    ok = _reference_drain(main)
    assert 0 < ok.sum() < ok.size


@pytest.mark.parametrize("case", DRAIN_GRID)
def test_certify_drain_on_cpu_runs_the_twin_in_the_staging_area(case):
    """``ops.certify_drain`` on a CPU table: the verdicts land in the
    staging area and the table is flushed, as ``lease_drain_ref`` does."""
    inputs = drain_inputs(3, *case)
    staging = lv.DrainStaging("cpu")
    v = stage_drain(staging, inputs)
    table = torch.from_numpy(inputs["table"].copy())
    cls = inputs["classes"]
    got = ops.certify_drain(
        table, staging, None if cls is None else torch.from_numpy(cls[0]))
    assert got is v.ok
    want, want_table = drain_twin(inputs)
    np.testing.assert_array_equal(got, want.numpy())
    assert torch.equal(table, want_table)


def _stores(seed, n=500):
    """A reference store and a port store after the same mutations; the
    port's device table still lacks the last ones (pending writes)."""
    a = jstm.VersionedStore(n)
    b = tstm.VersionedStore(n, device="cpu")
    for s in (a, b):
        _mutate(s, np.random.default_rng(seed), grow=False)
    b.device_versions()
    for s in (a, b):
        _mutate(s, np.random.default_rng(seed + 100), steps=6, grow=False)
    return a, b


def _seen_txns(a, b, seed, n):
    """The same transactions in both packages, most reads at the current
    versions so that some pass."""
    rng = np.random.default_rng(seed)
    txns_a, txns_b = _txns(jstm, seed, n_items=n), _txns(tstm, seed,
                                                         n_items=n)
    for ta, tb in zip(txns_a, txns_b):
        for k in range(0, len(ta.read_log), 2):
            if rng.random() < 0.9:
                for t, s in ((ta, a), (tb, b)):
                    t.read_log[k + 1] = int(s.versions[t.read_log[k]])
    return txns_a, txns_b


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("with_classes", [False, True])
def test_validate_batch_class_locks_matches_reference(seed, with_classes):
    n = 500
    a, b = _stores(seed, n)
    assert len(b._dirty) > 0
    txns_a, txns_b = _seen_txns(a, b, 9 + seed, n)
    rng = np.random.default_rng(20 + seed)
    node = 2
    class_locks, locks = None, None
    if with_classes:
        item_cc = rng.integers(0, 12, n).astype(np.int32)
        owners = rng.choice(np.array([-1, node, 0], np.int32), 12,
                            p=[0.5, 0.4, 0.1])
        locks = _reference_locks(item_cc, owners, node)
        class_locks = tstm.ClassLocks(torch.from_numpy(item_cc), owners, node)
    want = jstm.validate_batch(a, txns_a, locks=locks, backend="jnp")
    got = tstm.validate_batch(b, txns_b, class_locks=class_locks)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    # the drain flushed every pending write, as device_versions would
    assert len(b._dirty) == 0
    np.testing.assert_array_equal(b.versions_dev.numpy(),
                                  a.versions.astype(np.int32))
    # and the per-item (gather) route gives the same verdicts
    gather = tstm.validate_batch(
        b, txns_b, locks=None if locks is None else torch.from_numpy(locks))
    np.testing.assert_array_equal(gather, want)


def test_validate_batch_refuses_both_lock_forms():
    s = tstm.VersionedStore(16, device="cpu")
    t = tstm.Transaction(txid=1, origin=0)
    t.log_read(3, 0)
    with pytest.raises(ValueError, match="not both"):
        tstm.validate_batch(s, [t], torch.zeros(16, dtype=torch.int32),
                            class_locks=tstm.ClassLocks(
                                torch.zeros(16, dtype=torch.int32),
                                np.zeros(1, np.int32), 0))


@pytest.mark.parametrize("seed,n_txns", [(0, 1), (1, 5), (2, 8), (0, 11),
                                          (1, 25)])
@pytest.mark.parametrize("with_classes", [False, True])
def test_pack_drain_matches_pack_read_and_write_sets(seed, n_txns,
                                                     with_classes):
    """The staging area holds the rows ``pack_read_sets`` /
    ``pack_write_sets`` give (row count bucketed, padded rows -1), the
    pending writes at their current versions, the owners and the header;
    batches of up to 8 rows are packed row by row, larger ones by one
    scatter."""
    _, b = _stores(seed)
    txns = _txns(tstm, seed, n_txns=n_txns, n_items=b.n_items)
    owners = np.array([-1, 1, 0, 3], np.int32)
    class_locks = tstm.ClassLocks(torch.zeros(b.n_items, dtype=torch.int32),
                                  owners, 1) if with_classes else None
    v = tstm.pack_drain(b, txns, class_locks)
    bp = tstm._pad_bucket(len(txns))
    items, vers = tstm.pack_read_sets(txns)
    pad = ((0, bp - len(txns)), (0, 0))
    np.testing.assert_array_equal(
        v.read_items, np.pad(items, pad, constant_values=-1))
    np.testing.assert_array_equal(v.read_versions, np.pad(vers, pad))
    dirty = np.frombuffer(b._dirty, np.int32)
    np.testing.assert_array_equal(v.dirty_idx, dirty)
    np.testing.assert_array_equal(v.dirty_ver, b.versions[dirty])
    w = 0
    if with_classes:
        witems = tstm.pack_write_sets(txns)
        w = witems.shape[1]
        np.testing.assert_array_equal(
            v.write_items, np.pad(witems, pad, constant_values=-1))
        np.testing.assert_array_equal(v.owners, owners)
    assert v.write_items.shape == (bp, w)
    header = (dirty.size, bp, items.shape[1], w, 1 if with_classes else 0,
              owners.size if with_classes else 0)
    assert tuple(b.staging.words[:6]) == header


@pytest.mark.parametrize("b,n_dirty,per_item,want", [
    (16, 256, True, ("gather", 2, 1)),      # per-item locks: 8 txns a block
    (1024, 0, True, ("gather", 128, 1)),
    (8, 128, False, ("drain", 1, 1)),       # TPC-C's main drains
    (16, 256, False, ("drain", 1, 1)),
    (0, 0, False, ("drain", 1, 1)),
    (32, 8192, False, ("drain", 1, 1)),     # one CTA's limits
    (33, 0, False, ("drain", 2, 1)),        # a cluster, by transactions
    (8, 8193, False, ("drain", 2, 1)),      # a cluster, by dirty pairs
    (256, 65536, False, ("drain", 8, 1)),   # the largest cluster
    (257, 0, False, ("drain", 9, 2)),       # two launches
    (8, 65537, False, ("drain", 9, 2)),
])
def test_variant_routes_by_lock_form_and_size(b, n_dirty, per_item, want):
    assert lv.variant(b, n_dirty, per_item_locks=per_item) == want


@pytest.mark.parametrize("shape", [(0, 0, 1, 0, 0), (3, 7, 5, 3, 33),
                                   (256, 16, 32, 16, 33)])
def test_drain_layout_is_aligned_and_fits(shape):
    n_dirty, b, r, w, n_classes = shape
    offsets, nbytes = lv.drain_layout(*shape)
    sizes = (n_dirty, n_dirty, n_classes, 2 * b * r, b * w)
    assert offsets[0] == lv.HEADER_WORDS
    assert all(o % 4 == 0 for o in offsets)
    for o, n, nxt in zip(offsets, sizes, offsets[1:]):
        assert o + n <= nxt
    assert 4 * offsets[-1] + b <= nbytes and nbytes % 16 == 0
    v = lv.DrainStaging("cpu").begin(n_dirty, b, r, w, n_classes, 0)
    assert v.reads.shape == (b, r, 2) and v.reads.flags.c_contiguous
    assert v.read_items.shape == (b, r) and v.write_items.shape == (b, w)
    assert v.ok.shape == (b,) and v.ok.dtype == np.bool_


def test_staging_area_grows_and_keeps_no_stale_views():
    staging = lv.DrainStaging("cpu")
    small = staging.begin(4, 8, 8, 2, 3, 0)
    assert staging.nbytes == 4096
    big = staging.begin(1000, 64, 32, 16, 33, 1)
    assert staging.nbytes >= lv.drain_layout(1000, 64, 32, 16, 33)[1]
    assert staging.views is big and small.read_items.base is not \
        big.read_items.base


def test_cluster_drains_hand_over_the_class_view(monkeypatch):
    """Every batched drain passes the class-owner view (no per-item lock
    tensor), and the per-item locks it replaces still equal the
    reference's rule."""
    import repro_torch.core as T
    import repro_torch.core.cluster as cluster_mod

    seen = []
    plain = cluster_mod.validate_batch

    def spy(store, txns, locks=None, **kw):
        seen.append((locks, kw.get("class_locks")))
        return plain(store, txns, locks, **kw)

    monkeypatch.setattr(cluster_mod, "validate_batch", spy)
    cfg = T.SimConfig(duration_ms=60.0, warmup_ms=10.0, seed=2,
                      certify_jax_min=1, device="cpu")
    c = T.make_cluster("LILAC-TM-ST", T.BankWorkload(
        n_nodes=cfg.n_nodes, n_items=cfg.n_items), cfg)
    c.run()
    assert seen and all(locks is None and cl is not None
                        for locks, cl in seen)
    assert seen[0][1].item_cc.dtype == torch.int32
    for node in range(cfg.n_nodes):
        owners = c.replicas[node].lm.owner_np()
        want = _reference_locks(c._item_cc, owners, node)
        np.testing.assert_array_equal(c._write_locks(node).numpy(), want)
