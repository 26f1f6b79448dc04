"""repro_torch.core.stm against repro.core.stm, and its device version table.

Both packages get the same seeded numpy inputs; the port runs on the CPU.
"""
import numpy as np
import pytest
import torch

from repro.core import stm as jstm
from repro_torch.core import stm as tstm


def _txns(mod, seed, n_txns=40, n_items=500, max_reads=6, max_writes=4):
    """The same seeded read/write logs built in either package."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_txns):
        t = mod.Transaction(txid=i + 1, origin=i % 4)
        for item in rng.integers(0, n_items, rng.integers(0, max_reads)):
            t.log_read(int(item), int(rng.integers(0, 30)))
        for item in rng.integers(0, n_items, rng.integers(0, max_writes)):
            t.write_set[int(item)] = float(rng.standard_normal())
        out.append(t)
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pad_to", [None, 16])
def test_pack_matches_reference(seed, pad_to):
    a, b = _txns(jstm, seed), _txns(tstm, seed)
    for x, y in zip(jstm.pack_read_sets(a, pad_to=pad_to),
                    tstm.pack_read_sets(b, pad_to=pad_to)):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    x = jstm.pack_write_sets(a, pad_to=pad_to)
    y = tstm.pack_write_sets(b, pad_to=pad_to)
    assert x.dtype == y.dtype == np.int32
    np.testing.assert_array_equal(x, y)


def _mutate(store, rng, steps=30, grow=True):
    """A random apply / apply_versioned / apply_batch / grow_to sequence."""
    for step in range(steps):
        n = store.n_items
        kind = rng.integers(0, 4 if grow else 3)
        ws = lambda: {int(i): float(rng.standard_normal())
                      for i in rng.integers(0, n, rng.integers(0, 6))}
        if kind == 0:
            store.apply(ws())
        elif kind == 1:
            store.apply_versioned(ws(), int(rng.integers(1, 1 << 20)))
        elif kind == 2:
            sets = [ws() for _ in range(int(rng.integers(1, 5)))]
            store.apply_batch(sets, [int(v) for v in
                                     rng.integers(1, 1 << 20, len(sets))])
        else:
            store.grow_to(n + int(rng.integers(0, n)))


@pytest.mark.parametrize("seed", range(4))
def test_mutations_byte_identical_and_device_table_in_sync(seed):
    a = jstm.VersionedStore(300, 5.0)
    b = tstm.VersionedStore(300, 5.0, device="cpu")
    _mutate(a, np.random.default_rng(seed))
    _mutate(b, np.random.default_rng(seed))
    assert a.n_items == b.n_items and a.clock == b.clock
    assert a.values.tobytes() == b.values.tobytes()
    assert a.versions.tobytes() == b.versions.tobytes()
    np.testing.assert_array_equal(b.device_versions().numpy(),
                                  b.versions.astype(np.int32))
    assert b.versions_dev.dtype == torch.int32


def test_device_table_flushes_only_written_items():
    s = tstm.VersionedStore(64, device="cpu")
    s.apply_versioned({3: 1.0, 9: 2.0}, 7)
    assert s.versions_dev[3] == 0          # not flushed before a drain
    s.device_versions()
    assert s.versions_dev[3] == 7 and s.versions_dev[9] == 7
    s.versions_dev[20] = 99                # a write the store never made
    s.apply({4: 1.0})
    s.device_versions()
    assert s.versions_dev[20] == 99        # untouched items are not re-sent
    assert s.versions_dev[4] == s.clock == 8


def test_from_numpy_and_set_versions():
    rng = np.random.default_rng(2)
    values = rng.standard_normal(50)
    versions = rng.integers(0, 1000, 50)
    s = tstm.VersionedStore.from_numpy(values, versions, device="cpu")
    assert s.values.tobytes() == values.tobytes()
    assert s.clock == versions.max()
    np.testing.assert_array_equal(s.device_versions().numpy(), versions)
    with pytest.raises(ValueError, match="shape"):
        s.set_versions(versions[:10])


@pytest.mark.parametrize("with_locks", [False, True])
def test_validate_batch_matches_reference(with_locks):
    rng = np.random.default_rng(11)
    n = 500
    a = jstm.VersionedStore(n)
    b = tstm.VersionedStore(n, device="cpu")
    for s in (a, b):
        _mutate(s, np.random.default_rng(5), grow=False)
    txns_a, txns_b = _txns(jstm, 9, n_items=n), _txns(tstm, 9, n_items=n)
    # reads that saw the current versions, so some transactions pass
    for ta, tb in zip(txns_a, txns_b):
        for k in range(0, len(ta.read_log), 2):
            if rng.random() < 0.9:
                for t, s in ((ta, a), (tb, b)):
                    t.read_log[k + 1] = int(s.versions[t.read_log[k]])
    locks = (rng.random(n) < 0.05).astype(np.int32) if with_locks else None
    want = jstm.validate_batch(a, txns_a, locks=locks, backend="jnp")
    got = tstm.validate_batch(
        b, txns_b, locks=None if locks is None else torch.from_numpy(locks))
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    if not with_locks:
        np.testing.assert_array_equal(got, [b.validate(t) for t in txns_b])
