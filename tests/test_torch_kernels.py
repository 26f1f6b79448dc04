"""repro_torch kernel twins and dispatch points, held bitwise to repro.

Inputs are made with numpy from a seed and handed to both packages.  The
CUDA kernel itself runs only on a card: its tests are in
``test_torch_cuda.py``, which imports no JAX so that it runs on the card's
machine.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.lease_validate import lease_validate as pallas_validate
from repro.kernels.ops import validate_transactions as jax_validate
from repro_torch.kernels import ops, ref


def _validate_inputs(seed, B, R, W, n_items):
    """In-range items and -1 padding (the only items callers pass)."""
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 50, n_items).astype(np.int32)
    locks = (rng.random(n_items) < 0.05).astype(np.int32)
    items = rng.integers(-1, n_items, (B, R)).astype(np.int32)
    vers = np.where(rng.random((B, R)) < 0.8,
                    store[np.clip(items, 0, n_items - 1)],
                    rng.integers(0, 50, (B, R))).astype(np.int32)
    witems = rng.integers(-1, n_items, (B, W)).astype(np.int32)
    return store, items, vers, locks, witems


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,R,W,n_items,chunk,bt", [
    (64, 8, 4, 1024, 256, 32),
    (200, 16, 8, 5000, 512, 64),
    (7, 3, 2, 100, 64, 8),
])
def test_lease_validate_ref_matches_reference_and_pallas(B, R, W, n_items,
                                                         chunk, bt):
    store, items, vers, locks, witems = _validate_inputs(B, B, R, W, n_items)
    got = ref.lease_validate_ref(*_t(store, items, vers), _t(locks)[0] > 0,
                                 _t(witems)[0]).numpy()
    want = np.asarray(jref.lease_validate_ref(
        jnp.asarray(store), jnp.asarray(items), jnp.asarray(vers),
        jnp.asarray(locks) > 0, jnp.asarray(witems)))
    pallas = np.asarray(pallas_validate(
        jnp.asarray(store), jnp.asarray(items), jnp.asarray(vers),
        jnp.asarray(locks), jnp.asarray(witems), block_txns=bt, chunk=chunk))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.bool_ and 0 < got.sum() < B


@pytest.mark.parametrize("B,R,W,n_items", [(32, 8, 4, 512), (8, 4, 2, 64)])
def test_validate_transactions_matches_reference_dispatch(B, R, W, n_items):
    store, items, vers, locks, witems = _validate_inputs(7, B, R, W, n_items)
    got = ops.validate_transactions(*_t(store, items, vers),
                                    write_locks=_t(locks)[0],
                                    write_items=_t(witems)[0]).numpy()
    want = np.asarray(jax_validate(store, items, vers, write_locks=locks,
                                   write_items=witems, backend="jnp"))
    np.testing.assert_array_equal(got, want)
    # lock-free default: all-zero locks, one all--1 write column
    got = ops.validate_transactions(*_t(store, items, vers)).numpy()
    want = np.asarray(jax_validate(store, items, vers, backend="jnp"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_lease_settle_ref_matches_reference(seed):
    rng = np.random.default_rng(seed)
    C, B, K, proc = 16, 8, 4, 0
    qlen = rng.integers(0, 3, C).astype(np.int32)
    head_req = rng.integers(1, 6, C).astype(np.int32)
    head_proc = rng.integers(0, 3, C).astype(np.int32)
    head_active = rng.integers(0, 2, C).astype(np.int32)
    fresh = rng.random(C) < 0.4
    wait_req = rng.integers(1, 6, (B, K)).astype(np.int32)
    wait_cc = np.where(rng.random((B, K)) < 0.3, -1,
                       rng.integers(0, C, (B, K))).astype(np.int32)
    args = (head_req, head_proc, head_active, qlen, fresh, wait_req, wait_cc)
    got = ops.settle_lease_batch(*_t(*args), proc)
    want = jref.lease_settle_ref(*(jnp.asarray(a) for a in args),
                                 jnp.int32(proc))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
