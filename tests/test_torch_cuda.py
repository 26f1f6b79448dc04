"""The lease_validate CUDA kernel against its plain twin, on the card.

Marked ``cuda``: skips on a host without a card.  This file imports no JAX
(the card's machine has none); run it there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import lease_validate as lv
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
    return [torch.from_numpy(a)
            for a in (store, items, vers, locks, witems)]


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel launches on CUDA tensors only; a CPU caller goes through
    ops, which takes the twin."""
    with pytest.raises(ValueError, match="CUDA"):
        lv.lease_validate(*_validate_inputs(1, 8, 4, 2, 64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lease_validate kernel has no "
                    "CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,W,n_items", [
    (16, 32, 16, 1_140_088), (8, 32, 1, 1_140_088),
    (1024, 256, 64, 1 << 20), (7, 3, 2, 100), (0, 8, 8, 64),
])
def test_cuda_kernel_matches_twin(cuda_device, B, R, W, n_items):
    store, items, vers, locks, witems = (
        t.to(cuda_device) for t in _validate_inputs(3, B, R, W, n_items))
    before = lv.launches
    got = ops.validate_transactions(store, items, vers, write_locks=locks,
                                    write_items=witems)
    torch.cuda.synchronize()
    assert lv.launches == before + (1 if B else 0)
    want = ref.lease_validate_ref(store, items, vers, locks > 0, witems)
    assert got.shape == (B,) and torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    store, items, vers, locks, witems = (
        t.to(cuda_device) for t in _validate_inputs(4, 8, 4, 2, 64))
    with pytest.raises(TypeError, match="int32"):
        lv.lease_validate(store.long(), items, vers, locks, witems)
    with pytest.raises(ValueError, match="contiguous"):
        lv.lease_validate(store, items.t().contiguous().t(), vers, locks,
                          witems)
    with pytest.raises(ValueError, match="rows"):
        lv.lease_validate(store, items, vers, locks, witems[:4])


@pytest.mark.cuda
def test_cuda_cluster_run_matches_cpu(cuda_device):
    """A short forced Bank run on the card equals the same run on the CPU."""
    import dataclasses

    import repro_torch.core as T

    out = []
    for device in ("cuda", "cpu"):
        cfg = T.SimConfig(duration_ms=150.0, warmup_ms=30.0, seed=1,
                          certify_jax_min=1, lease_jax_min=1,
                          cert_slot_mode="per_txn", device=device)
        c = T.make_cluster("LILAC-TM-ST", T.BankWorkload(
            n_nodes=cfg.n_nodes, n_items=cfg.n_items, locality=0.6), cfg)
        c.events.schedule(120.0, lambda: c.gcs.fail(3))
        m = c.run()
        out.append((dataclasses.asdict(m),
                    [(r.store.values.tobytes(), r.store.versions.tobytes())
                     for r in c.replicas]))
    assert out[0] == out[1]
    assert out[0][0]["cert_batches"] > 0
