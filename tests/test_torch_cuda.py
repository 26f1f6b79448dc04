"""The port's CUDA kernels against their plain versions, on the card.

``lease_validate`` bitwise (``gather`` against ``ref.lease_validate_ref``,
``drain`` against ``ref.lease_drain_ref`` on ``ok`` and on the flushed
table, over ``DRAIN_GRID``, which ``test_torch_lease_drain.py`` also holds
to the reference on the CPU); ``flash_attention`` and ``ssd_scan`` at the
reference's tolerances over its test grids, plus the model path's shapes;
and the runtime analysis on the card (a sanitized cluster run, the drain
kernel's write-lock mutants, the explorer's kernel cell), each equal to
the CPU.  Marked ``cuda``: skips on a host without a card.  This file
imports no JAX (the card's machine has none); run it there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lease_validate as lv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss


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
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no "
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


# (B, R, W, n_items, n_classes, n_dirty): TPC-C's main shapes (1,140,088
# items, 33 classes, ~B x W dirty items), small cases whose dirty items
# repeat, no dirty item, an empty batch, and no class map (n_classes 0: no
# write rows).  Every case reads items dirtied in the same drain (some at
# their old version) and item n_items - 1.
DRAIN_GRID = [
    (16, 32, 16, 1_140_088, 33, 256),
    (8, 32, 16, 1_140_088, 33, 128),
    (7, 3, 2, 100, 5, 40),
    (8, 8, 4, 64, 4, 0),
    (0, 8, 4, 64, 4, 16),
    (16, 32, 0, 4096, 0, 64),
]
# the drain's other plans, on the card only: clusters of 2, 8 and 3 CTAs
# (by transactions and by dirty pairs), two launches (by both), and rows
# wider than a warp (each lane past its first read pair and write item)
DRAIN_PLANS = [
    ((64, 32, 16, 1 << 20, 33, 512), (2, 1)),
    ((256, 16, 8, 1 << 16, 64, 1024), (8, 1)),
    ((8, 8, 4, 1 << 16, 8, 20000), (3, 1)),
    ((512, 8, 4, 4096, 16, 100), (16, 2)),
    ((8, 8, 4, 1 << 18, 8, 80000), (10, 2)),
    ((32, 1024, 64, 1 << 16, 8, 64), (1, 1)),
]


def _ragged(rng, b, width, n_items):
    """[b, width] items in range, each row -1 padded after a random
    length."""
    items = rng.integers(0, n_items, (b, width)).astype(np.int32)
    lens = rng.integers(0, width + 1, b)
    items[np.arange(width)[None, :] >= lens[:, None]] = -1
    return items


def drain_inputs(seed, b, r, w, n_items, n_classes, n_dirty, node=1):
    """One drain's numpy inputs: ``table`` (the device table before the
    flush), ``versions`` (the host versions: the table with the dirty
    items rewritten), the dirty pairs (repeats keep one version), the
    class view (None without classes), and the rows."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 50, n_items).astype(np.int32)
    dirty = rng.integers(0, n_items, n_dirty).astype(np.int32)
    if n_dirty:
        dirty[0] = n_items - 1
    versions = table.copy()
    versions[dirty] = rng.integers(50, 100, n_dirty).astype(np.int32)
    items = _ragged(rng, b, r, n_items)
    if n_dirty and b:
        hit = (items >= 0) & (rng.random((b, r)) < 0.3)
        items[hit] = dirty[rng.integers(0, n_dirty, int(hit.sum()))]
    if b and r:
        items[0, 0] = n_items - 1
    # half the rows read what the host holds now; the others also hold
    # some versions from before the flush and some that never existed
    slot = np.clip(items, 0, n_items - 1)
    vers = versions[slot]
    u = rng.random((b, r))
    stale = (rng.random(b) < 0.5)[:, None]
    vers = np.where(stale & (u < 0.1), table[slot], vers)
    vers = np.where(stale & (u > 0.97), rng.integers(0, 100, (b, r)),
                    vers).astype(np.int32)
    classes = None
    if n_classes:
        owners = rng.choice(np.array([-1, node, node + 1], np.int32),
                            n_classes, p=[0.45, 0.45, 0.1])
        classes = (rng.integers(0, n_classes, n_items).astype(np.int32),
                   owners)
    witems = _ragged(rng, b, w, n_items)
    return dict(table=table, versions=versions, dirty_idx=dirty,
                dirty_ver=versions[dirty], classes=classes, node=node,
                read_items=items, read_versions=vers, write_items=witems)


def stage_drain(staging, case):
    """Pack ``case`` into ``staging`` as ``stm.pack_drain`` lays it out."""
    b, r = case["read_items"].shape
    owners = None if case["classes"] is None else case["classes"][1]
    w = 0 if owners is None else case["write_items"].shape[1]
    v = staging.begin(case["dirty_idx"].shape[0], b, r, w,
                      0 if owners is None else owners.shape[0], case["node"])
    v.dirty_idx[:] = case["dirty_idx"]
    v.dirty_ver[:] = case["dirty_ver"]
    v.read_items[:] = case["read_items"]
    v.read_versions[:] = case["read_versions"]
    if owners is not None:
        v.owners[:] = owners
        v.write_items[:] = case["write_items"]
    return v


def drain_twin(case, device="cpu"):
    """``ref.lease_drain_ref`` on ``case``: (ok, flushed table)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    table = t(case["table"])
    cls = case["classes"]
    ok = ref.lease_drain_ref(
        table, t(case["dirty_idx"]), t(case["dirty_ver"]),
        None if cls is None else t(cls[0]), None if cls is None else t(cls[1]),
        case["node"], t(case["read_items"]), t(case["read_versions"]),
        None if cls is None else t(case["write_items"]))
    return ok, table


def _drain_on_card(case, device, **kw):
    staging = lv.DrainStaging(device)
    stage_drain(staging, case)
    table = torch.from_numpy(case["table"]).to(device)
    cls = case["classes"]
    item_cc = None if cls is None else torch.from_numpy(cls[0]).to(device)
    ok = lv.lease_drain(table, staging, item_cc, **kw).copy()
    return ok, table


@pytest.mark.cuda
@pytest.mark.parametrize("case", DRAIN_GRID + [c for c, _ in DRAIN_PLANS])
def test_cuda_drain_matches_twin(cuda_device, case):
    inputs = drain_inputs(5, *case)
    before = dict(lv.variant_launches)
    got, table = _drain_on_card(inputs, cuda_device)
    want, want_table = drain_twin(inputs)
    assert got.dtype == np.bool_ and got.shape == (case[0],)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(table.cpu().numpy(), want_table.numpy())
    launched = 1 if case[0] or case[5] else 0
    assert lv.variant_launches["drain"] == before["drain"] + launched
    assert lv.variant_launches["gather"] == before["gather"]


@pytest.mark.cuda
@pytest.mark.parametrize("case,plan", DRAIN_PLANS)
def test_cuda_drain_plans_match_variant(cuda_device, case, plan):
    """The plans the card cases cover are the ones variant() names (the
    wrapper raises if the launcher took another)."""
    b, n_dirty = case[0], case[5]
    assert lv.variant(b, n_dirty, per_item_locks=False) == ("drain", *plan)
    _drain_on_card(drain_inputs(6, *case), cuda_device)


def class_outside_owners(case):
    """``case`` with the first write item of every even row sent to a
    class past the owners and that of every row divisible by 3 to -1."""
    item_cc, owners = case["classes"]
    item_cc = item_cc.copy()
    firsts = case["write_items"][:, 0]
    for row, item in enumerate(firsts):
        if item >= 0 and row % 2 == 0:
            item_cc[item] = owners.size + row
        if item >= 0 and row % 3 == 0:
            item_cc[item] = -1
    return dict(case, classes=(item_cc, owners))


@pytest.mark.cuda
def test_cuda_drain_fails_closed_on_a_class_outside_the_owners(cuda_device):
    """A write item whose class lies outside the owners is locked, on the
    card as in the twin (never silently unowned)."""
    case = class_outside_owners(drain_inputs(9, 16, 8, 4, 4096, 6, 32))
    got, table = _drain_on_card(case, cuda_device)
    want, want_table = drain_twin(case)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(table.cpu().numpy(), want_table.numpy())
    rows = np.arange(got.size)
    sent = (case["write_items"][:, 0] >= 0) & ((rows % 2 == 0)
                                                 | (rows % 3 == 0))
    assert sent.any() and not got[sent].any()


@pytest.mark.cuda
def test_cuda_drain_refuses_bad_inputs(cuda_device):
    case = drain_inputs(7, 8, 8, 4, 64, 4, 16)
    staging = lv.DrainStaging(cuda_device)
    stage_drain(staging, case)
    table = torch.from_numpy(case["table"]).to(cuda_device)
    item_cc = torch.from_numpy(case["classes"][0]).to(cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        lv.lease_drain(table.cpu(), staging, item_cc.cpu())
    with pytest.raises(TypeError, match="int32"):
        lv.lease_drain(table.long(), staging, item_cc)
    with pytest.raises(ValueError, match="items"):
        lv.lease_drain(table, staging, item_cc[:32])
    with pytest.raises(ValueError, match="class count"):
        lv.lease_drain(table, staging, None)
    on_host = lv.DrainStaging("cpu")
    stage_drain(on_host, case)
    with pytest.raises(ValueError, match="staging"):
        lv.lease_drain(table, on_host, item_cc)
    staging.views.dirty_idx[3] = 64
    with pytest.raises(ValueError, match="outside"):
        lv.lease_drain(table, staging, item_cc)


@pytest.mark.cuda
def test_cuda_drain_after_grow_to(cuda_device):
    """A store grown after writes certifies on the card as on the CPU, and
    its device table ends equal to its host versions."""
    from repro_torch.core import stm

    out = []
    for device in (cuda_device, "cpu"):
        store = stm.VersionedStore(300, device=device)
        rng = np.random.default_rng(8)
        store.apply_versioned({int(i): 1.0 for i in rng.integers(0, 300, 20)},
                              7)
        store.grow_to(700)
        store.apply({int(i): 2.0 for i in rng.integers(0, 700, 30)})
        txns = []
        for k in range(11):
            t = stm.Transaction(txid=k + 1, origin=0)
            for item in rng.integers(0, 700, 6):
                t.log_read(int(item), int(store.versions[item]))
            t.log_read(int(rng.integers(0, 700)), 0)
            t.write_set[int(rng.integers(0, 700))] = 1.0
            txns.append(t)
        item_cc = (np.arange(store.n_items) % 9).astype(np.int32)
        locks = stm.ClassLocks(torch.from_numpy(item_cc).to(device),
                               np.array([-1, 0, 2] * 3, np.int32), 0)
        ok = stm.validate_batch(store, txns, class_locks=locks)
        np.testing.assert_array_equal(store.versions_dev.cpu().numpy(),
                                      store.versions.astype(np.int32))
        out.append(ok)
    np.testing.assert_array_equal(out[0], out[1])
    assert 0 < out[0].sum() < len(out[0])


@pytest.mark.cuda
def test_cuda_cluster_run_matches_cpu(cuda_device):
    """A short forced Bank run on the card equals the same run on the CPU,
    and every batched drain on the card went through ``drain``."""
    import dataclasses

    import repro_torch.core as T

    out = []
    for device in ("cuda", "cpu"):
        lv.variant_launches.update(gather=0, drain=0)
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
        if device == "cuda":
            drains = dict(lv.variant_launches)
    assert out[0] == out[1]
    assert out[0][0]["cert_batches"] > 0
    assert drains["drain"] == out[0][0]["cert_batches"] > 0
    assert drains["gather"] == 0


# (B, Sq, Skv, Hq, Hkv, Dk, Dv, causal, window, softcap, dtype, valid): the
# reference's test grid (tests/test_kernels.py), glm4-9b's decode shape
# (Sq = 1 against a 2080-slot ring) in both types, then the edges of the
# kernel's variants (flash_attention.variant): prefill_tc with a ragged
# last tile, without a causal mask and with a window; decode_split at 64
# rows (Sq 4 x group 16), with one valid key in row 0 (most splits see
# nothing), and in f32 at D 64 with a window; then deepseek-v2's MLA dims
# (Dk 192, Dv 128) in bf16 on prefill_tc: causal at S 2048, where early
# rows see few keys, a ragged Sq, kv padding, a window, softcap 30, a GQA
# group of 2, no causal mask; and a decode-size call, still on simt; then
# hubert's head dim (Dk = Dv = 80) in bf16 on prefill_tc, its 128-column
# panels partly outside the tensor: hubert-xlarge's forward shape
# (bidirectional, B 4, S 2048, H 16), causal, a ragged S of 200
# (bidirectional, and causal with GQA 4), GQA (Hq 8, Hkv 2), a window, kv
# padding, softcap; and at 80 in f32 and at a decode size, both on simt.
# ``valid``: row 0's valid length in a one-query case (None: drawn like the
# others); in a prefill case, the keys from ``valid`` on are padding.
FLASH_GRID = [
    (2, 128, 128, 4, 2, 32, 32, True, None, 0.0, "float32", None),
    (1, 100, 100, 4, 4, 16, 16, True, None, 0.0, "float32", None),
    (2, 128, 128, 4, 2, 32, 32, True, 40, 0.0, "float32", None),
    (2, 64, 192, 4, 2, 32, 32, True, None, 0.0, "float32", None),
    (2, 128, 128, 4, 4, 32, 32, False, None, 0.0, "float32", None),
    (2, 128, 128, 8, 2, 64, 64, True, None, 30.0, "bfloat16", None),
    (1, 256, 256, 2, 2, 192, 128, True, None, 0.0, "float32", None),
    (1, 72, 72, 2, 1, 24, 24, True, 16, 0.0, "float32", None),
    (4, 1, 2080, 32, 2, 128, 128, True, None, 0.0, "bfloat16", None),
    (4, 1, 2080, 32, 2, 128, 128, True, None, 0.0, "float32", None),
    (1, 200, 200, 4, 2, 128, 128, True, None, 0.0, "bfloat16", None),
    (1, 256, 256, 4, 2, 128, 128, False, None, 0.0, "bfloat16", None),
    (1, 256, 256, 4, 2, 128, 128, True, 64, 0.0, "bfloat16", None),
    (2, 4, 2080, 32, 2, 128, 128, True, None, 0.0, "bfloat16", None),
    (4, 1, 2080, 32, 2, 128, 128, True, None, 0.0, "bfloat16", 1),
    (2, 1, 1000, 8, 1, 64, 64, True, 128, 0.0, "float32", None),
    # deepseek-v2's MLA prefill dims in bf16 (prefill_tc): Dk 192, Dv 128
    (2, 384, 384, 16, 16, 192, 128, True, None, 0.0, "bfloat16", None),
    (1, 2048, 2048, 16, 16, 192, 128, True, None, 0.0, "bfloat16", None),
    (2, 200, 200, 4, 4, 192, 128, True, None, 0.0, "bfloat16", None),
    (2, 256, 384, 8, 8, 192, 128, True, None, 0.0, "bfloat16", 300),
    (1, 384, 384, 4, 4, 192, 128, True, 100, 0.0, "bfloat16", None),
    (1, 256, 256, 4, 4, 192, 128, True, None, 30.0, "bfloat16", None),
    (1, 256, 256, 8, 4, 192, 128, True, None, 0.0, "bfloat16", None),
    (1, 256, 256, 4, 4, 192, 128, False, None, 0.0, "bfloat16", None),
    (2, 1, 1000, 16, 16, 192, 128, True, None, 0.0, "bfloat16", None),
    # hubert's head dim: prefill_tc<80,80>
    (4, 2048, 2048, 16, 16, 80, 80, False, None, 0.0, "bfloat16", None),
    (1, 512, 512, 4, 4, 80, 80, True, None, 0.0, "bfloat16", None),
    (2, 200, 200, 4, 4, 80, 80, False, None, 0.0, "bfloat16", None),
    (2, 200, 200, 8, 2, 80, 80, True, None, 0.0, "bfloat16", None),
    (1, 256, 256, 8, 2, 80, 80, False, None, 0.0, "bfloat16", None),
    (1, 384, 384, 4, 4, 80, 80, True, 100, 0.0, "bfloat16", None),
    (2, 256, 384, 8, 8, 80, 80, True, None, 0.0, "bfloat16", 300),
    (1, 256, 256, 4, 4, 80, 80, False, None, 30.0, "bfloat16", None),
    (1, 256, 256, 4, 4, 80, 80, False, None, 0.0, "float32", None),
    (2, 1, 1000, 16, 16, 80, 80, True, None, 0.0, "bfloat16", None),
]


def _flash_inputs(seed, b, sq, skv, hq, hkv, dk, dv, dtype, device,
                  valid0=None):
    """Grid inputs; a one-query case gets per-row valid lengths with the
    ring's unwritten tail at position 2^30, as decode builds it (row 0's
    length ``valid0`` when given); in a prefill case the keys from
    ``valid0`` on sit at 2^30, padding."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(device=device, dtype=getattr(torch, dtype))
               for shape in ((b, sq, hq, dk), (b, skv, hkv, dk),
                             (b, skv, hkv, dv)))
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    if sq == 1:
        valid = rng.integers(skv // 2, skv + 1, b)
        if valid0 is not None:
            valid[0] = valid0
        qp = (valid - 1).astype(np.int32)[:, None]
        kp[kp >= valid[:, None]] = 2 ** 30
    else:
        qp = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32),
                             (b, sq)).copy()
        if valid0 is not None:
            kp[:, valid0:] = 2 ** 30
    return q, k, v, torch.from_numpy(qp).to(device), \
        torch.from_numpy(kp).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,dk,dv,causal,window,cap,dtype,valid", FLASH_GRID)
def test_cuda_flash_attention_matches_plain(cuda_device, b, sq, skv, hq, hkv,
                                            dk, dv, causal, window, cap,
                                            dtype, valid):
    q, k, v, qp, kp = _flash_inputs(sq + skv, b, sq, skv, hq, hkv, dk, dv,
                                    dtype, cuda_device, valid)
    kw = dict(q_positions=qp, kv_positions=kp, causal=causal,
              sliding_window=window, logit_softcap=cap)
    name = fa.variant(q.dtype, sq, hq, hkv, dk, dv)
    before, by_variant = fa.launches, dict(fa.variant_launches)
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    by_variant[name] += 1
    assert fa.variant_launches == by_variant
    want = ref.sdpa_ref(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == (b, sq, hq, dv)
    # bf16 (two bf16 ulps, 2^-6 of the value, plus 1e-3): every variant
    # computes in fp32 from the same bf16 inputs and rounds the output
    # once; prefill_tc's P.V takes P as bf16 hi + lo parts (~16 bits),
    # decode_split and simt stay in fp32 throughout
    atol, rtol = (1e-3, 1.6e-2) if dtype == "bfloat16" else (2e-5, 2e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# (B, S, H, P, N, chunk, dtype, h0): the reference's grid, then
# mamba2-780m's prefill shape in bf16, a ragged S through ops.ssd's pad and
# an odd head count (one head per block) in both types; then the edges of
# the tc variant (ssd_scan.variant), all bf16: an odd head count, no h0, a
# ragged S, chunks 64 and 128, N 64, and B x H below the card's 132 SMs
SSD_GRID = [
    (2, 256, 8, 16, 32, 64, "float32", True),
    (1, 128, 16, 64, 128, 32, "float32", True),
    (2, 512, 48, 64, 128, 256, "float32", True),
    (1, 64, 4, 32, 16, 64, "float32", True),
    (4, 2048, 48, 64, 128, 256, "bfloat16", True),
    (2, 100, 6, 64, 128, 32, "float32", False),
    (1, 128, 5, 32, 64, 32, "float32", True),
    (1, 128, 5, 32, 64, 32, "bfloat16", True),
    (1, 512, 5, 64, 128, 256, "bfloat16", True),
    (2, 512, 8, 64, 128, 256, "bfloat16", False),
    (1, 300, 4, 64, 128, 128, "bfloat16", True),
    (2, 256, 6, 64, 128, 64, "bfloat16", True),
    (1, 512, 6, 64, 128, 128, "bfloat16", True),
    (2, 512, 4, 64, 64, 256, "bfloat16", True),
    (1, 2048, 48, 64, 128, 256, "bfloat16", True),
]


def _ssd_inputs(seed, b, s, h, p, n, dtype, device):
    rng = np.random.default_rng(seed)
    t = lambda a, d=torch.float32: torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(device=device, dtype=d)
    xd = getattr(torch, dtype)
    return (t(rng.standard_normal((b, s, h, p)) * 0.5, xd),
            t(np.log1p(np.exp(rng.standard_normal((b, s, h))))),
            t(-np.exp(rng.standard_normal((h,)) * 0.3)),
            t(rng.standard_normal((b, s, 1, n)) * 0.4, xd),
            t(rng.standard_normal((b, s, 1, n)) * 0.4, xd),
            t(rng.standard_normal((b, h, p, n)) * 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype,with_h0", SSD_GRID)
def test_cuda_ssd_scan_matches_plain(cuda_device, b, s, h, p, n, chunk,
                                     dtype, with_h0):
    """y within 2e-5 of max|y| (one bf16 rounding, 1e-2, for bf16 x) and
    the final state at atol 2e-3 / rtol 1e-4, the reference's tolerances;
    the variant variant() names is the one that launched."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(s + h, b, s, h, p, n, dtype,
                                       cuda_device)
    h0 = h0 if with_h0 else None
    name = ss.variant(x.dtype, p, n, chunk)
    before, by_variant = ss.launches, dict(ss.variant_launches)
    y, f = ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    by_variant[name] += 1
    assert ss.variant_launches == by_variant
    pad = (-s) % chunk
    y_r, f_r = ref.ssd_ref(*(ref.pad_seq(t, pad) for t in (x, dt)), a,
                           *(ref.pad_seq(t, pad) for t in (bm, cm)),
                           chunk=chunk, h0=h0)
    y_r = y_r[:, :s]
    assert y.dtype == x.dtype and y.shape == (b, s, h, p)
    rel = 1e-2 if dtype == "bfloat16" else 2e-5
    scale = float(y_r.abs().max()) + 1e-9
    assert float((y.float() - y_r).abs().max()) / scale < rel
    torch.testing.assert_close(f, f_r, atol=2e-3, rtol=1e-4)


# (B, S, H, N, chunk) of tc shapes: mamba2-780m's prefill, and small
# ones at N 64 and 128 with every chunk length tc takes
TC_PHASES = [
    (4, 2048, 48, 128, 256),
    (1, 512, 5, 128, 256),
    (2, 256, 3, 64, 64),
    (1, 384, 9, 128, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,n,chunk", TC_PHASES)
def test_cuda_ssd_tc_phases_match_plain_phases(cuda_device, b, s, h, n,
                                               chunk):
    """tc's kernels one at a time: ssd_state against ref.ssd_states (the
    entering states within one bf16 rounding of the plain ones, rtol 2^-8,
    over the final state's atol 2e-3; the final state at atol 2e-3 / rtol
    1e-4; dt as given and dacum its fp32 cumsum), then ssd_chunk_scan on
    those states against ref.ssd_outputs (y within 1e-2 of max|y|)."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(b + s + h, b, s, h, 64, n, "bfloat16",
                                       cuda_device)
    before = dict(ss.phase_launches)
    states, meta, final = ss.tc_states(x, dt, a, bm, chunk=chunk, h0=h0)
    y = ss.tc_outputs(x, bm, cm, states, meta, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.phase_launches == {k: v + 1 for k, v in before.items()}
    prev, final_r = ref.ssd_states(x, dt, a, bm, chunk, h0=h0)
    torch.testing.assert_close(states.float(), prev, atol=2e-3, rtol=2 ** -8)
    torch.testing.assert_close(final, final_r, atol=2e-3, rtol=1e-4)
    nc = s // chunk
    dtr = dt.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)
    assert torch.equal(meta[:, :, :, 1], dtr)
    dacum = torch.cumsum(dtr * a[None, None, :, None], dim=-1)
    torch.testing.assert_close(meta[:, :, :, 0], dacum, atol=1e-4, rtol=1e-5)
    y_r = ref.ssd_outputs(x, dt, a, bm, cm, chunk, states.float())
    assert float((y.float() - y_r).abs().max()) \
        / (float(y_r.abs().max()) + 1e-9) < 1e-2


# (dtype, B, S, H, P, N, chunk): mamba2-780m prefill, each tc chunk and N,
# and the shapes just outside tc (f32, chunk 32 and 320, P 32, N 32 and 96)
SSD_VARIANT_EDGES = [
    (torch.bfloat16, 4, 2048, 48, 64, 128, 256),
    (torch.bfloat16, 1, 128, 5, 64, 64, 64),
    (torch.bfloat16, 1, 384, 5, 64, 128, 128),
    (torch.float32, 4, 2048, 48, 64, 128, 256),
    (torch.bfloat16, 1, 128, 5, 64, 128, 32),
    (torch.bfloat16, 1, 640, 5, 64, 128, 320),
    (torch.bfloat16, 1, 256, 5, 32, 128, 256),
    (torch.bfloat16, 1, 256, 5, 64, 32, 256),
    (torch.bfloat16, 1, 256, 5, 64, 96, 256),
]


@pytest.mark.cuda
def test_cuda_ssd_launcher_routes_like_variant(cuda_device):
    """The C launcher's choice and its scratch sizes agree with the
    wrapper's variant() and scratch()."""
    import ctypes

    lib = ss.LIB.load()
    for dtype, b, s, h, p, n, chunk in SSD_VARIANT_EDGES:
        elems, floats = ctypes.c_longlong(-1), ctypes.c_longlong(-1)
        code = lib.ssd_scan_variant(ss._DTYPES[dtype], b, s, h, p, n, chunk,
                                    ctypes.byref(elems), ctypes.byref(floats))
        name = ss.variant(dtype, p, n, chunk)
        assert ss.VARIANTS[code] == name
        want = ss.scratch(name, b, s, h, p, n, chunk)
        assert (elems.value, floats.value) == want


@pytest.mark.cuda
def test_cuda_new_wrappers_reject_bad_inputs(cuda_device):
    q, k, v, qp, kp = _flash_inputs(1, 1, 8, 8, 2, 1, 16, 16, "float32",
                                    cuda_device)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attention(q, k, v, q_positions=qp.long(), kv_positions=kp)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, torch.cat([k, k], dim=-1)[..., :16], v,
                           q_positions=qp, kv_positions=kp)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.half(), v, q_positions=qp, kv_positions=kp)
    x, dt, a, bm, cm, h0 = _ssd_inputs(2, 1, 64, 2, 16, 8, "float32",
                                       cuda_device)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ss.ssd_scan(x, dt, a, bm, cm, chunk=48, h0=h0)
    with pytest.raises(TypeError, match="float32"):
        ss.ssd_scan(x, dt.double(), a, bm, cm, chunk=32, h0=h0)
    with pytest.raises(ValueError, match="n_groups"):
        ss.ssd_scan(x, dt, a, bm.expand(1, 64, 2, 8).contiguous(), cm,
                    chunk=32, h0=h0)


# (dtype, B, Sq, Skv, Hq, Hkv, Dk, Dv): glm4-9b prefill and decode, the
# rows-per-kv-head edge (64 / 65), a head dim no fast variant takes,
# Dk != Dv (MLA's prefill, its 64-row edge, f32, (128, 64)), and f32 on
# both sides of the edge; hubert's head dim 80 (its prefill, the 64 / 65
# edge, f32); the prefill and decode shapes of zamba2's shared sites,
# minitron, gemma3 and qwen2-vl as chip_smoke.py runs them
VARIANT_EDGES = [
    (torch.bfloat16, 4, 2048, 2048, 32, 2, 128, 128),
    (torch.bfloat16, 4, 1, 2080, 32, 2, 128, 128),
    (torch.bfloat16, 2, 4, 2080, 32, 2, 128, 128),
    (torch.bfloat16, 1, 65, 65, 2, 2, 64, 64),
    (torch.bfloat16, 1, 128, 128, 2, 2, 96, 96),
    (torch.bfloat16, 1, 1, 512, 16, 1, 192, 128),
    (torch.bfloat16, 2, 2048, 2048, 128, 128, 192, 128),
    (torch.bfloat16, 1, 4, 512, 16, 1, 192, 128),
    (torch.bfloat16, 1, 65, 65, 1, 1, 192, 128),
    (torch.float32, 1, 256, 256, 2, 2, 192, 128),
    (torch.bfloat16, 1, 256, 256, 4, 2, 128, 64),
    (torch.float32, 1, 1, 512, 16, 1, 64, 64),
    (torch.float32, 1, 65, 65, 2, 2, 64, 64),
    (torch.bfloat16, 4, 2048, 2048, 16, 16, 80, 80),
    (torch.bfloat16, 1, 64, 64, 1, 1, 80, 80),
    (torch.bfloat16, 1, 65, 65, 1, 1, 80, 80),
    (torch.float32, 1, 256, 256, 2, 2, 80, 80),
    (torch.bfloat16, 4, 2048, 2048, 32, 32, 64, 64),
    (torch.bfloat16, 4, 1, 2080, 32, 32, 64, 64),
    (torch.bfloat16, 4, 2048, 2048, 24, 8, 128, 128),
    (torch.bfloat16, 4, 1, 2080, 24, 8, 128, 128),
    (torch.bfloat16, 1, 4096, 4096, 32, 16, 128, 128),
    (torch.bfloat16, 1, 1, 4128, 32, 16, 128, 128),
    (torch.bfloat16, 4, 2048, 2048, 12, 2, 128, 128),
    (torch.bfloat16, 4, 1, 2080, 12, 2, 128, 128),
]


@pytest.mark.cuda
def test_cuda_flash_launcher_routes_like_variant(cuda_device):
    """The C launcher's choice and decode_split's scratch size agree with
    the wrapper's variant() and decode_splits()."""
    import ctypes

    lib = fa.LIB.load()
    for dtype, b, sq, skv, hq, hkv, dk, dv in VARIANT_EDGES:
        floats = ctypes.c_longlong(-1)
        code = lib.flash_attention_variant(fa._DTYPES[dtype], b, sq, skv, hq,
                                           hkv, dk, dv, ctypes.byref(floats))
        name = fa.variant(dtype, sq, hq, hkv, dk, dv)
        assert fa.VARIANTS[code] == name
        want = (fa.decode_scratch_floats(b, hkv, skv, sq * (hq // hkv), dv)
                if name == "decode_split" else 0)
        assert floats.value == want


@pytest.mark.cuda
def test_cuda_flash_backward_launcher_routes_like_backward_variant(
        cuda_device):
    """The backward launcher's choice and scratch agree with the wrapper's
    backward_variant() and backward_scratch_floats() on the forward's
    edges (MLA's (192, 128) among them), on GQA shapes whose tc dK/dV grid
    splits the group, and on MLA's training shapes."""
    import ctypes

    lib = fa.LIB.load()
    edges = VARIANT_EDGES + [(torch.bfloat16, 1, 2048, 2048, 32, 2, 128, 128),
                             (torch.bfloat16, 1, 160, 160, 32, 2, 128, 128),
                             (torch.bfloat16, 2, 2048, 2048, 32, 32, 64, 64),
                             (torch.bfloat16, 1, 1024, 1024, 128, 128, 192,
                              128),
                             (torch.bfloat16, 1, 256, 256, 8, 2, 192, 128),
                             (torch.bfloat16, 1, 512, 512, 128, 128, 192,
                              128)]
    for dtype, b, sq, skv, hq, hkv, dk, dv in edges:
        floats = ctypes.c_longlong(-1)
        code = lib.flash_attention_backward_variant(
            fa._DTYPES[dtype], b, sq, skv, hq, hkv, dk, dv,
            ctypes.byref(floats))
        name = fa.backward_variant(dtype, sq, hq, hkv, dk, dv)
        assert fa.BACKWARD_VARIANTS[code] == name
        assert floats.value == fa.backward_scratch_floats(
            name, b, sq, skv, hq, hkv, dk, dv)


@pytest.mark.cuda
def test_cuda_ssd_backward_launcher_routes_like_backward_variant(
        cuda_device):
    """The SSD backward launcher's choice and scratch agree with the
    wrapper's backward_variant() and backward_scratch_floats()."""
    import ctypes

    lib = ss.LIB.load()
    for dtype, b, s, h, p, n, chunk in SSD_VARIANT_EDGES:
        floats = ctypes.c_longlong(-1)
        code = lib.ssd_scan_backward_variant(ss._DTYPES[dtype], b, s, h, p,
                                             n, chunk, ctypes.byref(floats))
        name = ss.backward_variant(dtype, p, n, chunk)
        assert ss.VARIANTS[code] == name
        assert floats.value == ss.backward_scratch_floats(name, b, s, h, p,
                                                          n, chunk, dtype)


@pytest.mark.cuda
def test_cuda_flash_fast_variants_refuse_misaligned_tensors(cuda_device):
    q, k, v, qp, kp = _flash_inputs(5, 1, 256, 256, 4, 2, 128, 128,
                                    "bfloat16", cuda_device)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device=cuda_device)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(shifted, k, v, q_positions=qp, kv_positions=kp)


@pytest.mark.cuda
def test_cuda_ssd_tc_refuses_misaligned_tensors(cuda_device):
    """A tc-shaped call raises on a tensor TMA cannot take; it does not
    fall back to simt."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(6, 1, 256, 2, 64, 128, "bfloat16",
                                       cuda_device)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=cuda_device)[1:].view(x.shape)
    shifted.copy_(x)
    before = dict(ss.variant_launches)
    with pytest.raises(ValueError, match="aligned"):
        ss.ssd_scan(shifted, dt, a, bm, cm, chunk=256, h0=h0)
    assert ss.variant_launches == before


@pytest.mark.cuda
def test_cuda_models_run_through_the_kernels(cuda_device):
    """glm4-9b and mamba2-780m smoke configs: prefill and decode through
    the kernels agree with the plain versions on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import common, decoder

    for arch, counter in (("glm4-9b", fa), ("mamba2-780m", ss)):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        params = common.init_params(
            cfg, torch.Generator(device=cuda_device).manual_seed(0),
            cuda_device)
        toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device,
                             generator=torch.Generator(
                                 device=cuda_device).manual_seed(1))
        out = []
        for use in ("auto", "ref"):
            ctx = decoder.RunCtx(cuda_device, use_kernel=use)
            before = counter.launches
            logits, caches = decoder.prefill(cfg, ctx, params,
                                             {"tokens": toks})
            ring = decoder.init_cache(cfg, 2, 44, torch.float32, cuda_device)
            for r, c in zip(ring, caches):
                for m in r:
                    for leaf, t in r[m].items():
                        src = c[m][leaf]
                        t[tuple(slice(0, d) for d in src.shape)] = src
            step, _ = decoder.decode_step(cfg, ctx, params, ring,
                                          toks[:, -1], 40)
            launched = counter.launches - before
            assert launched == (cfg.n_layers * (2 if arch == "glm4-9b" else 1)
                                if use == "auto" else 0), (arch, launched)
            out.append((logits, step))
        for got, want in zip(*out):
            torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "minitron-4b", "gemma3-27b",
                                  "qwen2-vl-2b", "hubert-xlarge"])
def test_cuda_new_archs_run_through_the_kernels(cuda_device, arch):
    """The smoke configs of the five archs of the last model slice, in
    float32 on the card: through the kernels and through the plain
    versions, within 2e-3.  zamba2, minitron, gemma3 (40 tokens: past its
    32-key window) and qwen2-vl (embeddings and M-RoPE positions whose
    three sections differ) prefill and take a decode step; hubert runs
    its encoder forward over frame embeddings."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import common, decoder

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = common.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    b, s = 2, 40
    if cfg.family in ("vlm", "audio"):
        batch = {"embeds": torch.randn((b, s, cfg.d_model), generator=gen,
                                       device=cuda_device)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device=cuda_device)}
    if cfg.mrope_sections is not None:     # a 4 x 4 image, then text
        t = torch.arange(s, device=cuda_device)
        img = t < 16
        pos = torch.stack([torch.where(img, 0, t - 12),
                           torch.where(img, t // 4, t - 12),
                           torch.where(img, t % 4, t - 12)])
        batch["positions"] = pos[:, None].expand(3, b, s).to(torch.int32)
    out = []
    for use in ("auto", "ref"):
        ctx = decoder.RunCtx(cuda_device, use_kernel=use)
        before = fa.launches + ss.launches
        if not cfg.causal:
            got = [decoder.forward(cfg, ctx, params, batch)]
        else:
            logits, caches = decoder.prefill(cfg, ctx, params, batch)
            ring = decoder.init_cache(cfg, b, s + 4, torch.float32,
                                      cuda_device)
            for r, c in zip(ring, caches):
                for m in r:
                    for leaf, t in r[m].items():
                        src = c[m][leaf]
                        t[tuple(slice(0, d) for d in src.shape)] = src
            step, _ = decoder.decode_step(cfg, ctx, params, ring,
                                          torch.ones((b,), dtype=torch.int32,
                                                     device=cuda_device), s)
            got = [logits, step]
        launched = fa.launches + ss.launches - before
        assert (launched > 0) == (use == "auto"), (arch, use, launched)
        out.append(got)
    for got, want in zip(*out):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_cuda_moe_routed_matches_dense_at_full_width(cuda_device, arch):
    """One MoE layer at its published width, bf16: the routed path
    (``moe_apply``) against the dense oracle (``moe_ref``) on the card, the
    same router in both; within 2e-2 of max |y| (the rounding of products
    over fewer rows)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import common, moe

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=cfg.moe.first_dense_layers + 1)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = common.init_params(cfg, gen, cuda_device,
                           torch.bfloat16)["layers"][-1]["moe"]
    for tokens in (512, 16):
        x = torch.randn((1, tokens, cfg.d_model), generator=gen,
                        device=cuda_device).to(torch.bfloat16)
        routed, dense = moe.moe_apply(p, x, cfg), moe.moe_ref(p, x, cfg)
        assert routed.dtype == torch.bfloat16 and routed.shape == x.shape
        top = float(dense.float().abs().max())
        assert float((routed.float() - dense.float()).abs().max()) \
            <= 2e-2 * top


@pytest.mark.cuda
def test_cuda_kv_migration_is_bitwise(cuda_device):
    """A session's KV column exported from one store on the card lands on
    another bitwise, at another slot, in every layer's leaves (GQA and
    MLA caches; zamba2's Mamba states and shared-site K/V)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.serve.kvcache import KVStore

    for arch in ("mixtral-8x7b", "deepseek-v2-236b", "zamba2-1.2b"):
        cfg = get_smoke_config(arch)
        src = KVStore(cfg, 4, 32, device=cuda_device)
        dst = KVStore(cfg, 4, 32, device=cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        for layer in src.caches:
            for leaves in layer.values():
                for t in leaves.values():
                    t.copy_(torch.randn(t.shape, generator=gen,
                                        device=cuda_device))
        s = src.alloc(9)
        s.length, s.last_token = 17, 5
        dst.alloc(1)
        blob = src.export_session(9)
        s2 = dst.import_session(blob)
        assert s2.slot != s.slot and (s2.length, s2.last_token) == (17, 5)
        for a, b in zip(src.caches, dst.caches):
            for m in a:
                for k in a[m]:
                    assert torch.equal(a[m][k][s.slot], b[m][k][s2.slot])
        assert dst.nbytes_session() == src.nbytes_session()


@pytest.mark.cuda
def test_cuda_real_backend_serving_matches_cpu(cuda_device):
    """RealBackend serving (launch.serve.serve_real at the launch's
    defaults), 2 layers of each MoE arch's smoke config in float32, on the
    card and on the CPU from the same weights: engine metrics key for key
    (but the wall-clock plan_block_s; the engine's routing reads no token
    value) and the first step's logits within 2e-3."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve_real
    from repro_torch.models import common, decoder
    from repro_torch.serve.engine import RealBackend

    for arch in ("mixtral-8x7b", "deepseek-v2-236b"):
        cfg = dataclasses.replace(get_smoke_config(arch), n_layers=2,
                                  dtype="float32")
        params = common.init_params(
            cfg, torch.Generator(device=cuda_device).manual_seed(2),
            cuda_device)
        runs = {}
        for dev in (cuda_device, torch.device("cpu")):
            first = []
            plain_decode = decoder.decode_step

            def decode(*a, **k):
                out = plain_decode(*a, **k)
                if not first:
                    first.append(out[0].float().cpu())
                return out

            decoder.decode_step = decode
            try:
                eng = serve_real(cfg, _to(params, dev), device=dev)
            finally:
                decoder.decode_step = plain_decode
            assert isinstance(eng.backend, RealBackend)
            m = eng.metrics.as_dict()
            assert m.pop("plan_block_s") >= 0.0
            runs[dev.type] = (m, first[0])
        card, host = runs["cuda"], runs["cpu"]
        assert card[0] == host[0] and card[0]["tokens"] > 0
        assert card[0]["transfers"] > 0
        torch.testing.assert_close(card[1], host[1], atol=2e-3, rtol=2e-3)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# -- serving and the placement planner --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,n_items,n_dirty", [
    (1, 64, 0), (2, 64, 3), (7, 128, 40), (8, 256, 160), (33, 1024, 64),
    (64, 4096, 500)])
def test_cuda_drain_without_class_view_matches_twin(cuda_device, b,
                                                    n_items, n_dirty):
    """The serving certifier's drain: one read a transaction (R 1), no
    writes and no class view (W 0, item_cc null), against the twin."""
    case = drain_inputs(11, b, 1, 0, n_items, 0, n_dirty)
    before = dict(lv.variant_launches)
    got, table = _drain_on_card(case, cuda_device)
    want, want_table = drain_twin(case)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(table.cpu().numpy(), want_table.numpy())
    assert lv.variant_launches["drain"] == before["drain"] + 1
    assert lv.variant_launches["gather"] == before["gather"]


@pytest.mark.cuda
def test_cuda_certifier_drains_on_a_growing_store(cuda_device):
    """StepCertifier(jax_min=1) on the card against the same on the CPU
    while the epoch store grows (64 -> 4096 sessions) under pending
    stamps: the same verdicts and the same (n_dirty, B) per drain, one
    ``drain`` launch a batch, B 1-64."""
    from repro_torch.serve.certifier import StepCertifier
    from repro_torch.serve.engine import Request

    certs = {d: StepCertifier(1, jax_min=1, device=d)
             for d in (cuda_device, "cpu")}
    rng = np.random.default_rng(12)
    lv.variant_launches.update(gather=0, drain=0)
    drains = 0
    for step, b in enumerate([1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 63,
                              64]):
        hi = min(4096, 64 << step)
        stamps = [(int(s), int(e)) for s, e in zip(
            rng.integers(0, hi, 3 * b), rng.integers(1, 9, 3 * b))]
        reqs = [(int(s), int(e)) for s, e in zip(
            rng.integers(0, hi, b), rng.integers(0, 9, b))]
        out = {}
        for d, c in certs.items():
            for s, e in stamps:
                c.bump(s, e)
            for s, e in reqs:
                c.enqueue(0, Request(sid=s, origin=0), e)
            passed, aborted, _ = c.drain(0)
            out[str(d)] = ([r.sid for r in passed], [r.sid for r in aborted],
                           c.store.staging.counts)
        drains += 1
        assert out[str(cuda_device)] == out["cpu"]
    card = certs[cuda_device]
    assert card.store.n_items == 4096
    assert lv.variant_launches == {"gather": 0, "drain": drains}
    np.testing.assert_array_equal(card.store.versions_dev.cpu().numpy(),
                                  card.store.versions.astype(np.int32))


@pytest.mark.cuda
def test_cuda_serving_cell_matches_cpu(cuda_device):
    """Two serve_locality cells at its defaults, every certification batch
    packed (jax_min=1): cuda equals cpu key for key, and each batch
    launched ``drain`` once."""
    from repro_torch.launch.serve import run_point

    for policy, arb, loc in (("short", "priced", 0.5), ("long", "hybrid",
                                                        0.9)):
        lv.variant_launches.update(gather=0, drain=0)
        card = run_point("mixtral-8x7b", policy, loc, arbitration=arb,
                         device="cuda", jax_min=1)
        launched = dict(lv.variant_launches)
        host = run_point("mixtral-8x7b", policy, loc, arbitration=arb,
                         device="cpu", jax_min=1)
        for key in ("point", "metrics", "router"):
            assert card[key] == host[key]
        assert launched == {"gather": 0,
                            "drain": card["metrics"]["cert_batches"]}
        assert launched["drain"] > 0


def _score_inputs(seed, c, n):
    rng = np.random.default_rng(seed)
    rates = rng.random((c, n)) * rng.choice([0.0, 0.05], (c, 1))
    return (rates.astype(np.float32), rng.integers(-1, n, c).astype(np.int32),
            rng.random(c) * 2e-3, rng.random(c) * 3e-3, rng.random(n) * 1.2)


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(1, 1), (24, 6), (300, 8), (4096, 16),
                                 (1 << 17, 16), (64, 129)])
def test_cuda_scores_bitwise_equal_numpy_twin(cuda_device, c, n):
    from repro_torch.plan.score import score_moves, score_moves_np

    args = _score_inputs(c + n, c, n)
    rng = np.random.default_rng(c)
    for kw in (dict(horizon_ms=500.0, margin=3.0, min_frac=0.7,
                    min_rate=0.016, load_gain=0.02),
               dict(horizon_ms=200.0, margin=4.0, min_frac=0.05,
                    co_gain=0.25, overload_ctrl=False,
                    co_rates=rng.random((c, c)) * 0.02 if c <= 4096
                    else None)):
        got = score_moves(*args, device="cuda", **kw)
        want = score_moves_np(*args, **kw)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.cuda
def test_cuda_async_scores_and_plans_equal_sync(cuda_device):
    """The side-stream evaluation harvested after host work equals the
    blocking one; a planner's begin ... finish equals its plan()."""
    from repro_torch.plan import PlacementPlanner, PlanConfig, score_moves
    from repro_torch.plan import score_moves_async, price_move_costs

    args = _score_inputs(7, 1 << 15, 16)
    kw = dict(horizon_ms=500.0, margin=3.0, min_frac=0.1, min_rate=0.0)
    fut = score_moves_async(*args, device="cuda", **kw)
    busy = sum(float(np.ones(1 << 18).sum()) for _ in range(8))
    want = score_moves(*args, device="cuda", **kw)
    assert busy > 0 and fut.wait().tobytes() == want.tobytes()
    rng = np.random.default_rng(9)
    n, c = 8, 300
    counts = rng.random((n, c)) * 40.0
    cfg = PlanConfig(top_k=8, margin=0.0, min_frac=0.0, min_events=0.0,
                     node_budget_bytes=np.inf)
    planners = [PlacementPlanner(n, c, cfg, device=d)
                for d in ("cuda", "cuda", "cpu")]
    for p in planners:
        p.affinity.node.counts[:] = counts
    owner = rng.integers(0, n, c).astype(np.int32)
    state = rng.random(c) * 1e6
    fwd, mv = price_move_costs(state, np.full(c, 5120.0))
    cpu = rng.random(n) * 0.5
    key = lambda pl: [(m.cc, m.src, m.dst, m.state_bytes, m.score)
                      for m in pl.moves]
    pending = planners[0].begin(0.0, owner, state, fwd, mv, cpu)
    planners[0].affinity.record_touch(0.0, 1, tuple(range(c)))
    got = planners[0].finish(pending)
    assert got.moves
    assert key(got) == key(planners[1].plan(0.0, owner, state, fwd, mv, cpu))
    assert key(got) == key(planners[2].plan(0.0, owner, state, fwd, mv, cpu))


@pytest.mark.cuda
def test_cuda_sim_plan_matches_cpu(cuda_device):
    """SimConfig.plan on a Bank run with a node failure: the planner and
    the drains on the card give the CPU run's stores and metrics."""
    import dataclasses

    import repro_torch.core as T
    from repro_torch.plan import SIM_PLAN_DEFAULTS

    out = []
    for device in ("cuda", "cpu"):
        lv.variant_launches.update(gather=0, drain=0)
        cfg = T.SimConfig(duration_ms=300.0, warmup_ms=30.0, seed=1,
                          n_classes=64, certify_jax_min=1,
                          plan=SIM_PLAN_DEFAULTS, device=device)
        c = T.make_cluster("LILAC-TM-ST", T.BankWorkload(
            n_nodes=cfg.n_nodes, n_items=cfg.n_items, locality=0.6), cfg)
        c.events.schedule(120.0, lambda: c.gcs.fail(3))
        m = c.run()
        out.append((dataclasses.asdict(m),
                    [(r.store.values.tobytes(), r.store.versions.tobytes())
                     for r in c.replicas]))
        if device == "cuda":
            drains = dict(lv.variant_launches)
            assert c.planner.device.type == "cuda"
    assert out[0] == out[1]
    assert out[0][0]["plan_epochs"] > 0 and out[0][0]["plan_prefetches"] > 0
    assert drains == {"gather": 0, "drain": out[0][0]["cert_batches"]}


@pytest.mark.cuda
def test_cuda_sanitized_cluster_run_matches_cpu(cuda_device):
    """A sanitized forced Bank run (every drain through ``drain`` and
    checked by ``check_write_locks``, every settle on the device and held to
    the sequential ``is_enabled``, a node failure) on the card equals the
    same sanitized run on the CPU and the unsanitized run on the card:
    stores, metrics and sanitizer counters."""
    import dataclasses

    import repro_torch.core as T

    out = {}
    for device, sanitize in (("cuda", True), ("cpu", True), ("cuda", False)):
        lv.variant_launches.update(gather=0, drain=0)
        cfg = T.SimConfig(duration_ms=150.0, warmup_ms=30.0, seed=1,
                          certify_jax_min=1, lease_jax_min=1,
                          cert_slot_mode="per_txn", device=device,
                          sanitize=sanitize)
        c = T.make_cluster("LILAC-TM-ST", T.BankWorkload(
            n_nodes=cfg.n_nodes, n_items=cfg.n_items, locality=0.6), cfg)
        c.events.schedule(120.0, lambda c=c: c.gcs.fail(3))
        m = c.run()
        out[device, sanitize] = (
            dataclasses.asdict(m),
            [(r.store.values.tobytes(), r.store.versions.tobytes())
             for r in c.replicas],
            [r.lm.counters() for r in c.replicas] if sanitize else None)
        if (device, sanitize) == ("cuda", True):
            drains = dict(lv.variant_launches)
    assert out["cuda", True] == out["cpu", True]
    assert out["cuda", True][:2] == out["cuda", False][:2]
    assert drains == {"gather": 0, "drain": out["cuda", True][0]["cert_batches"]}
    assert drains["drain"] > 0
    assert sum(c["checks"] for c in out["cuda", True][2]) > 0


@pytest.mark.cuda
def test_cuda_drain_kernel_write_lock_mutants(cuda_device):
    """The drain kernel handed stale class owners passes a write to a class
    the lease layer has leased to proc 1: the sanitizer names the stale
    view and, from the pass side recomputed on the host, the verdict; the
    live view makes the kernel refuse the write."""
    from repro_torch.analysis.sanitizer import (SanitizerError,
                                                check_write_locks)
    from repro_torch.core.stm import (ClassLocks, Transaction,
                                      VersionedStore, validate_batch)

    store = VersionedStore(3, device=cuda_device)
    item_cc = np.array([0, 1, 1], np.int32)
    owners = np.array([0, 1], np.int32)
    txn = Transaction(txid=7, origin=0)
    txn.log_read(0, 0)
    txn.write_set[2] = 1.0
    forged = ClassLocks(torch.from_numpy(item_cc).to(cuda_device),
                        np.zeros(2, np.int32), 0)
    before = lv.variant_launches["drain"]
    ok = validate_batch(store, [txn], class_locks=forged)
    assert lv.variant_launches["drain"] == before + 1
    assert ok.tolist() == [True]
    with pytest.raises(SanitizerError) as e:
        check_write_locks(0, owners, item_cc, forged, [txn], ok)
    assert e.value.invariant == "write-locks" and "class 1" in e.value.detail
    with pytest.raises(SanitizerError) as e:
        check_write_locks(0, owners, item_cc, None, [txn], ok)
    assert e.value.invariant == "write-locks" and "txn 7" in e.value.detail
    live = forged._replace(owners=owners)
    ok = validate_batch(store, [txn], class_locks=live)
    assert ok.tolist() == [False]
    assert check_write_locks(0, owners, item_cc, live, [txn], ok) == 0


@pytest.mark.cuda
def test_cuda_explore_kernel_cell_matches_cpu(cuda_device):
    """KERNEL_CELL at 50 schedules: every drain of every explored schedule
    through ``drain``, violation-free, and the same ExploreStats as the
    exploration on the CPU."""
    import dataclasses

    from repro_torch.analysis.explore import KERNEL_CELL, explore_scenario

    name, args, cfg = KERNEL_CELL
    cfg = dataclasses.replace(cfg, max_schedules=50)
    stats = {}
    for device in ("cuda", "cpu"):
        lv.variant_launches.update(gather=0, drain=0)
        res = explore_scenario(name, cfg, dict(args, device=device))
        assert res.ok, res.violation.violation
        stats[device] = dataclasses.asdict(res.stats)
        if device == "cuda":
            drains = dict(lv.variant_launches)
    assert stats["cuda"] == stats["cpu"]
    assert drains["drain"] > 0 and drains["gather"] == 0


# -- training: the kernels' autograd Functions --------------------------------

def _grads_of(fn, inputs, weight):
    leaves = [t.detach().clone().requires_grad_(True) if t is not None
              else None for t in inputs]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    wanted = [t for t in leaves if t is not None]
    return out.detach(), torch.autograd.grad((out.float() * weight).sum(),
                                             wanted)


def _rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def _cotangent(seed, shape, device):
    """A seeded standard-normal fp32 weight on the output (numpy, as
    ``_ssd_inputs`` and ``_flash_inputs`` draw): the same data whatever
    ran before in the process."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(device)


# (dtype, B, Sq, Skv, Hq, Hkv, Dk, Dv, causal, window, softcap, valid0):
# f32 on simt; bf16 on the tc backward at each of its instantiations
# ((64, 64), hubert's (80, 80), (128, 128) with a window and a softcap over
# GQA groups of 4, a GQA group of 16 at 160 q rows, which splits the group
# over dkdv_tc blocks, and MLA's (192, 128) on the two-warpgroup dkdv_tc2:
# MHA, a GQA group of 4 split over blocks, a window with a softcap, and
# queries over a padded longer cache); a decode_split shape in bf16 under
# grad on simt; (256, 256) on simt's smallest tiles; queries over a longer
# cache whose keys from valid0 on are padding (Dk != Dv in f32; bf16 GQA
# and MLA on tc)
GRAD_GRID = [
    ("float32", 2, 96, 96, 4, 2, 64, 64, True, None, 0.0, None),
    ("bfloat16", 2, 160, 160, 4, 2, 64, 64, True, None, 0.0, None),
    ("bfloat16", 1, 256, 256, 4, 4, 192, 128, True, None, 0.0, None),
    ("bfloat16", 1, 200, 200, 4, 4, 80, 80, False, None, 0.0, None),
    ("bfloat16", 2, 130, 130, 8, 2, 128, 128, True, 48, 30.0, None),
    ("float32", 1, 40, 40, 2, 1, 256, 256, True, None, 0.0, None),
    ("float32", 2, 8, 64, 4, 4, 64, 64, True, None, 0.0, None),
    ("float32", 1, 64, 160, 4, 2, 32, 48, True, None, 0.0, 120),
    ("bfloat16", 2, 192, 256, 8, 2, 128, 128, True, None, 0.0, 200),
    ("bfloat16", 1, 160, 160, 32, 2, 128, 128, True, None, 0.0, None),
    ("bfloat16", 2, 4, 96, 16, 1, 64, 64, True, None, 0.0, None),
    ("bfloat16", 1, 256, 256, 8, 2, 192, 128, True, None, 0.0, None),
    ("bfloat16", 1, 200, 200, 4, 2, 192, 128, True, 48, 30.0, None),
    ("bfloat16", 2, 192, 256, 8, 8, 192, 128, True, None, 0.0, 200),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,b,sq,skv,hq,hkv,dk,dv,causal,window,cap,valid0", GRAD_GRID)
def test_cuda_attention_function_grads_match_plain(cuda_device, dtype, b, sq,
                                                   skv, hq, hkv, dk, dv,
                                                   causal, window, cap,
                                                   valid0):
    """ops.attention on the card under grad: the flash forward (its lse
    within 1e-4 of the plain one, its output's bits the same without the
    lse) inside an autograd Function whose backward launches the flash
    backward once, as backward_variant() names it.  The gradients are
    within 2e-2 (bf16) or 2e-5 (f32) of each input's largest |gradient|,
    against the plain backward on the same output and lse (and, for tc,
    its plain twin with the bf16 P and dS) and against autograd of the
    plain forward; a second backward gives equal bits."""
    q, k, v, qp, kp = _flash_inputs(3, b, sq, skv, hq, hkv, dk, dv, dtype,
                                    cuda_device, valid0)
    kw = dict(q_positions=qp, kv_positions=kp, causal=causal,
              sliding_window=window, logit_softcap=cap)
    w = _cotangent(b + sq + skv + hq + hkv + dk + dv, (b, sq, hq, dv),
                   cuda_device)
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        bare = fa.flash_attention(q, k, v, **kw)
        _, lse_p = ref.sdpa_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, bare)
    assert float((lse - lse_p).abs().max()) <= 1e-4
    name = fa.backward_variant(q.dtype, sq, hq, hkv, dk, dv)
    assert name == ("tc" if dtype == "bfloat16" and sq * hq // hkv > 64
                    else "simt")
    before = fa.backward_launches
    by_variant = dict(fa.backward_variant_launches)
    out_k, g_k = _grads_of(lambda q, k, v: ops.attention(q, k, v, **kw),
                           (q, k, v), w)
    _, g_a = _grads_of(lambda q, k, v: ref.sdpa_ref(q, k, v, **kw),
                       (q, k, v), w)
    assert fa.backward_launches == before + 1
    assert fa.backward_variant_launches == {
        k_: n + (k_ == name) for k_, n in by_variant.items()}
    assert torch.equal(out_k, out)
    dout = w.to(out.dtype)
    g_p = ref.sdpa_bwd_ref(q, k, v, out, lse, dout, **kw)
    g_t = (ref.sdpa_bwd_tc_ref(q, k, v, out, lse, dout, **kw)
           if name == "tc" else g_p)
    again = fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    for got, plain, twin, auto, rerun in zip(g_k, g_p, g_t, g_a, again):
        assert got.dtype == plain.dtype and got.shape == plain.shape
        assert _rel_err(got, plain) <= tol
        assert _rel_err(got, twin) <= tol
        assert _rel_err(got, auto) <= tol
        assert torch.equal(got, rerun)


# The f32 SSD gradient's reference.  dA is a sum over B x S of terms with
# heavy cancellation: an f32 evaluation of it, plain or kernel, is off its
# fp64 value by up to about half the 1e-4 limit (tools/ssd_grad_digests.py
# at (2 x 763, H 4, P 64, N 128, chunk 256), 9 seeds, 6 processes each:
# ref.ssd_bwd_ref 4.98e-5, autograd of the plain forward 4.25e-5, the
# simt backward before its redesign 7.16e-5; every side's bits the same in
# every process), so two f32 sides differ by up to the sum of their errors
# and compared with each other at 1e-4 they passed or failed with the data.
# In f32 the kernel and each plain side are held to an fp64 evaluation of
# ref.ssd_bwd_ref at the same 1e-4 of each input's largest |gradient|; bf16
# keeps the f32 plain sides at 2e-2.
F32_SSD_GRAD_SEEDS = tuple(range(8))


def _check_ssd_function_grads(device, dtype, p, n, chunk, h, seed):
    b, s = 2, 3 * chunk - 5
    inputs = _ssd_inputs(seed, b, s, h, p, n, dtype, device)
    w = _cotangent(seed + 1, (b, s, h, p), device)
    name = ss.backward_variant(inputs[0].dtype, p, n, chunk)
    assert name == ("tc" if dtype == "bfloat16" and p == 64 else "simt")
    by_variant = dict(ss.backward_variant_launches)
    before = ss.backward_launches
    out_k, g_k = _grads_of(lambda *a: ops.ssd(*a[:5], chunk=chunk, h0=a[5]),
                           inputs, w)
    out_p, g_a = _grads_of(
        lambda *a: ops.ssd(*a[:5], chunk=chunk, h0=a[5], plain=True)[0]
        .to(a[0].dtype), inputs, w)
    assert ss.backward_launches == before + 1
    assert ss.backward_variant_launches == {
        k: c + (k == name) for k, c in by_variant.items()}
    rel = {"float32": 2e-5, "bfloat16": 1e-2}[dtype]
    assert _rel_err(out_k, out_p) <= rel
    pad = (-s) % chunk
    x, dt, a, bm, cm, h0 = inputs
    padded = [ref.pad_seq(t, pad) for t in (x, dt, bm, cm)]
    dy = ref.pad_seq(w.to(x.dtype), pad)
    args = (padded[0], padded[1], a, padded[2], padded[3], h0, dy, None)
    g_p = ref.ssd_bwd_ref(*args, chunk=chunk)
    g_t = ref.ssd_bwd_tc_ref(*args, chunk=chunk) if name == "tc" else g_p
    again = ss.ssd_scan_backward(*args, chunk=chunk)
    cut = lambda i, t: t[:, :s] if i in (0, 1, 3, 4) else t
    if dtype == "float32":
        truth = ref.ssd_bwd_ref(*(None if t is None else t.double()
                                  for t in args), chunk=chunk)
        for i, (got, plain, auto, rerun, want) in enumerate(
                zip(g_k, g_p, g_a, again, truth)):
            assert got.dtype == auto.dtype and got.shape == auto.shape
            for side in (got, cut(i, plain), auto):
                assert _rel_err(side, cut(i, want)) <= 1e-4, i
            assert torch.equal(got, cut(i, rerun)), i
        return
    for i, (got, plain, twin, auto, rerun) in enumerate(zip(g_k, g_p, g_t,
                                                            g_a, again)):
        assert got.dtype == auto.dtype and got.shape == auto.shape
        assert _rel_err(got, cut(i, plain)) <= 2e-2, i
        assert _rel_err(got, cut(i, twin)) <= 2e-2, i
        assert _rel_err(got, auto) <= 2e-2, i
        assert torch.equal(got, cut(i, rerun)), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,n,chunk,h", [("float32", 16, 16, 32, 4),
                                               ("bfloat16", 64, 64, 64, 4),
                                               ("bfloat16", 64, 128, 256, 4),
                                               ("float32", 64, 128, 256, 4),
                                               ("bfloat16", 64, 64, 128, 3),
                                               ("bfloat16", 32, 64, 64, 4)])
def test_cuda_ssd_function_grads_match_plain(cuda_device, dtype, p, n, chunk,
                                             h):
    """ops.ssd on the card under grad, a ragged S padded outside the
    Function: its backward launches the SSD backward once, as
    backward_variant() names it (``tc`` in bf16 at the forward tc's shapes,
    two heads a chunk_tc block at N 64 with H even and one otherwise;
    ``simt`` in f32 and at bf16's other shapes).  The gradients of x, dt,
    A, B, C and h0 are within 2e-2 of each input's largest |gradient| in
    bf16, against the plain backward (and, for tc, its plain twin with the
    kernel's bf16 tiles) and against autograd of the plain forward; in f32
    the kernel, the plain backward and autograd are each within 1e-4 of an
    fp64 evaluation of the plain backward (F32_SSD_GRAD_SEEDS' note); a
    second backward gives equal bits.  Inputs and the weight on y are
    seeded."""
    _check_ssd_function_grads(cuda_device, dtype, p, n, chunk, h, seed=4)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", F32_SSD_GRAD_SEEDS)
def test_cuda_ssd_function_f32_grads_hold_over_seeds(cuda_device, seed):
    """The f32 Function case (simt, P 64, N 128, chunk 256, 4 heads) at
    seeds fixed here: the kernel and both plain sides within 1e-4 of the
    fp64 gradient at each."""
    _check_ssd_function_grads(cuda_device, "float32", 64, 128, 256, 4,
                              seed=seed)


@pytest.mark.cuda
def test_cuda_train_step_reaches_every_leaf(cuda_device):
    """One train step of zamba2's smoke config in f32 with
    use_kernel="kernel" (every attention and SSD through the kernels'
    Functions): a finite loss, every gradient leaf finite and non-zero,
    each backward kernel launched once per layer."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import common, decoder
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import leaves_with_paths

    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"),
                              dtype="float32")
    params = common.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    ctx = decoder.RunCtx(cuda_device, use_kernel="kernel")
    before = (fa.backward_launches, ss.backward_launches)
    loss, _, grads = ts._grad_fn(cfg, ctx)(params, batch)
    assert bool(torch.isfinite(loss))
    for path, g in leaves_with_paths(grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, \
            path
    kinds = common.layer_plan(cfg).kinds
    assert fa.backward_launches - before[0] == \
        sum(k.mixer == "shared_attn" for k in kinds)
    assert ss.backward_launches - before[1] == \
        sum(k.mixer == "mamba" for k in kinds)
    step = ts.make_train_step(cfg, ctx, ts.TrainConfig())
    _, state, metrics = step(params, opt.init(params), batch)
    assert bool(torch.isfinite(metrics["loss"])) and int(state.count) == 1


# decode shapes of the seq-sharded combine: (B, Skv, Hq, Hkv, D) of glm4,
# gemma3 and zamba2 at full width, with a ring 3/4 written
LSE_GRID = [(4, 512, 32, 2, 128), (4, 512, 32, 16, 128),
            (8, 256, 32, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,skv,hq,hkv,d", LSE_GRID)
def test_cuda_decode_split_lse_matches_plain(cuda_device, b, skv, hq, hkv, d,
                                             dtype):
    """decode_split's log-sum-exp output against the plain version's (fp32,
    2e-5), its attention output at the present tolerance, one launch; simt
    (at head dim 48) writes the rows' lse too, with its output's bits as
    without it."""
    q, k, v, qp, kp = _flash_inputs(b + skv, b, 1, skv, hq, hkv, d, d, dtype,
                                    cuda_device)
    kw = dict(q_positions=qp, kv_positions=kp, causal=True)
    assert fa.variant(q.dtype, 1, hq, hkv, d, d) == "decode_split"
    before = fa.variant_launches["decode_split"]
    with torch.no_grad():
        out, lse = ops.attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.variant_launches["decode_split"] == before + 1
    want, want_lse = ref.sdpa_ref(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (b, 1, hq)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
    atol, rtol = (1e-3, 1.6e-2) if dtype == "bfloat16" else (2e-5, 2e-5)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    # another variant (simt, at head dim 48) gives it too
    narrow = [t[..., :48].contiguous() for t in (q, k, v)]
    with torch.no_grad():
        out48, lse48 = fa.flash_attention(*narrow, return_lse=True, **kw)
        bare48 = fa.flash_attention(*narrow, **kw)
    _, want48 = ref.sdpa_ref(*narrow, return_lse=True, **kw)
    assert torch.equal(out48, bare48)
    torch.testing.assert_close(lse48, want48, atol=2e-5, rtol=2e-5)


# (dtype, Sq, Hq, Hkv, Dk, Dv, variant) of the rows that see no key
NO_KEY_GRID = [
    ("bfloat16", 96, 4, 4, 192, 128, "prefill_tc"),
    ("bfloat16", 80, 8, 2, 128, 128, "prefill_tc"),
    ("float32", 48, 4, 2, 64, 64, "simt"),
    ("bfloat16", 40, 4, 4, 32, 32, "simt"),
    ("float32", 1, 8, 2, 128, 128, "decode_split"),
    ("bfloat16", 1, 4, 4, 64, 64, "decode_split"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,sq,hq,hkv,dk,dv,want_variant", NO_KEY_GRID)
def test_cuda_rows_that_see_no_key_merge_and_get_no_gradient(
        cuda_device, dtype, sq, hq, hkv, dk, dv, want_variant):
    """Causal queries over three 64-key chunks of a seq-sharded cache:
    every row sees a key of the first; in the second the rows before
    position 64 see none (a decode row sees 9); in the third no row sees
    one.  Per chunk the
    kernel's lse is within 1e-4 of the plain one and its output at the
    flash tolerance on the rows that see a key; on the others its lse,
    like the plain version's, is at most NEG_INF / 2 (NEG_INF + log of
    the keys it was handed, or -inf), so such a row weighs nothing in the
    merge and its output is not defined; the output's bits are the same
    without the lse.  The chunks merged (``attention.lse_merge``) match the plain
    chunks merged at the flash tolerance.  The backward kernels on each
    chunk match ref.sdpa_bwd_ref on the same lse within 2e-2 (bf16) or
    2e-5 (f32) of the largest |gradient|, and give a row that saw no key
    no dq (the third chunk no gradient at all)."""
    from repro_torch.models.attention import lse_merge

    b, n, width = 2, 3, 64
    q, k, v, _, _ = _flash_inputs(sq + dk, b, sq, n * width, hq, hkv, dk,
                                  dv, dtype, cuda_device)
    assert fa.variant(q.dtype, sq, hq, hkv, dk, dv) == want_variant
    qp = (width + 8 - sq // 2 + torch.arange(sq, dtype=torch.int32,
                                             device=cuda_device)
          ).expand(b, sq).contiguous()
    dout = _cotangent(sq + hq + hkv + dk + dv, (b, sq, hq, dv),
                      cuda_device).to(q.dtype)
    atol, rtol = (1e-3, 1.6e-2) if dtype == "bfloat16" else (2e-5, 2e-5)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    merged = {"kernel": ([], []), "plain": ([], [])}
    for c in range(n):
        kp = (c * width + torch.arange(width, dtype=torch.int32,
                                       device=cuda_device)
              ).expand(b, width).contiguous()
        kc, vc = (t[:, c * width:(c + 1) * width].contiguous()
                  for t in (k, v))
        kw = dict(q_positions=qp, kv_positions=kp, causal=True)
        with torch.no_grad():
            out, lse = fa.flash_attention(q, kc, vc, return_lse=True, **kw)
            bare = fa.flash_attention(q, kc, vc, **kw)
        want, want_lse = ref.sdpa_ref(q, kc, vc, return_lse=True, **kw)
        assert torch.equal(out, bare)
        none = ~ref.attn_mask(qp, kp, True, None).any(dim=-1)
        assert bool(none.all()) == (c == 2)
        assert bool(none.any()) == (c == 2 or (c == 1 and sq > 1))
        rows = none[:, :, None].expand(b, sq, hq)
        assert bool((lse[rows] <= ref.NEG_INF / 2).all())
        assert bool((want_lse[rows] <= ref.NEG_INF / 2).all())
        if not bool(none.all()):
            assert float((lse[~rows] - want_lse[~rows]).abs().max()) <= 1e-4
            torch.testing.assert_close(out[~rows].float(),
                                       want[~rows].float(), atol=atol,
                                       rtol=rtol)
        for name, o, l in (("kernel", out, lse), ("plain", want, want_lse)):
            merged[name][0].append(o)
            merged[name][1].append(l)
        grads = fa.flash_attention_backward(q, kc, vc, out, lse, dout, **kw)
        plain = ref.sdpa_bwd_ref(q, kc, vc, out, lse, dout, **kw)
        assert not bool(grads[0][rows].any())
        for got, p in zip(grads, plain):
            if c == 2:
                assert not bool(got.any()) and not bool(p.any())
            else:
                assert _rel_err(got, p) <= tol
    got, want = (lse_merge(torch.stack(o), torch.stack(l))
                 for o, l in merged.values())
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


# The simt kernels take every product as split-TF32 (csrc/flash_mma.cuh:
# each fp32 operand as two TF32 parts, three products for each); their
# twins ref.sdpa_x3_ref / ref.sdpa_bwd_x3_ref take the same parts in fp32,
# so a kernel and its twin differ by the order of their fp32 sums only
# (tile by tile, inside the tensor cores, and in the online softmax's
# rescaling), not by the split's rounding: half the plain limits, X3_TOL
# (f32 output, atol and rtol; the lse absolute) and X3_GRAD_TOL (f32, of
# each input's largest |gradient|).  A bf16 result is the fp32 one rounded
# once on both sides: one bf16 ulp apart, 2^-7 of the value (of the
# largest gradient), plus, for an output near zero, where the fp32 sums'
# differences (~1e-6 at outputs of magnitude ~1) move it across more than
# one ulp, 1e-5 absolute.
X3_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
X3_LSE_TOL = 1e-5
X3_GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}

# FLASH_GRID's simt rows, then each simt instantiation and copy width:
# MLA's 3-token serving step (heads cut to 16), f32 at (256, 256) and
# (256, 64) on one-warp blocks (eight warps' staging does not fit), a few
# f32 rows at head dim 16 (serve_migration's decode), Dv > 128 in bf16
# with a softcap, odd head dims (bf16: element copies; f32: 4-byte
# cp.async) and hubert's (80, 80) in f32 over padded keys
SIMT_FLASH_GRID = [
    row for row in FLASH_GRID
    if fa.variant(getattr(torch, row[10]), row[1], row[3], row[4], row[5],
                  row[6]) == "simt"] + [
    (2, 3, 2048, 16, 16, 192, 128, True, None, 0.0, "bfloat16", None),
    (1, 40, 40, 2, 1, 256, 256, True, None, 0.0, "float32", None),
    (1, 40, 40, 2, 1, 256, 64, True, None, 0.0, "float32", None),
    (1, 4, 96, 16, 1, 16, 16, True, None, 0.0, "float32", None),
    (1, 130, 130, 2, 2, 256, 200, True, None, 20.0, "bfloat16", None),
    (2, 100, 100, 4, 2, 17, 9, True, None, 0.0, "bfloat16", None),
    (2, 100, 100, 4, 2, 17, 9, True, None, 0.0, "float32", None),
    (1, 300, 300, 4, 4, 80, 80, True, None, 0.0, "float32", 250),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,dk,dv,causal,window,cap,dtype,valid", SIMT_FLASH_GRID)
def test_cuda_simt_forward_matches_its_split_twin(cuda_device, b, sq, skv,
                                                  hq, hkv, dk, dv, causal,
                                                  window, cap, dtype, valid):
    """The simt forward with the lse: within the flash tolerance (lse
    1e-4) of the plain version, within X3_TOL of its split-TF32 twin, and
    two calls give equal bits."""
    q, k, v, qp, kp = _flash_inputs(sq + skv + 1, b, sq, skv, hq, hkv, dk,
                                    dv, dtype, cuda_device, valid)
    kw = dict(q_positions=qp, kv_positions=kp, causal=causal,
              sliding_window=window, logit_softcap=cap)
    assert fa.variant(q.dtype, sq, hq, hkv, dk, dv) == "simt"
    before = fa.variant_launches["simt"]
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        again, lse_again = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.variant_launches["simt"] == before + 2
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    plain, plain_lse = ref.sdpa_ref(q, k, v, return_lse=True, **kw)
    twin, twin_lse = ref.sdpa_x3_ref(q, k, v, return_lse=True, **kw)
    atol, rtol = (1e-3, 1.6e-2) if dtype == "bfloat16" else (2e-5, 2e-5)
    torch.testing.assert_close(out.float(), plain.float(), atol=atol,
                               rtol=rtol)
    assert float((lse - plain_lse).abs().max()) <= 1e-4
    atol, rtol = X3_TOL[dtype]
    torch.testing.assert_close(out.float(), twin.float(), atol=atol,
                               rtol=rtol)
    assert float((lse - twin_lse).abs().max()) <= X3_LSE_TOL


# GRAD_GRID's simt rows, then MLA's (192, 128) in f32 with a window and a
# softcap, odd head dims in f32, and bf16 at tc shapes asked for by name
SIMT_GRAD_GRID = [
    row for row in GRAD_GRID
    if fa.backward_variant(getattr(torch, row[0]), row[2], row[4], row[5],
                           row[6], row[7]) == "simt"] + [
    ("float32", 1, 200, 200, 4, 2, 192, 128, True, 48, 30.0, None),
    ("float32", 2, 100, 100, 4, 2, 17, 9, True, None, 0.0, None),
    ("bfloat16", 2, 160, 160, 4, 2, 64, 64, True, None, 0.0, None),
    ("bfloat16", 1, 256, 256, 4, 4, 192, 128, True, None, 0.0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,b,sq,skv,hq,hkv,dk,dv,causal,window,cap,valid0", SIMT_GRAD_GRID)
def test_cuda_simt_backward_matches_its_split_twin(cuda_device, dtype, b, sq,
                                                   skv, hq, hkv, dk, dv,
                                                   causal, window, cap,
                                                   valid0):
    """The simt backward (asked for by name) from the forward's output and
    lse: within 2e-5 (f32) or 2e-2 (bf16) of each input's largest
    |gradient| of the plain backward, within X3_GRAD_TOL of its
    split-TF32 twin, and two calls give equal bits."""
    q, k, v, qp, kp = _flash_inputs(sq + skv + 2, b, sq, skv, hq, hkv, dk,
                                    dv, dtype, cuda_device, valid0)
    kw = dict(q_positions=qp, kv_positions=kp, causal=causal,
              sliding_window=window, logit_softcap=cap)
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    dout = _cotangent(b + sq + skv + hq + hkv + dk + dv + 1,
                      (b, sq, hq, dv), cuda_device).to(q.dtype)
    before = fa.backward_variant_launches["simt"]
    got = fa.flash_attention_backward(q, k, v, out, lse, dout, variant="simt",
                                      **kw)
    again = fa.flash_attention_backward(q, k, v, out, lse, dout,
                                        variant="simt", **kw)
    torch.cuda.synchronize()
    assert fa.backward_variant_launches["simt"] == before + 2
    plain = ref.sdpa_bwd_ref(q, k, v, out, lse, dout, **kw)
    twin = ref.sdpa_bwd_x3_ref(q, k, v, out, lse, dout, **kw)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    for g, r, p, w in zip(got, again, plain, twin):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.equal(g, r)
        assert _rel_err(g, p) <= tol
        assert _rel_err(g, w) <= X3_GRAD_TOL[dtype]


# The SSD simt kernels against their split-TF32 twins ref.ssd_x3_ref and
# ref.ssd_bwd_x3_ref, which take the same split products: the kernels
# differ from them by the order of their fp32 sums and the SFU's exp in W,
# not by the split's rounding, so the limits are half the plain ones: y
# within 1e-5 of max|y| in f32 (one bf16 step, 2^-7 of max|y|, in bf16),
# the final state at atol 1e-3 / rtol 5e-5, the gradients within 5e-5 (f32)
# or 2^-7 (bf16) of each input's largest.  dA, a sum with heavy
# cancellation that two f32 evaluations need not hold to 1e-4 of each
# other (F32_SSD_GRAD_SEEDS' note), is held to the fp64 plain backward at
# 1e-4 instead.
SSD_X3_Y_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
SSD_X3_GRAD_TOL = {"float32": 5e-5, "bfloat16": 2.0 ** -7}
# SSD_GRID's simt rows, then P and N off multiples of 8
SIMT_SSD_GRID = [row for row in SSD_GRID
                 if ss.variant(getattr(torch, row[6]), row[3], row[4],
                               row[5]) == "simt"] + [
    (1, 200, 3, 24, 36, 64, "float32", True),
    (2, 96, 3, 17, 20, 32, "bfloat16", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype,with_h0", SIMT_SSD_GRID)
def test_cuda_ssd_simt_forward_matches_its_split_twin(cuda_device, b, s, h, p,
                                                      n, chunk, dtype,
                                                      with_h0):
    """The simt forward: two calls give equal bits, y and the final state
    within SSD_X3_Y_TOL and atol 1e-3 / rtol 5e-5 of ref.ssd_x3_ref."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(s + h + p, b, s, h, p, n, dtype,
                                       cuda_device)
    h0 = h0 if with_h0 else None
    pad = (-s) % chunk
    x, dt, bm, cm = (ref.pad_seq(t, pad) for t in (x, dt, bm, cm))
    before = ss.variant_launches["simt"]
    y, f = ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    y2, f2 = ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ss.variant_launches["simt"] == before + 2
    assert torch.equal(y, y2) and torch.equal(f, f2)
    y_t, f_t = ref.ssd_x3_ref(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    scale = float(y_t.abs().max()) + 1e-9
    assert float((y.float() - y_t).abs().max()) / scale < SSD_X3_Y_TOL[dtype]
    torch.testing.assert_close(f, f_t, atol=1e-3, rtol=5e-5)


# (dtype, B, S, H, P, N, chunk): the f32 Function case's shape, odd H at N
# 64 (two heads a block, the last alone), small P and N off multiples of
# 8, and bf16 at simt's own shapes and at tc's asked for by name
SIMT_SSD_GRAD_GRID = [
    ("float32", 2, 768, 4, 64, 128, 256),
    ("float32", 1, 1024, 5, 64, 64, 256),
    ("float32", 2, 96, 4, 16, 16, 32),
    ("float32", 1, 192, 3, 24, 36, 64),
    ("bfloat16", 2, 192, 4, 32, 64, 64),
    ("bfloat16", 1, 512, 4, 64, 64, 256),
    ("bfloat16", 1, 384, 3, 64, 128, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,p,n,chunk", SIMT_SSD_GRAD_GRID)
def test_cuda_ssd_simt_backward_matches_its_split_twin(cuda_device, dtype, b,
                                                       s, h, p, n, chunk):
    """The simt backward (asked for by name) with h0 and the final state's
    gradient: two calls give equal bits; every gradient within 1e-4 (f32)
    or 2e-2 (bf16) of each input's largest of the plain backward and within
    SSD_X3_GRAD_TOL of ref.ssd_bwd_x3_ref, dA in f32 within 1e-4 of the
    fp64 plain backward instead."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(s + h + n, b, s, h, p, n, dtype,
                                       cuda_device)
    dy = _cotangent(s + h + n + 1, (b, s, h, p), cuda_device).to(x.dtype)
    dfinal = _cotangent(s + h + n + 2, (b, h, p, n), cuda_device)
    args = (x, dt, a, bm, cm, h0, dy, dfinal)
    before = ss.backward_variant_launches["simt"]
    got = ss.ssd_scan_backward(*args, chunk=chunk, variant="simt")
    again = ss.ssd_scan_backward(*args, chunk=chunk, variant="simt")
    torch.cuda.synchronize()
    assert ss.backward_variant_launches["simt"] == before + 2
    plain = ref.ssd_bwd_ref(*args, chunk=chunk)
    twin = ref.ssd_bwd_x3_ref(*args, chunk=chunk)
    truth = ref.ssd_bwd_ref(*(t.double() for t in args), chunk=chunk)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    for i, (g, r, pl, w, tr) in enumerate(zip(got, again, plain, twin,
                                              truth)):
        assert g.dtype == pl.dtype and g.shape == pl.shape, i
        assert torch.equal(g, r), i
        if i == 2 and dtype == "float32":
            assert _rel_err(g, tr) <= 1e-4
            continue
        assert _rel_err(g, pl) <= tol, i
        assert _rel_err(g, w) <= SSD_X3_GRAD_TOL[dtype], i


@pytest.mark.cuda
def test_cuda_seq_mesh_of_one_decodes_bitwise(cuda_device):
    """glm4's smoke decode on a world-of-one NCCL mesh with a seq axis (the
    ring on one seq rank, merged through decode_split's log-sum-exp and
    one all-gather) equals the decode without a mesh bit for bit."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import init_world
    from repro_torch.models import common, decoder

    init_world(cuda_device)
    mesh = init_device_mesh("cuda", (1, 1, 1),
                            mesh_dim_names=("data", "seq", "model"))
    cfg = dataclasses.replace(get_smoke_config("glm4-9b"), n_heads=32,
                              n_kv_heads=2, head_dim=64, d_model=256)
    params = common.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device,
        torch.bfloat16)
    outs = []
    for ctx in (decoder.RunCtx(cuda_device),
                decoder.RunCtx(cuda_device, mesh=mesh, seq_axis="seq")):
        caches = decoder.init_cache(cfg, 2, 128, torch.bfloat16, cuda_device,
                                    mesh=ctx.mesh)
        tok = torch.tensor([3, 5], dtype=torch.int32, device=cuda_device)
        for pos in range(3):
            logits, caches = decoder.decode_step(cfg, ctx, params, caches,
                                                 tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
            outs.append(logits)
    n = len(outs) // 2
    for a, b in zip(outs[:n], outs[n:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_seq_sharded_decode_on_two_cards():
    """Seq-sharded decode across two cards (NCCL): needs two; the one-card
    machine skips it, and the CPU gloo worlds of
    tests/test_torch_sharded.py hold the same path."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import torch_gloo

    res = torch_gloo.run_world("seq_decode_cards", 2, backend="nccl")
    for r in res:
        assert float(np.max(np.abs(r["got"] - r["ref"]))) < 2e-4


@pytest.mark.cuda
def test_cuda_moe_decode_syncs_are_flagged_by_host_sync(cuda_device):
    """The decode step of a narrow routed-MoE model (mixtral's smoke
    config, 2 layers) under PyTorch's sync debug mode: the host waits (the
    routed path needs its expert counts), and every site where it waits,
    the innermost frame under ``src/repro_torch/``, is a line the lint's
    ``host-sync`` rule flags (allows not applied)."""
    import dataclasses
    import traceback
    import warnings
    from pathlib import Path

    from repro_torch.analysis import lint
    from repro_torch.analysis.rules import host_sync
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import common, decoder

    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), n_layers=2)
    params = common.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(3), cuda_device)
    ctx = decoder.RunCtx(cuda_device)
    caches = decoder.init_cache(cfg, 2, 64, cfg.compute_dtype(), cuda_device)
    tok = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    decoder.decode_step(cfg, ctx, params, caches, tok, pos)
    root = str(lint.DEFAULT_TARGET) + "/"
    sites = []

    def hook(message, *args, **kw):
        if "synchroniz" in str(message):
            ours = [f for f in traceback.extract_stack()
                    if f.filename.startswith(root)]
            sites.append((ours[-1].filename, ours[-1].lineno) if ours
                         else None)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            decoder.decode_step(cfg, ctx, params, caches, tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sites and None not in sites
    for filename, line in sorted(set(sites)):
        path = Path(filename)
        rel = path.relative_to(lint.REPO_ROOT).as_posix()
        flagged = {v.line for v in host_sync.RULE.check(
            lint.FileCtx(path, rel, path.read_text(), lint.Project()))}
        assert line in flagged, f"{rel}:{line} waits, host-sync is quiet"
