"""repro_torch.serve.kvcache held to repro.serve.kvcache on the CPU.

The mesh-free KV-store tests of ``tests/test_serve.py`` on the port (a
migrated session decodes identically on the destination pod, after slot
recycling, and when the slot count equals the reference's scanned group
count), the bytes a column ships against the reference's for every arch
that decodes, and the refusal of a mesh.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models.common import layer_plan as jlayer_plan
from repro.serve.kvcache import KVStore as JKVStore
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import common, decoder
from repro_torch.serve.kvcache import KVStore

CFG = dataclasses.replace(get_smoke_config("glm4-9b"), dtype="float32")
CTX = decoder.RunCtx("cpu", use_kernel="ref")
DECODABLE = [a for a in ARCH_IDS if get_smoke_config(a).causal]


def _params(seed, cfg=CFG):
    return common.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _fill(params, store, steps=3, cfg=CFG):
    """Decode ``steps`` tokens into every slot of ``store``; the last
    tokens and the logits one step later."""
    n = store.n_slots
    tok = torch.zeros((n,), dtype=torch.int32)
    pos = torch.zeros((n,), dtype=torch.int32)
    for _ in range(steps):
        logits, store.caches = decoder.decode_step(cfg, CTX, params,
                                                   store.caches, tok, pos)
        tok = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
    logits, _ = decoder.decode_step(cfg, CTX, params, store.caches, tok, pos)
    return tok, logits


def _decode_imported(params, dst, slot, last_token, length, cfg=CFG):
    tok = torch.zeros((dst.n_slots,), dtype=torch.int32)
    tok[slot] = last_token
    logits, _ = decoder.decode_step(
        cfg, CTX, params, dst.caches, tok,
        torch.full((dst.n_slots,), length, dtype=torch.int32))
    return logits[slot]


def test_kvstore_export_import_roundtrip():
    """A migrated session decodes identically on the destination pod."""
    params = _params(0)
    src = KVStore(CFG, 4, 64, torch.float32, device="cpu")
    dst = KVStore(CFG, 4, 64, torch.float32, device="cpu")
    s = src.alloc(42)
    tok, logits_src = _fill(params, src)
    s.length, s.last_token = 3, int(tok[s.slot])
    blob = src.export_session(42)
    s2 = dst.import_session(blob)
    got = _decode_imported(params, dst, s2.slot, s.last_token, 3)
    np.testing.assert_allclose(got.numpy(), logits_src[s.slot].numpy(),
                               rtol=1e-4, atol=1e-4)
    # the blob is a copy: writing the source column does not change it
    before = [t.clone() for t in blob["tree"][0]["attn"].values()]
    for t in src.caches[0]["attn"].values():
        t.zero_()
    assert all(torch.equal(a, b) for a, b in
               zip(before, blob["tree"][0]["attn"].values()))


def test_kvstore_roundtrip_after_slot_recycling():
    """Export -> free -> import still decodes right when slot indices differ
    between pods (slots are recycled on the source, pre-claimed on the dst)."""
    params = _params(1)
    src = KVStore(CFG, 4, 64, torch.float32, device="cpu")
    dst = KVStore(CFG, 4, 64, torch.float32, device="cpu")
    for sid in (1, 2, 3):
        src.alloc(sid)
    src.free(2)
    s = src.alloc(42)                      # reuses slot freed by sid 2
    for sid in (7, 8):
        dst.alloc(sid)
    tok, logits_src = _fill(params, src)
    s.length, s.last_token = 3, int(tok[s.slot])
    blob = src.export_session(42)
    src.free(42)
    s2 = dst.import_session(blob)
    assert s2.slot != s.slot               # the indirection must absorb this
    assert (s2.length, s2.last_token) == (3, s.last_token)
    got = _decode_imported(params, dst, s2.slot, s.last_token, 3)
    np.testing.assert_allclose(got.numpy(), logits_src[s.slot].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_kvstore_roundtrip_when_n_groups_equals_n_slots():
    """The slot count equals the reference's scanned group count (2 for
    glm4-9b's smoke config), where the reference once exported the group
    axis: the port's column is one slot wide on dim 0 of every leaf."""
    n_slots = jlayer_plan(jget_smoke("glm4-9b")).n_groups
    assert n_slots == 2
    params = _params(2)
    src = KVStore(CFG, n_slots, 64, torch.float32, device="cpu")
    dst = KVStore(CFG, n_slots, 64, torch.float32, device="cpu")
    s = src.alloc(42)
    tok, logits_src = _fill(params, src)
    s.length, s.last_token = 3, int(tok[s.slot])
    blob = src.export_session(42)
    assert len(blob["tree"]) == CFG.n_layers
    for layer, ring in zip(blob["tree"], src.caches):
        for name, leaf in layer["attn"].items():
            assert leaf.shape == (1,) + ring["attn"][name].shape[1:]
            assert torch.equal(leaf[0], ring["attn"][name][s.slot])
    dst.alloc(7)
    s2 = dst.import_session(blob)
    got = _decode_imported(params, dst, s2.slot, s.last_token, 3)
    np.testing.assert_allclose(got.numpy(), logits_src[s.slot].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_hybrid_session_moves_bitwise():
    """zamba2's session column: each Mamba layer's conv and SSM state and
    each shared site's own K/V leave the source and land at another slot
    of the destination bitwise, and the session decodes there as it would
    have at home."""
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"),
                              dtype="float32")
    params = _params(3, cfg)
    src = KVStore(cfg, 3, 32, torch.float32, device="cpu")
    dst = KVStore(cfg, 3, 32, torch.float32, device="cpu")
    for sid in (1, 42):
        src.alloc(sid)
    s = src.sessions[42]
    tok, logits_src = _fill(params, src, cfg=cfg)
    s.length, s.last_token = 3, int(tok[s.slot])
    blob = src.export_session(42)
    mixers = [set(layer) for layer in blob["tree"]]
    assert {"attn"} in mixers and {"mamba"} in mixers
    for sid in (7, 8):
        dst.alloc(sid)
    s2 = dst.import_session(blob)
    assert s2.slot != s.slot
    for a, b in zip(src.caches, dst.caches):
        for m in a:
            for k in a[m]:
                assert torch.equal(a[m][k][s.slot], b[m][k][s2.slot])
    got = _decode_imported(params, dst, s2.slot, s.last_token, 3, cfg=cfg)
    np.testing.assert_allclose(got.numpy(), logits_src[s.slot].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert dst.nbytes_session() == src.nbytes_session() == sum(
        t.numel() * t.element_size() for layer in blob["tree"]
        for m in layer.values() for t in m.values())


@pytest.mark.parametrize("arch", DECODABLE)
def test_nbytes_session_equals_reference(arch):
    """The engine prices a KV migration with these bytes: equal to the
    reference's store for the same config, slots, length and dtype."""
    cfg = get_smoke_config(arch)
    for n_slots, max_len, dtype in ((8, 256, "bfloat16"), (3, 40, "float32")):
        got = KVStore(cfg, n_slots, max_len, getattr(torch, dtype),
                      device="cpu")
        want = JKVStore(jget_smoke(arch), n_slots, max_len, jnp.dtype(dtype))
        assert got.nbytes_session() == want.nbytes_session()
        assert got.seq_shards == want.seq_shards == 1
        blob = got.export_session(got.alloc(5).sid)
        assert sum(t.numel() * t.element_size() for layer in blob["tree"]
                   for m in layer.values() for t in m.values()) \
            == got.nbytes_session()


def test_kvstore_ledger_and_refusals():
    st = KVStore(CFG, 2, 16, torch.float32, device="cpu")
    a, b = st.alloc(1), st.alloc(2)
    assert st.alloc(1) is a and {a.slot, b.slot} == {0, 1}
    with pytest.raises(RuntimeError, match="full"):
        st.alloc(3)
    st.free(1)
    st.free(99)                            # unknown: nothing to free
    assert not st.has(1) and st.has(2)
    assert st.alloc(3).slot == a.slot
    # on a seq mesh the rings are cut into seq chunks: a ring that does not
    # divide is refused, and one that does holds S / 4 positions a rank
    seq_mesh = {"data": 1, "seq": 4, "model": 1}
    with pytest.raises(ValueError, match="seq axis"):
        KVStore(CFG, 2, 30, device="cpu", mesh=seq_mesh)
    st = KVStore(CFG, 2, 16, device="cpu", mesh=seq_mesh)
    ring = next(layer["attn"]["k"] for layer in st.caches if "attn" in layer)
    assert ring.shape[:2] == (2, 4) and st.seq_shards == 4.0
