"""The SSD kernel's routing, plain phases and tc's roundings, on the CPU.

``ssd_scan.variant`` is the Python twin of the C launcher's choice between
``tc`` and ``simt`` (the launcher reports its choice and the wrapper checks
the two agree on the card; ``tests/test_torch_cuda.py`` holds the C side
to it).  ``ref.ssd_states`` and ``ref.ssd_outputs`` are the plain twins of
``tc``'s two kernels: they compose to ``ref.ssd_ref`` and are held to the
JAX reference here.  A torch emulation of ``tc``'s roundings shows why the
state product takes the weighted x as bf16 hi + lo parts.  No card needed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss
from test_torch_cuda import SSD_GRID, SSD_VARIANT_EDGES

BF16, F32 = torch.bfloat16, torch.float32

# (dtype, P, N, chunk) -> variant
EDGES = [
    ((BF16, 64, 128, 256), "tc"),       # mamba2-780m prefill
    ((BF16, 64, 64, 64), "tc"),         # N 64, the shortest tc chunk
    ((BF16, 64, 128, 128), "tc"),
    ((BF16, 64, 128, 192), "tc"),
    ((F32, 64, 128, 256), "simt"),      # f32: 2e-5 needs the CUDA cores
    ((BF16, 64, 128, 32), "simt"),      # chunk 32
    ((BF16, 64, 128, 96), "simt"),      # chunk not a multiple of 64
    ((BF16, 64, 128, 320), "simt"),     # chunk over 256
    ((BF16, 32, 128, 256), "simt"),     # P 32
    ((BF16, 16, 32, 64), "simt"),
    ((BF16, 64, 100, 256), "simt"),     # odd N
    ((BF16, 64, 32, 256), "simt"),      # N 32
    ((BF16, 64, 96, 256), "simt"),      # N 96
]

# SSD_GRID row -> variant, in the grid's order
GRID_VARIANTS = [
    "simt", "simt", "simt", "simt",     # the reference's grid, f32
    "tc",                               # mamba2-780m prefill
    "simt", "simt", "simt",             # ragged f32; odd H at P 32
    "tc", "tc", "tc", "tc", "tc", "tc", "tc",   # tc's edges
]

# the reference's SSD grid (tests/test_torch_attention_ssd.py): B, S, H, P,
# N, chunk, Pallas head block
JAX_GRID = [
    (2, 256, 8, 16, 32, 64, 4),
    (1, 128, 16, 64, 128, 32, 8),
    (2, 512, 48, 64, 128, 256, 8),
    (1, 64, 4, 32, 16, 64, 4),
]


@pytest.mark.parametrize("shape,want", EDGES)
def test_variant_at_the_edges(shape, want):
    assert ss.variant(*shape) == want


@pytest.mark.parametrize("row,want", list(zip(SSD_GRID, GRID_VARIANTS)))
def test_variant_of_every_card_grid_row(row, want):
    b, s, h, p, n, chunk, dtype, with_h0 = row
    assert len(GRID_VARIANTS) == len(SSD_GRID)
    assert ss.variant(getattr(torch, dtype), p, n, chunk) == want


def test_card_edge_list_covers_both_variants():
    names = {ss.variant(d, p, n, c)
             for d, b, s, h, p, n, c in SSD_VARIANT_EDGES}
    assert names == set(ss.VARIANTS)


@pytest.mark.parametrize("b,s,h,n,chunk,want", [
    # mamba2-780m: 4 x 8 chunks x 48 heads; 64 x 128 states, 2 x 256 floats
    (4, 2048, 48, 128, 256, (1536 * 64 * 128, 1536 * 512)),
    (1, 128, 5, 64, 64, (10 * 64 * 64, 10 * 128)),
])
def test_tc_scratch_size(b, s, h, n, chunk, want):
    assert ss.tc_scratch(b, s, h, n, chunk) == want


@pytest.mark.parametrize("b,s,h,p,n,chunk,want", [
    # mamba2-780m in f32: 4 x 8 chunks x 48 heads, fp32 64 x 128 states
    (4, 2048, 48, 64, 128, 256, (1536 * 64 * 128, 1536 * 512)),
    (1, 96, 3, 17, 20, 32, (9 * 17 * 20, 9 * 64)),
])
def test_simt_scratch_size(b, s, h, p, n, chunk, want):
    assert ss.simt_scratch(b, s, h, p, n, chunk) == want
    assert ss.scratch("simt", b, s, h, p, n, chunk) == want


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal((h,)) * 0.3).astype(np.float32)
    bm = (rng.standard_normal((b, s, 1, n)) * 0.4).astype(np.float32)
    cm = (rng.standard_normal((b, s, 1, n)) * 0.4).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("b,s,h,p,n,chunk,hb", JAX_GRID)
def test_plain_phases_compose_and_match_reference(b, s, h, p, n, chunk, hb):
    """ssd_outputs over ssd_states is ref.ssd_ref exactly; against repro's
    ssd_ref and its interpreted Pallas kernel, y within 2e-5 of max|y| and
    the final state at atol 2e-3 / rtol 1e-4; the state entering chunk c
    is the reference's final state after the first c chunks."""
    arrays = _ssd_inputs(s + h, b, s, h, p, n)
    x, dt, a, bm, cm, h0 = (torch.from_numpy(t) for t in arrays)
    prev, final = ref.ssd_states(x, dt, a, bm, chunk, h0=h0)
    y = ref.ssd_outputs(x, dt, a, bm, cm, chunk, prev)
    y_ref, f_ref = ref.ssd_ref(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    assert torch.equal(y, y_ref) and torch.equal(final, f_ref)
    assert prev.shape == (b, s // chunk, h, p, n)
    assert torch.equal(prev[:, 0], h0)

    jx, jdt, ja, jbm, jcm, jh0 = (jnp.asarray(t) for t in arrays)
    y_r, f_r = jref.ssd_ref(jx, jdt, ja, jbm, jcm, chunk=chunk, h0=jh0)
    y_k, f_k = pallas_ssd(jx, jdt, ja, jbm, jcm, chunk=chunk, h0=jh0,
                          block_heads=hb)
    for y_j, f_j in ((y_r, f_r), (y_k, f_k)):
        scale = float(jnp.max(jnp.abs(y_j))) + 1e-9
        assert float(np.max(np.abs(y.numpy() - np.asarray(y_j)))) / scale \
            < 2e-5
        np.testing.assert_allclose(final.numpy(), np.asarray(f_j),
                                   atol=2e-3, rtol=1e-4)
    for c in range(1, s // chunk):
        t = c * chunk
        _, f_c = jref.ssd_ref(jx[:, :t], jdt[:, :t], ja, jbm[:, :t],
                              jcm[:, :t], chunk=chunk, h0=jh0)
        np.testing.assert_allclose(prev[:, c].numpy(), np.asarray(f_c),
                                   atol=2e-3, rtol=1e-4)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _tc_emulation(x, dt, a, bm, cm, h0, chunk, split_x: bool):
    """tc's arithmetic in torch: fp32 state and accumulators; the weighted
    x of the state product as bf16 hi + lo parts (``split_x``) or one bf16
    rounding; the entering states and W rounded once to bf16.  x, B and C
    are bf16 values already."""
    bsz, s, h, p = x.shape
    n, nc = bm.shape[-1], s // chunk
    xr = x.reshape(bsz, nc, chunk, h, p)
    dtr = dt.reshape(bsz, nc, chunk, h)
    br = bm.reshape(bsz, nc, chunk, n)
    cr = cm.reshape(bsz, nc, chunk, n)
    dacum = torch.cumsum(dtr * a, dim=2)                   # [B,nc,L,H]
    carry, prevs = h0.clone(), []
    for c in range(nc):
        prevs.append(_bf16(carry))
        last = dacum[:, c, -1]                                 # [B,H]
        wx = xr[:, c] * (torch.exp(last[:, None] - dacum[:, c])
                         * dtr[:, c])[..., None]               # [B,L,H,P]
        parts = [_bf16(wx), _bf16(wx - _bf16(wx))] if split_x \
            else [_bf16(wx)]
        carry = carry * torch.exp(last)[..., None, None]
        for part in parts:
            carry = carry + torch.einsum("blhp,bln->bhpn", part, br[:, c])
    prev = torch.stack(prevs, dim=1)                           # [B,nc,H,P,N]
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)               # [B,nc,L,L]
    seg = dacum.permute(0, 1, 3, 2)                            # [B,nc,H,L]
    decay = torch.exp(seg[..., :, None] - seg[..., None, :])
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    w = torch.where(mask, cb[:, :, None] * decay
                    * dtr.permute(0, 1, 3, 2)[..., None, :], 0.0)
    y = torch.einsum("bchij,bcjhp->bcihp", _bf16(w), xr) \
        + torch.einsum("bcin,bchpn->bcihp", cr, prev) \
        * torch.exp(dacum)[..., None]
    return y.reshape(bsz, s, h, p), carry


def test_tc_roundings_meet_the_limits_only_with_hi_lo_x():
    """With W and the entering states in bf16, y stays within 1e-2 of
    max|y| either way, but the final state meets atol 2e-3 / rtol 1e-4
    only when the weighted x goes in as bf16 hi + lo parts."""
    b, s, h, p, n, chunk = 1, 1024, 8, 64, 128, 256
    arrays = _ssd_inputs(7, b, s, h, p, n)
    x, dt, a, bm, cm, h0 = (torch.from_numpy(t) for t in arrays)
    x, bm, cm = _bf16(x), _bf16(bm), _bf16(cm)
    y_r, f_r = ref.ssd_ref(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    scale = float(y_r.abs().max())
    for split_x in (True, False):
        y, f = _tc_emulation(x, dt, a, bm[:, :, 0], cm[:, :, 0], h0, chunk,
                             split_x)
        assert float((y - y_r).abs().max()) / scale < 1e-2
        assert torch.allclose(f, f_r, atol=2e-3, rtol=1e-4) == split_x


def test_cpu_ssd_leaves_the_counts_alone():
    """On CPU tensors ops.ssd takes the plain version: no count moves."""
    x, dt, a, bm, cm, h0 = (torch.from_numpy(t)
                            for t in _ssd_inputs(0, 1, 64, 2, 64, 64))
    before = (ss.launches, dict(ss.variant_launches),
              dict(ss.phase_launches))
    ops.ssd(x.to(BF16), dt, a, bm.to(BF16), cm.to(BF16), chunk=64, h0=h0)
    assert (ss.launches, ss.variant_launches, ss.phase_launches) == before
    assert set(ss.variant_launches) == set(ss.VARIANTS)


def test_tc_entry_points_refuse_cpu_tensors():
    x, dt, a, bm, cm, h0 = (torch.from_numpy(t)
                            for t in _ssd_inputs(1, 1, 64, 2, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        ss.tc_states(x.to(BF16), dt, a, bm.to(BF16), chunk=64, h0=h0)
    with pytest.raises(ValueError, match="CUDA"):
        ss.tc_outputs(x.to(BF16), bm.to(BF16), cm.to(BF16), x, x, chunk=64)


# -- simt's split-TF32 twin ------------------------------------------------------
#
# ref.ssd_x3_ref repeats the simt forward's arithmetic (csrc/ssd_simt.cuh):
# every product taken as the three split-TF32 products of fp32 operands and
# dacum as the kernels' serial fused sum.  In f32 it is held to the plain
# forward and to the reference's ssd_ref at the f32 limits, on the
# reference's grid and at full per-head widths (P 64, N 64 and 128, chunk
# 256): whether split-TF32 meets them, before a card.

X3_GRID = [row[:6] for row in JAX_GRID] + [(1, 512, 3, 64, 64, 256),
                                           (1, 512, 3, 64, 128, 256)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", X3_GRID)
def test_ssd_x3_ref_meets_the_f32_limits(b, s, h, p, n, chunk):
    """y within 2e-5 of max|y| and the final state at atol 2e-3 / rtol 1e-4
    against ref.ssd_ref and repro's ssd_ref; not their bits."""
    arrays = _ssd_inputs(s + h + 1, b, s, h, p, n)
    x, dt, a, bm, cm, h0 = (torch.from_numpy(t) for t in arrays)
    y, final = ref.ssd_x3_ref(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    y_p, f_p = ref.ssd_ref(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    y_j, f_j = jref.ssd_ref(*(jnp.asarray(t) for t in arrays[:5]),
                            chunk=chunk, h0=jnp.asarray(arrays[5]))
    for want_y, want_f in ((y_p, f_p), (torch.from_numpy(np.array(y_j)),
                                        torch.from_numpy(np.array(f_j)))):
        scale = float(want_y.abs().max()) + 1e-9
        assert float((y - want_y).abs().max()) / scale < 2e-5
        torch.testing.assert_close(final, want_f, atol=2e-3, rtol=1e-4)
    assert not torch.equal(y, y_p)
