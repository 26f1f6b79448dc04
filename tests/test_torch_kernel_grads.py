"""The plain versions of the backward kernels, held to autograd and to JAX.

``ref.sdpa_bwd_ref`` and ``ref.ssd_bwd_ref`` mirror the phases of the
flash and SSD backward kernels (``csrc/flash_backward.cuh``,
``csrc/ssd_backward.cuh``).  Here, in f32 on the CPU, each is held to
``torch.autograd`` of its plain forward (``ref.sdpa_ref``,
``ref.ssd_ref``) and to ``jax.vjp`` of the reference's plain function
(``repro.kernels.ref``), within 2e-5 (attention) or 1e-4 (SSD) of each
input's largest |gradient|.  Inputs are made with numpy from a seed.  The
kernels themselves run only on a card (``test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

ATTN_TOL = 2e-5
SSD_TOL = 1e-4


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (B, Sq, Skv, Hq, Hkv, Dk, Dv, causal, window, softcap, scale, kv): kv is
# "dense" (positions 0..Skv-1, queries at the end), "padded" (the last
# quarter of the keys at 2^30, ring padding) or "ragged" (each batch row's
# queries at its own offset)
ATTN_GRID = [
    (2, 24, 24, 4, 4, 16, 16, True, None, 0.0, None, "dense"),
    (2, 24, 24, 4, 2, 16, 16, False, None, 0.0, None, "dense"),
    (1, 32, 32, 4, 1, 16, 16, True, 8, 0.0, None, "dense"),
    (2, 20, 20, 4, 2, 16, 16, True, None, 20.0, None, "dense"),
    (2, 16, 40, 4, 2, 24, 16, True, None, 0.0, 0.3, "dense"),
    (1, 28, 28, 8, 2, 24, 16, True, 12, 30.0, None, "dense"),
    (2, 12, 48, 4, 4, 16, 16, True, None, 0.0, None, "padded"),
    (2, 12, 48, 4, 2, 16, 8, False, None, 0.0, None, "padded"),
    (3, 10, 30, 4, 2, 12, 20, True, None, 0.0, None, "ragged"),
    (3, 10, 30, 2, 1, 16, 16, True, 6, 10.0, 0.2, "ragged"),
]


def _attn_inputs(seed, b, sq, skv, hq, hkv, dk, dv, kv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, dk)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dk)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    dout = rng.standard_normal((b, sq, hq, dv)).astype(np.float32)
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    if kv == "ragged":
        ends = rng.integers(sq, skv + 1, b)         # each row's depth
        qp = (ends[:, None] - sq + np.arange(sq)[None]).astype(np.int32)
    else:
        visible = skv - skv // 4 if kv == "padded" else skv
        qp = np.broadcast_to(np.arange(visible - sq, visible,
                                       dtype=np.int32), (b, sq)).copy()
        kp[:, visible:] = 2 ** 30
    return q, k, v, dout, qp, kp


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dk,dv,causal,window,cap,scale,kv",
                         ATTN_GRID)
def test_sdpa_bwd_ref_matches_autograd_and_jax(b, sq, skv, hq, hkv, dk, dv,
                                               causal, window, cap, scale,
                                               kv):
    """dq, dk, dv of ref.sdpa_bwd_ref (from the forward's output and lse)
    against autograd of ref.sdpa_ref and jax.vjp of the reference's
    sdpa_ref: causal and bidirectional, a window, a softcap, an explicit
    scale, GQA groups of 1, 2 and 4, Dk != Dv, padded kv positions and
    per-row query offsets."""
    q, k, v, dout, qp, kp = _attn_inputs(sq * skv + dk, b, sq, skv, hq, hkv,
                                         dk, dv, kv)
    kw = dict(causal=causal, sliding_window=window, logit_softcap=cap,
              scale=scale)
    t = torch.from_numpy
    pos = dict(q_positions=t(qp), kv_positions=t(kp))
    out, lse = ref.sdpa_ref(t(q), t(k), t(v), return_lse=True, **pos, **kw)
    got = ref.sdpa_bwd_ref(t(q), t(k), t(v), out, lse, t(dout), **pos, **kw)

    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    auto = torch.autograd.grad(ref.sdpa_ref(*leaves, **pos, **kw), leaves,
                               t(dout))
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.sdpa_ref(
        q_, k_, v_, q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp),
        **kw), *(jnp.asarray(a) for a in (q, k, v)))
    want_jax = vjp(jnp.asarray(dout))
    for name, g, a, j in zip("qkv", got, auto, want_jax):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        assert _rel_err(g, a) <= ATTN_TOL, name
        assert _rel_err(g, j) <= ATTN_TOL, name


def test_sdpa_bwd_ref_rounds_once_to_the_inputs_dtype():
    """In bf16 the gradients come back in bf16, each the fp32 gradient
    rounded once."""
    q, k, v, dout, qp, kp = _attn_inputs(5, 2, 16, 16, 4, 2, 16, 16,
                                         "dense")
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    pos = dict(q_positions=torch.from_numpy(qp),
               kv_positions=torch.from_numpy(kp))
    out, lse = ref.sdpa_ref(t(q), t(k), t(v), return_lse=True, **pos)
    got = ref.sdpa_bwd_ref(t(q), t(k), t(v), out, lse, t(dout), **pos)
    wide = ref.sdpa_bwd_ref(*(x.float() for x in (t(q), t(k), t(v), out)),
                            lse, t(dout).float(), **pos)
    for g, w in zip(got, wide):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def _hidden_rows(qp, kp, causal, window):
    """[B, Sq] True where a query row sees no key."""
    mask = ref.attn_mask(torch.from_numpy(qp), torch.from_numpy(kp), causal,
                         window)
    return ~mask.any(dim=-1)


@pytest.mark.parametrize("hq,hkv,window", [(4, 2, None), (4, 4, 6)])
def test_sdpa_bwd_ref_gives_rows_that_see_no_key_no_gradient(hq, hkv,
                                                             window):
    """Queries before every key (rows 0-7 see none): the plain forward
    spreads such a row evenly over all Skv keys (lse NEG_INF + log Skv,
    output the mean of V), so autograd sends dout / Skv of it into every
    key's dV.  The kernels give such a row no weight in a merge (lse at
    most NEG_INF / 2, output not defined), and ref.sdpa_bwd_ref, like the
    backward kernels, no gradient: dq and dk equal autograd's, and dv
    equals autograd's less that even share, exactly that and no more."""
    b, sq, skv, d = 2, 16, 24, 16
    rng = np.random.default_rng(7 + hq + hkv)
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32)
                     for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                                   (b, skv, hkv, d), (b, sq, hq, d)))
    qp = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy()
    kp = np.broadcast_to(np.arange(8, 8 + skv, dtype=np.int32),
                         (b, skv)).copy()
    hidden = _hidden_rows(qp, kp, True, window)
    assert hidden[:, :8].all() and not hidden[:, 8:].any()
    t = torch.from_numpy
    kw = dict(q_positions=t(qp), kv_positions=t(kp), causal=True,
              sliding_window=window)
    out, lse = ref.sdpa_ref(t(q), t(k), t(v), return_lse=True, **kw)
    rows = hidden[:, :, None].expand(b, sq, hq)
    assert bool((lse[rows] <= ref.NEG_INF / 2).all())
    mean_v = t(v).mean(dim=1).repeat_interleave(hq // hkv, dim=1)
    torch.testing.assert_close(out[hidden], mean_v[:, None].expand(
        b, sq, hq, d)[hidden], atol=1e-6, rtol=1e-6)
    got = ref.sdpa_bwd_ref(t(q), t(k), t(v), out, lse, t(dout), **kw)
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    auto = torch.autograd.grad(ref.sdpa_ref(*leaves, **kw), leaves, t(dout))
    assert float(got[0][hidden].abs().max()) == 0.0
    assert _rel_err(got[0], auto[0]) <= ATTN_TOL
    assert _rel_err(got[1], auto[1]) <= ATTN_TOL
    spread = (t(dout) * hidden[:, :, None, None]).sum(dim=1) / skv
    spread = spread.reshape(b, hkv, hq // hkv, d).sum(dim=2)
    assert _rel_err(got[2], auto[2]) > ATTN_TOL
    assert _rel_err(got[2] + spread[:, None], auto[2]) <= ATTN_TOL


@pytest.mark.parametrize("hq,hkv,window", [(4, 2, None), (4, 4, 12)])
def test_lse_merge_over_key_chunks_equals_the_whole_call(hq, hkv, window):
    """The seq-sharded merge (``attention.lse_merge``) of the plain version
    over three key chunks, where rows 0-7 see no key of the second chunk
    and no row sees one of the third, equals one call over all the keys
    within 2e-5.  It does so as well with what the kernels write on such
    rows (lse NEG_INF + log of the hidden keys a tile held, or -inf; any
    output); one chunk comes back bit for bit."""
    from repro_torch.models.attention import lse_merge

    b, sq, skv, d = 2, 16, 48, 16
    rng = np.random.default_rng(11 + hkv)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                             (b, skv, hkv, d)))
    qp = np.broadcast_to(np.arange(8, 8 + sq, dtype=np.int32), (b, sq)).copy()
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    kw = dict(causal=True, sliding_window=window)
    want = ref.sdpa_ref(q, k, v, q_positions=torch.from_numpy(qp),
                        kv_positions=torch.from_numpy(kp), **kw)
    outs, lses, kernel_outs, kernel_lses = [], [], [], []
    for c in range(3):
        cut = slice(16 * c, 16 * (c + 1))
        out, lse = ref.sdpa_ref(q, k[:, cut], v[:, cut], return_lse=True,
                                q_positions=torch.from_numpy(qp),
                                kv_positions=torch.from_numpy(kp[:, cut]),
                                **kw)
        hidden = _hidden_rows(qp, kp[:, cut], True, window)
        assert bool(hidden.all()) == (c == 2)
        assert bool(hidden[:, :8].all()) or c == 0
        rows = hidden[:, :, None].expand(b, sq, hq)
        outs.append(out)
        lses.append(lse)
        kernel_outs.append(torch.where(rows[..., None], 7.0, out))
        kernel_lses.append(torch.where(
            rows, -torch.inf if c == 2 else ref.NEG_INF + 1.6, lse))
    for o, l in ((outs, lses), (kernel_outs, kernel_lses)):
        merged = lse_merge(torch.stack(o), torch.stack(l))
        torch.testing.assert_close(merged, want, atol=2e-5, rtol=2e-5)
    assert torch.equal(lse_merge(outs[0][None], lses[0][None]), outs[0])


# (B, S, H, P, N, chunk, h0, dfinal)
SSD_GRID = [
    (2, 64, 3, 8, 16, 16, True, True),
    (2, 64, 3, 8, 16, 16, False, False),
    (1, 96, 4, 16, 8, 32, True, False),
    (2, 32, 2, 4, 12, 32, False, True),
]


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (f(b, s, h, p) * 0.5,
            np.log1p(np.exp(f(b, s, h))).astype(np.float32),
            (-np.exp(f(h) * 0.3)).astype(np.float32),
            f(b, s, 1, n) * 0.4, f(b, s, 1, n) * 0.4, f(b, h, p, n) * 0.1,
            f(b, s, h, p), f(b, h, p, n))


def _jax_ssd_vjp(x, dt, a, bm, cm, h0, dy, dfinal, chunk, s):
    """jax.vjp of the reference's ssd_ref, S zero-padded to the chunk
    inside the function (as ops.ssd pads) and y cut back to S."""
    pad = (-s) % chunk

    def fn(x_, dt_, a_, b_, c_, *h):
        padded = [jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
                  for t in (x_, dt_, b_, c_)]
        y, final = jref.ssd_ref(padded[0], padded[1], a_, padded[2],
                                padded[3], chunk=chunk,
                                h0=h[0] if h else None)
        return y[:, :s], final

    args = [jnp.asarray(t) for t in (x, dt, a, bm, cm)]
    if h0 is not None:
        args.append(jnp.asarray(h0))
    _, vjp = jax.vjp(fn, *args)
    return vjp((jnp.asarray(dy), jnp.asarray(dfinal)))


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,with_dfinal", SSD_GRID)
def test_ssd_bwd_ref_matches_autograd_and_jax(b, s, h, p, n, chunk, with_h0,
                                              with_dfinal):
    """dx, ddt, dA, dB, dC (and dh0) of ref.ssd_bwd_ref against autograd of
    ref.ssd_ref and jax.vjp of the reference's ssd_ref, with and without
    h0 and the final state's gradient."""
    x, dt, a, bm, cm, h0, dy, dfinal = _ssd_inputs(s + h + n, b, s, h, p, n)
    h0 = h0 if with_h0 else None
    dfinal = dfinal if with_dfinal else np.zeros_like(dfinal)
    t = torch.from_numpy
    got = ref.ssd_bwd_ref(t(x), t(dt), t(a), t(bm), t(cm),
                          None if h0 is None else t(h0), t(dy),
                          t(dfinal) if with_dfinal else None, chunk=chunk)
    ins = [t(v).requires_grad_(True) for v in (x, dt, a, bm, cm)
           + (() if h0 is None else (h0,))]
    y, final = ref.ssd_ref(*ins[:5], chunk=chunk,
                           h0=ins[5] if h0 is not None else None)
    auto = torch.autograd.grad([y, final], ins, [t(dy), t(dfinal)])
    want_jax = _jax_ssd_vjp(x, dt, a, bm, cm, h0, dy, dfinal, chunk, s)
    for name, g, au, j in zip(("x", "dt", "a", "b", "c", "h0"), got, auto,
                              want_jax):
        assert g.shape == au.shape, name
        assert _rel_err(g, au) <= SSD_TOL, name
        assert _rel_err(g, j) <= SSD_TOL, name


def test_ssd_bwd_ref_through_ops_padding_matches_autograd_and_jax():
    """A ragged S: ref.ssd_bwd_ref on ops.ssd's zero-padded inputs, cut
    back to S, against autograd through ops.ssd (plain) and jax.vjp of
    the padded reference."""
    b, s, h, p, n, chunk = 2, 50, 3, 8, 16, 16
    x, dt, a, bm, cm, h0, dy, dfinal = _ssd_inputs(9, b, s, h, p, n)
    t = torch.from_numpy
    pad = (-s) % chunk
    padded = [ref.pad_seq(t(v), pad) for v in (x, dt, bm, cm, dy)]
    got = ref.ssd_bwd_ref(padded[0], padded[1], t(a), padded[2], padded[3],
                          t(h0), padded[4], t(dfinal), chunk=chunk)
    got = [g[:, :s] if i in (0, 1, 3, 4) else g for i, g in enumerate(got)]
    ins = [t(v).requires_grad_(True) for v in (x, dt, a, bm, cm, h0)]
    y, final = ops.ssd(*ins[:5], chunk=chunk, h0=ins[5], plain=True)
    auto = torch.autograd.grad([y, final], ins, [t(dy), t(dfinal)])
    want_jax = _jax_ssd_vjp(x, dt, a, bm, cm, h0, dy, dfinal, chunk, s)
    for name, g, au, j in zip(("x", "dt", "a", "b", "c", "h0"), got, auto,
                              want_jax):
        assert g.shape == au.shape, name
        assert _rel_err(g, au) <= SSD_TOL, name
        assert _rel_err(g, j) <= SSD_TOL, name


# -- the simt backward's split-TF32 twin ---------------------------------------
#
# ref.sdpa_bwd_x3_ref repeats the simt backward's arithmetic
# (csrc/flash_backward.cuh): every product, P and dS included, taken as the
# three split-TF32 products of fp32 operands.  In f32 it is held to the plain
# backward and to jax.vjp of the reference's plain function within ATTN_TOL
# of each input's largest |gradient|, on ATTN_GRID and at MLA's (192, 128)
# at a small depth: whether split-TF32 meets the f32 limit, before a card.

X3_ATTN_GRID = ATTN_GRID + [
    (1, 48, 48, 4, 4, 192, 128, True, None, 0.0, None, "dense"),
    (2, 24, 40, 4, 2, 192, 128, True, 16, 30.0, None, "padded"),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dk,dv,causal,window,cap,scale,kv",
                         X3_ATTN_GRID)
def test_sdpa_bwd_x3_ref_meets_the_f32_limit(b, sq, skv, hq, hkv, dk, dv,
                                             causal, window, cap, scale, kv):
    q, k, v, dout, qp, kp = _attn_inputs(sq * skv + dk + 1, b, sq, skv, hq,
                                         hkv, dk, dv, kv)
    kw = dict(causal=causal, sliding_window=window, logit_softcap=cap,
              scale=scale)
    t = torch.from_numpy
    pos = dict(q_positions=t(qp), kv_positions=t(kp))
    out, lse = ref.sdpa_ref(t(q), t(k), t(v), return_lse=True, **pos, **kw)
    got = ref.sdpa_bwd_x3_ref(t(q), t(k), t(v), out, lse, t(dout), **pos,
                              **kw)
    plain = ref.sdpa_bwd_ref(t(q), t(k), t(v), out, lse, t(dout), **pos,
                             **kw)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.sdpa_ref(
        q_, k_, v_, q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp),
        **kw), *(jnp.asarray(a) for a in (q, k, v)))
    want_jax = vjp(jnp.asarray(dout))
    for name, g, p, j in zip("qkv", got, plain, want_jax):
        assert g.dtype == torch.float32 and g.shape == p.shape, name
        assert _rel_err(g, p) <= ATTN_TOL, name
        assert _rel_err(g, j) <= ATTN_TOL, name
    assert not all(torch.equal(g, p) for g, p in zip(got, plain))


# ref.ssd_bwd_x3_ref repeats the SSD simt backward's arithmetic
# (csrc/ssd_backward.cuh): every product split-TF32, dacum the kernels'
# serial fused sum.  In f32 its gradients are held to the plain backward and
# to jax.vjp of the reference's plain function within SSD_TOL of each
# input's largest, on SSD_GRID and at full per-head widths (P 64, N 64 and
# 128, chunk 256); dA, a sum with heavy cancellation whose f32 evaluations
# (plain or twin) differ from each other and from its fp64 value by up to
# about SSD_TOL, is held to an fp64 evaluation of ref.ssd_bwd_ref instead.

X3_SSD_GRID = SSD_GRID + [(1, 512, 3, 64, 64, 256, True, True),
                          (1, 512, 3, 64, 128, 256, True, True)]


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,with_dfinal", X3_SSD_GRID)
def test_ssd_bwd_x3_ref_meets_the_f32_limit(b, s, h, p, n, chunk, with_h0,
                                            with_dfinal):
    x, dt, a, bm, cm, h0, dy, dfinal = _ssd_inputs(s + h + n + 1, b, s, h,
                                                   p, n)
    h0 = h0 if with_h0 else None
    dfinal = dfinal if with_dfinal else np.zeros_like(dfinal)
    t = lambda v: None if v is None else torch.from_numpy(v)
    args = (t(x), t(dt), t(a), t(bm), t(cm), t(h0), t(dy),
            t(dfinal) if with_dfinal else None)
    got = ref.ssd_bwd_x3_ref(*args, chunk=chunk)
    plain = ref.ssd_bwd_ref(*args, chunk=chunk)
    truth = ref.ssd_bwd_ref(*(None if v is None else v.double()
                              for v in args), chunk=chunk)
    want_jax = _jax_ssd_vjp(x, dt, a, bm, cm, h0, dy, dfinal, chunk, s)
    for name, g, pl, tr, j in zip(("x", "dt", "a", "b", "c", "h0"), got,
                                  plain, truth, want_jax):
        assert g.dtype == pl.dtype and g.shape == pl.shape, name
        if name == "a":
            assert _rel_err(g, tr) <= SSD_TOL
            continue
        assert _rel_err(g, pl) <= SSD_TOL, name
        assert _rel_err(g, j) <= SSD_TOL, name
    assert not all(torch.equal(g, p) for g, p in zip(got, plain))


# -- the tensor-core backwards' plain twins ------------------------------------
#
# ref.sdpa_bwd_tc_ref and ref.ssd_bwd_tc_ref repeat the tc kernels' roundings
# (csrc/flash_backward_tc.cuh, csrc/ssd_backward_tc.cuh): P and dS, or the
# CB * M and dCB tiles, each rounded once to bf16 before its product.  On
# bf16 inputs each is held, within 2e-2 of each input's largest |gradient|
# (the card's bf16 limit), to the fp32 plain backward on the same inputs and
# to jax.vjp of the reference's plain function on those inputs widened to
# f32.

TC_TOL = 2e-2


def _bf16_np(a):
    """``a`` rounded to bf16, as float32 numpy (the inputs both sides see)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# (B, S, Hq, Hkv, Dk, Dv, window, softcap, q offset): each (Dk, Dv) of the
# tc set, GQA groups of 1, 4 and 16, a window with a softcap, and queries
# placed before every key (rows 0-7 see none); MLA's (192, 128) over MHA, a
# GQA group of 4 and queries before every key
TC_ATTN_GRID = [
    (2, 80, 4, 4, 64, 64, None, 0.0, 0),
    (1, 72, 4, 1, 80, 80, None, 0.0, 0),
    (1, 80, 8, 2, 128, 128, None, 0.0, 0),
    (1, 96, 16, 1, 64, 64, None, 0.0, 0),
    (1, 80, 4, 2, 128, 128, 24, 30.0, 0),
    (2, 72, 4, 2, 64, 64, None, 0.0, -8),
    (1, 72, 4, 4, 192, 128, None, 0.0, 0),
    (1, 80, 8, 2, 192, 128, None, 0.0, 0),
    (2, 72, 4, 4, 192, 128, None, 0.0, -8),
]


@pytest.mark.parametrize("b,s,hq,hkv,dk,dv,window,cap,offset", TC_ATTN_GRID)
def test_sdpa_bwd_tc_ref_matches_plain_and_jax(b, s, hq, hkv, dk, dv, window,
                                               cap, offset):
    """dq, dk, dv of the tc twin (bf16 P and dS) against the fp32 plain
    backward and jax.vjp of the reference's sdpa_ref, within 2e-2.  Rows
    that see no key get no gradient from either backward; jax spreads dout
    / Skv of each such row into every key's dV, which the comparison adds
    back (as test_sdpa_bwd_ref_gives_rows_that_see_no_key_no_gradient)."""
    rng = np.random.default_rng(b * s + hq + dk)
    q, k, v, dout = (_bf16_np(rng.standard_normal(shape).astype(np.float32))
                     for shape in ((b, s, hq, dk), (b, s, hkv, dk),
                                   (b, s, hkv, dv), (b, s, hq, dv)))
    kp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    qp = kp + offset
    kw = dict(causal=True, sliding_window=window, logit_softcap=cap)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    pos = dict(q_positions=torch.from_numpy(qp),
               kv_positions=torch.from_numpy(kp))
    out, lse = ref.sdpa_ref(t(q), t(k), t(v), return_lse=True, **pos, **kw)
    got = ref.sdpa_bwd_tc_ref(t(q), t(k), t(v), out, lse, t(dout), **pos,
                              **kw)
    plain = ref.sdpa_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                             out.float(), lse, torch.from_numpy(dout), **pos,
                             **kw)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.sdpa_ref(
        q_, k_, v_, q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp),
        **kw), *(jnp.asarray(a) for a in (q, k, v)))
    want_jax = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    hidden = _hidden_rows(qp, kp, True, window)
    assert bool(hidden.any()) == (offset < 0)
    spread = (torch.from_numpy(dout) * hidden[:, :, None, None]).sum(1) / s
    spread = spread.reshape(b, hkv, hq // hkv, dv).sum(2)[:, None].numpy()
    for i, (g, p, j) in enumerate(zip(got, plain, want_jax)):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
        assert _rel_err(g.float(), p) <= TC_TOL, i
        if i == 2:
            j = j - spread
        assert _rel_err(g.float(), j) <= TC_TOL, i


def test_sdpa_bwd_tc_ref_rounds_p_and_ds_to_bf16():
    """The twin differs from the fp32 plain backward by the bf16 rounding
    of P and dS alone: with P and dS exact in bf16 (every key visible to
    every row at a uniform score, dO = 1 and V = 0 except one column) the
    two agree to fp32 rounding."""
    b, s, h, d = 1, 64, 2, 64
    q = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    k = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    v = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    v[..., 0] = 1.0
    dout = torch.ones((b, s, h, d), dtype=torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32)[None]
    kw = dict(q_positions=pos, kv_positions=pos, causal=False)
    out, lse = ref.sdpa_ref(q, k, v, return_lse=True, **kw)
    got = ref.sdpa_bwd_tc_ref(q, k, v, out, lse, dout, **kw)
    plain = ref.sdpa_bwd_ref(q, k, v, out, lse, dout, **kw)
    for g, p in zip(got, plain):
        torch.testing.assert_close(g.float(), p.float(), atol=1e-6, rtol=0)


# (B, S, H, N, chunk, h0, dfinal): N 64 (two heads a chunk_tc block) and
# 128, with and without h0 and the final state's gradient; P = 64
TC_SSD_GRID = [
    (2, 128, 2, 64, 64, True, True),
    (1, 128, 3, 64, 64, False, True),
    (1, 256, 2, 128, 128, True, True),
    (2, 128, 1, 128, 64, True, False),
]


@pytest.mark.parametrize("b,s,h,n,chunk,with_h0,with_dfinal", TC_SSD_GRID)
def test_ssd_bwd_tc_ref_matches_plain_and_jax(b, s, h, n, chunk, with_h0,
                                              with_dfinal):
    """dx, ddt, dA, dB, dC and dh0 of the tc twin (bf16 entering states, G,
    CB * M and dCB tiles) against the fp32 plain backward and jax.vjp of
    the reference's ssd_ref, within 2e-2."""
    x, dt, a, bm, cm, h0, dy, dfinal = _ssd_inputs(s + h + n, b, s, h, 64, n)
    x, bm, cm, dy = (_bf16_np(t) for t in (x, bm, cm, dy))
    h0 = h0 if with_h0 else None
    dfinal = dfinal if with_dfinal else np.zeros_like(dfinal)
    t = torch.from_numpy
    bf = lambda a_: t(a_).to(torch.bfloat16)
    args = (None if h0 is None else t(h0), bf(dy),
            t(dfinal) if with_dfinal else None)
    got = ref.ssd_bwd_tc_ref(bf(x), t(dt), t(a), bf(bm), bf(cm), *args,
                             chunk=chunk)
    plain = ref.ssd_bwd_ref(t(x), t(dt), t(a), t(bm), t(cm), args[0], t(dy),
                            args[2], chunk=chunk)
    want_jax = _jax_ssd_vjp(x, dt, a, bm, cm, h0, dy, dfinal, chunk, s)
    for name, g, p, j in zip(("x", "dt", "a", "b", "c", "h0"), got, plain,
                             want_jax):
        assert g.shape == p.shape, name
        assert _rel_err(g.float(), p) <= TC_TOL, name
        assert _rel_err(g.float(), j) <= TC_TOL, name


def _launcher_body(source: str, fn: str) -> str:
    """The body of C function ``fn`` in ``csrc/<source>``."""
    from repro_torch.kernels.nvcc import CSRC

    text = (CSRC / source).read_text()
    start = text.index("{", text.index(f" {fn}("))
    depth, i = 0, start
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i]
        i += 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_variant_follows_the_launcher_rule(dtype):
    """flash_attention.backward_variant() on a grid of shapes against the
    launcher's rule (choose_backward_variant in csrc/flash_attention.cu,
    whose (Dk, Dv) pairs are read from the source): tc for bf16 at those
    pairs with more than 64 q rows per kv head, simt elsewhere; every tc
    shape's forward is prefill_tc, so the saved lse comes from it."""
    import re

    from repro_torch.kernels import flash_attention as fa

    body = _launcher_body("flash_attention.cu", "choose_backward_variant")
    pairs = {(int(a), int(b)) for a, b in
             re.findall(r"Dk == (\d+) && Dv == (\d+)", body)}
    assert pairs == set(fa.BACKWARD_TC_DIMS)
    assert "decode_split::kMaxRows" in body and fa.DECODE_MAX_ROWS == 64
    dims = [(64, 64), (80, 80), (128, 128), (192, 128), (32, 48), (256, 256)]
    seen = set()
    for (dk, dv) in dims:
        for sq, hq, hkv in ((1, 32, 2), (4, 16, 1), (5, 16, 1), (64, 4, 4),
                            (65, 4, 4), (2048, 32, 32), (2048, 32, 2)):
            got = fa.backward_variant(dtype, sq, hq, hkv, dk, dv)
            want = ("tc" if dtype == torch.bfloat16 and (dk, dv) in pairs
                    and sq * (hq // hkv) > 64 else "simt")
            assert got == want, (dk, dv, sq, hq, hkv)
            if got == "tc":
                assert fa.variant(dtype, sq, hq, hkv, dk, dv) == "prefill_tc"
            seen.add(got)
    assert seen == ({"tc", "simt"} if dtype == torch.bfloat16 else {"simt"})


def test_deepseek_depth_one_trains_its_mla_on_the_tc_backward():
    """deepseek-v2-236b at full width cut to one layer (the train_mla cell
    of chip_smoke) is one dense MLA layer: attention at Dk 192, Dv 128 with
    as many kv heads as q heads, and its 12288-wide MLP.  In bf16 its
    attention takes prefill_tc forward and the tc backward, both at 2 x
    2048 tokens and at train_mla_held's 1 x 512; in f32 both are simt."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.common import layer_plan

    cfg = dataclasses.replace(configs.get_config("deepseek-v2-236b"),
                              n_layers=1)
    plan = layer_plan(cfg)
    assert [(k.mixer, k.ffn) for k in plan.kinds] == [("attn", "dense")]
    assert plan.prefix == 1 and plan.n_groups == 0
    assert cfg.moe.d_first_dense == 12288
    m = cfg.mla
    dk, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    assert (dk, dv) == (192, 128) and (dk, dv) in fa.BACKWARD_TC_DIMS
    h = cfg.n_heads
    for s in (2048, 512):
        assert fa.variant(torch.bfloat16, s, h, h, dk, dv) == "prefill_tc"
        assert fa.backward_variant(torch.bfloat16, s, h, h, dk, dv) == "tc"
        assert fa.backward_variant(torch.float32, s, h, h, dk, dv) == "simt"
    assert 1.3e9 < cfg.param_count() < 1.45e9


@pytest.mark.parametrize("b,hkv,skv,group,want", [
    (2, 32, 2048, 1, (1, 1)),      # zamba2: 2048 blocks, no split
    (1, 2, 2048, 16, (4, 4)),      # glm4's GQA: 64 blocks -> 4 shares of 4
    (1, 8, 2048, 2, (2, 1)),       # a window case: 256 blocks -> 2 shares
    (1, 2, 160, 16, (16, 1)),      # a small GQA call: one head a share
    (1, 4, 4096, 8, (2, 4)),
])
def test_flash_backward_splits_cover_the_group(b, hkv, skv, group, want):
    """dkdv_tc's shares of a GQA group (backward_splits, the twin of the
    launcher's splits_for): one while B x Hkv x 64-key tiles fills two
    waves of 132 SMs; every head in exactly one share; the tc scratch
    holds the shares' fp32 partials only when there are several."""
    from repro_torch.kernels import flash_attention as fa

    shares, per = fa.backward_splits(b, hkv, skv, group)
    assert (shares, per) == want
    assert (shares - 1) * per < group <= shares * per
    rows = b * skv * hkv * group
    extra = fa.backward_scratch_floats("tc", b, skv, skv, hkv * group, hkv,
                                       128, 128) - (-(-rows // 4) * 4)
    assert extra == (0 if shares == 1 else shares * b * skv * hkv * 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_backward_variant_follows_the_forward(dtype):
    """ssd_scan.backward_variant() equals the forward's variant() on a grid
    of shapes (the launcher takes choose_variant for both), and the tc
    scratch plan's dB / dC partials are per chunk_tc head group (two heads
    at N 64 when H is even); simt's groups are two heads in bf16 at N <=
    64, one otherwise."""
    from repro_torch.kernels import ssd_scan as ss

    body = _launcher_body("ssd_scan.cu", "ssd_scan_backward_launch")
    assert "choose_variant(dtype, P, N, L)" in body
    for p in (16, 64):
        for n in (32, 64, 128):
            for chunk in (32, 64, 128, 192, 256, 512):
                got = ss.backward_variant(dtype, p, n, chunk)
                assert got == ss.variant(dtype, p, n, chunk)
                assert got == ("tc" if dtype == torch.bfloat16 and p == 64
                               and n in (64, 128) and chunk % 64 == 0
                               and chunk <= 256 else "simt")
    assert [ss.backward_heads_per_block(n, h) for n, h in
            ((64, 64), (64, 3), (128, 48), (128, 1))] == [2, 1, 1, 1]
    assert [ss.simt_backward_heads(n, d) for n, d in
            ((64, torch.bfloat16), (32, torch.bfloat16),
             (128, torch.bfloat16), (64, torch.float32))] == [2, 2, 1, 1]
    b, s, h, n, chunk = 2, 512, 6, 64, 256
    bch = b * (s // chunk) * h
    parts = ss.backward_scratch_floats("tc", b, s, h, 64, n, chunk,
                                       torch.bfloat16) \
        - (bch * 64 * n // 2 + bch * 2 * chunk + 2 * b * h * 64 * n
           + bch * 64 * n + 2 * (-(-bch // 4) * 4))
    assert parts == 2 * (bch // 2) * chunk * n
