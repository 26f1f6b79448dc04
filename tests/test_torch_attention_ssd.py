"""repro_torch's attention and SSD plain versions and dispatch, held to repro.

Inputs are made with numpy from a seed and handed to both packages; the
reference's Pallas kernels run in interpret mode off-TPU, as its own tests
run them.  The CUDA kernels themselves run only on a card: their tests are
in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import decoder

FLASH_GRID = [
    (2, 128, 128, 4, 2, 32, 32, True, None, 0.0, "float32"),
    (1, 100, 100, 4, 4, 16, 16, True, None, 0.0, "float32"),
    (2, 128, 128, 4, 2, 32, 32, True, 40, 0.0, "float32"),
    (2, 64, 192, 4, 2, 32, 32, True, None, 0.0, "float32"),     # cache
    (2, 128, 128, 4, 4, 32, 32, False, None, 0.0, "float32"),   # encoder
    (2, 128, 128, 8, 2, 64, 64, True, None, 30.0, "bfloat16"),
    (1, 256, 256, 2, 2, 192, 128, True, None, 0.0, "float32"),  # MLA dims
    (1, 256, 256, 2, 2, 192, 128, True, None, 0.0, "bfloat16"),  # prefill_tc
    (1, 72, 72, 2, 1, 24, 24, True, 16, 0.0, "float32"),        # odd sizes
]

SSD_GRID = [
    (2, 256, 8, 16, 32, 64, 4),
    (1, 128, 16, 64, 128, 32, 8),
    (2, 512, 48, 64, 128, 256, 8),
    (1, 64, 4, 32, 16, 64, 4),       # single chunk
]


def _flash_inputs(seed, b, sq, skv, hq, hkv, dk, dv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, dk)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dk)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    qp = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32)[None],
                         (b, sq)).copy()
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32)[None], (b, skv)).copy()
    return q, k, v, qp, kp


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dk,dv,causal,window,cap,dtype",
                         FLASH_GRID)
def test_sdpa_ref_matches_reference_and_pallas(b, sq, skv, hq, hkv, dk, dv,
                                               causal, window, cap, dtype):
    """ref.sdpa_ref == repro's sdpa_ref and its interpreted flash kernel,
    at the reference's own tolerances (2e-5 f32, 5e-2 bf16)."""
    q, k, v, qp, kp = _flash_inputs(sq + dk, b, sq, skv, hq, hkv, dk, dv)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    kw = dict(causal=causal, sliding_window=window, logit_softcap=cap)
    got = ref.sdpa_ref(tq, tk, tv, q_positions=torch.from_numpy(qp),
                       kv_positions=torch.from_numpy(kp), **kw)
    want = jref.sdpa_ref(jq, jk, jv, q_positions=jnp.asarray(qp),
                         kv_positions=jnp.asarray(kp), **kw)
    pallas = pallas_flash(jq, jk, jv, q_positions=jnp.asarray(qp),
                          kv_positions=jnp.asarray(kp), block_q=64,
                          block_k=64, **kw)
    assert got.dtype == td and got.shape == (b, sq, hq, dv)
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               atol=tol, rtol=tol)
    # the CPU dispatch point is the plain version itself
    via_ops = ops.attention(tq, tk, tv, q_positions=torch.from_numpy(qp),
                            kv_positions=torch.from_numpy(kp), **kw)
    np.testing.assert_array_equal(via_ops.float().numpy(), got)


@pytest.mark.parametrize("window,cap", [(None, 0.0), (40, 0.0), (None, 30.0)])
def test_sdpa_ref_lse_merges_kv_chunks(window, cap):
    """The plain version's log-sum-exp (decode_split's new output) is the
    reference's scores' logsumexp, and merging the attention of four kv
    chunks by it (the seq-sharded decode's combine) gives the attention
    over the whole ring, within f32 rounding."""
    b, skv, hq, hkv, d = 2, 128, 8, 2, 32
    q, k, v, _, kp = _flash_inputs(7, b, 1, skv, hq, hkv, d, d)
    qp = np.array([[skv - 1], [skv // 2]], np.int32)      # row 1 sees half
    kw = dict(causal=True, sliding_window=window, logit_softcap=cap)
    t = [torch.from_numpy(a) for a in (q, k, v, qp, kp)]
    out, lse = ref.sdpa_ref(t[0], t[1], t[2], q_positions=t[3],
                            kv_positions=t[4], return_lse=True, **kw)
    np.testing.assert_array_equal(
        out.numpy(), ref.sdpa_ref(t[0], t[1], t[2], q_positions=t[3],
                                  kv_positions=t[4], **kw).numpy())
    # the reference's masked scores, their logsumexp
    g = hq // hkv
    logits = jnp.einsum("bqhgd,bkhd->bhgqk", q.reshape(b, 1, hkv, g, d), k)
    logits = logits * d ** -0.5
    if cap:
        logits = cap * jnp.tanh(logits / cap)
    mask = jattn.attn_mask(jnp.asarray(qp), jnp.asarray(kp), True, window)
    logits = jnp.where(mask[:, None, None], logits, jattn.NEG_INF)
    want = jnp.moveaxis(jnp.log(jnp.sum(jnp.exp(
        logits - logits.max(-1, keepdims=True)), -1))
        + logits.max(-1), 3, 1).reshape(b, 1, hq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    parts = [ref.sdpa_ref(t[0], t[1][:, c:c + 32], t[2][:, c:c + 32],
                          q_positions=t[3], kv_positions=t[4][:, c:c + 32],
                          return_lse=True, **kw) for c in range(0, skv, 32)]
    lses = torch.stack([p[1] for p in parts])
    w = torch.exp(lses - lses.max(0).values)
    merged = (w[..., None] * torch.stack([p[0] for p in parts])).sum(0) \
        / w.sum(0)[..., None]
    np.testing.assert_allclose(merged.numpy(), out.numpy(), atol=2e-6)


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal((h,)) * 0.3).astype(np.float32)
    bm = (rng.standard_normal((b, s, 1, n)) * 0.4).astype(np.float32)
    cm = (rng.standard_normal((b, s, 1, n)) * 0.4).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("b,s,h,p,n,chunk,hb", SSD_GRID)
def test_ssd_ref_matches_reference_and_pallas(b, s, h, p, n, chunk, hb):
    """ref.ssd_ref == repro's ssd_ref and its interpreted SSD kernel:
    relative 2e-5 on y, atol 2e-3 / rtol 1e-4 on the final state."""
    arrays = _ssd_inputs(s + h, b, s, h, p, n)
    x, dt, a, bm, cm, h0 = (torch.from_numpy(t) for t in arrays)
    jx, jdt, ja, jbm, jcm, jh0 = (jnp.asarray(t) for t in arrays)
    y, f = ref.ssd_ref(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    y_r, f_r = jref.ssd_ref(jx, jdt, ja, jbm, jcm, chunk=chunk, h0=jh0)
    y_k, f_k = pallas_ssd(jx, jdt, ja, jbm, jcm, chunk=chunk, h0=jh0,
                          block_heads=hb)
    assert y.shape == (b, s, h, p) and f.shape == (b, h, p, n)
    for y_j, f_j in ((y_r, f_r), (y_k, f_k)):
        scale = float(jnp.max(jnp.abs(y_j))) + 1e-9
        assert float(np.max(np.abs(y.numpy() - np.asarray(y_j)))) / scale \
            < 2e-5
        np.testing.assert_allclose(f.numpy(), np.asarray(f_j), atol=2e-3,
                                   rtol=1e-4)


@pytest.mark.parametrize("s,chunk,with_h0", [(100, 32, True), (37, 64, False)])
def test_ops_ssd_pads_ragged_sequences(s, chunk, with_h0):
    """ops.ssd pads S up to a multiple of chunk as the reference's ref
    branch does (repro/models/ssm.py:216-227) and cuts y back to S."""
    b, h, p, n = 2, 4, 16, 8
    arrays = _ssd_inputs(s, b, s, h, p, n)
    x, dt, a, bm, cm, h0 = (torch.from_numpy(t) for t in arrays)
    y, f = ops.ssd(x, dt, a, bm, cm, chunk=chunk,
                   h0=h0 if with_h0 else None)
    pad = (-s) % chunk
    jx, jdt, ja, jbm, jcm, jh0 = (jnp.asarray(t) for t in arrays)
    padw = lambda t: jnp.pad(t, ((0, 0), (0, pad)) + ((0, 0),) * (t.ndim - 2))
    y_r, f_r = jssd_chunked(padw(jx), padw(jdt), ja, padw(jbm), padw(jcm),
                            chunk, h0=jh0 if with_h0 else None,
                            return_final_state=True)
    assert y.shape == (b, s, h, p)
    scale = float(jnp.max(jnp.abs(y_r))) + 1e-9
    assert float(np.max(np.abs(y.numpy() - np.asarray(y_r[:, :s])))) \
        / scale < 2e-5
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), atol=2e-3,
                               rtol=1e-4)


def test_segsum_and_recurrent_step_match_reference():
    from repro.models.ssm import segsum as jsegsum
    from repro.models.ssm import ssd_recurrent_step as jstep
    from repro_torch.models.ssm import segsum, ssd_recurrent_step

    rng = np.random.default_rng(5)
    la = rng.standard_normal((3, 12)).astype(np.float32)
    np.testing.assert_allclose(segsum(torch.from_numpy(la)).numpy(),
                               np.asarray(jsegsum(jnp.asarray(la))),
                               rtol=1e-6, atol=1e-6)
    x, dt, a, bm, cm, h0 = _ssd_inputs(6, 2, 1, 4, 8, 16)
    args = (h0, x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])
    y, new = ssd_recurrent_step(*(torch.from_numpy(t) for t in args))
    y_r, new_r = jstep(*(jnp.asarray(t) for t in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(new.numpy(), np.asarray(new_r), rtol=1e-6,
                               atol=1e-6)


def test_causal_conv1d_and_cache_update_match_reference():
    from repro.models.attention import _cache_update as jupdate
    from repro.models.ssm import causal_conv1d as jconv
    from repro_torch.models.attention import _cache_update
    from repro_torch.models.ssm import causal_conv1d

    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal((6,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        got = causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(bias),
                            None if state is None else torch.from_numpy(state))
        want = jconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                     None if state is None else jnp.asarray(state))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    buf = rng.standard_normal((3, 10, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 2, 4)).astype(np.float32)
    for index in (4, np.array([0, 3, 9], np.int32)):
        want = jupdate(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(index))
        tb = torch.from_numpy(buf.copy())
        tidx = index if isinstance(index, int) else torch.from_numpy(index)
        got = _cache_update(tb, torch.from_numpy(new), tidx)
        assert got is tb                      # written in place
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA kernels launch on CUDA tensors only; a CPU caller goes
    through ops, which takes the plain version."""
    q, k, v, qp, kp = (torch.from_numpy(t)
                       for t in _flash_inputs(0, 1, 8, 8, 2, 1, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v, q_positions=qp, kv_positions=kp)
    x, dt, a, bm, cm, h0 = (torch.from_numpy(t)
                            for t in _ssd_inputs(0, 1, 32, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan(x, dt, a, bm, cm, chunk=32, h0=h0)


def test_run_ctx_refuses_kernel_on_cpu_and_unknown_policy():
    with pytest.raises(ValueError, match="CUDA"):
        decoder.RunCtx(device="cpu", use_kernel="kernel")
    with pytest.raises(ValueError, match="use_kernel"):
        decoder.RunCtx(device="cpu", use_kernel="pallas")
    assert decoder.RunCtx(device="cpu").device == torch.device("cpu")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")


def test_cuda_device_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder.RunCtx()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder.RunCtx(device="cuda", use_kernel="ref")
    from repro_torch.configs import get_smoke_config

    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder.init_cache(get_smoke_config("glm4-9b"), 1, 8)
