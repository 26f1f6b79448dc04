"""repro_torch.models.moe and the MoE combine op held to repro's on the CPU.

Inputs are made with numpy from a seed and handed to both packages; expert
weights are in the chunked ``[1, E, d, f]`` layout of one device.  The
routed path (``moe_apply``) is held to the dense oracle (``moe_ref``) of the
port, which is held to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.models import moe
from repro_torch.obs import trace as obs_trace

MOE_ARCHS = ("mixtral-8x7b", "deepseek-v2-236b")
# float32: the two frameworks' matrix products; bfloat16: 2^-7 of the
# expert outputs' scale, one rounding of the bf16 products apart
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cfgs(arch, dtype):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype))


def _params(cfg, seed):
    """The chunked one-device tree, numpy float32 (the reference CLI's
    hand-built smoke params, with the shared experts when the config has
    them)."""
    m = cfg.moe
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, m.d_expert
    w = lambda *shape: (rng.standard_normal(shape)
                        / np.sqrt(shape[-2])).astype(np.float32)
    p = {"router": w(d, m.n_experts),
         "experts": {"w_gate": w(1, m.n_experts, d, f),
                     "w_up": w(1, m.n_experts, d, f),
                     "w_down": w(1, m.n_experts, f, d)}}
    if m.n_shared:
        fs = m.n_shared * m.d_shared
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs),
                       "w_down": w(fs, d)}
    return p


def _both(p, dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    return (jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p),
            jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), p))


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("top_k,norm,scale", [(2, True, 1.0), (6, False, 16.0),
                                              (1, True, 1.0)])
def test_router_topk_matches_reference_with_ties(top_k, norm, scale):
    """Equal probabilities keep the lower expert id first, as
    ``jax.lax.top_k`` does: rows of all-equal and pairwise-equal logits
    among random ones."""
    rng = np.random.default_rng(top_k)
    logits = rng.standard_normal((64, 16)).astype(np.float32)
    logits[:8] = 0.5                                    # every expert ties
    logits[8:16, 3] = logits[8:16, 11] = 4.0            # a tie at the top
    logits[16:24] = np.round(logits[16:24])             # ties in the tail
    gv, gi = moe.router_topk(torch.from_numpy(logits), top_k, norm, scale)
    wv, wi = jmoe.router_topk(jnp.asarray(logits), top_k, norm, scale)
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6,
                               atol=1e-7)
    assert gi[0].tolist() == list(range(top_k))
    assert gi[8, :2].tolist() == [3, 11][:top_k]


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((128, 8)).astype(np.float32)
    ids = np.argsort(-logits, axis=-1)[:, :2].astype(np.int32)
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(ids), 8)
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(ids),
                                      8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ref_matches_reference(arch, dtype):
    """The dense oracle: expert products in x's dtype, the gated sum in
    fp32, the shared experts after the cast; deepseek-v2 keeps its gates
    unnormalised and scales them by its router_scale."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _both(_params(tcfg, 1), dtype)
    x = np.random.default_rng(2).standard_normal(
        (2, 7, tcfg.d_model)).astype(np.float32)
    want = jmoe.moe_ref(jp, jnp.asarray(x).astype(jnp.dtype(dtype)), jcfg)
    got = moe.moe_ref(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                      tcfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_routes_like_the_dense_oracle(arch, dtype):
    """moe_apply gathers each expert's routed rows; it equals moe_ref up to
    the rounding of a matrix product over fewer rows, emits the
    reference's moe-dispatch span, and takes the same routed path on a
    mesh whose model axis has one rank (the reference's ``moe_ref``
    branch)."""
    _, tcfg = _cfgs(arch, dtype)
    _, tp = _both(_params(tcfg, 4), dtype)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 11, tcfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    rec = obs_trace.TraceRecorder()
    obs_trace.install(rec)
    try:
        got = moe.moe_apply(tp, x, tcfg)
    finally:
        obs_trace.uninstall()
    want = moe.moe_ref(tp, x, tcfg)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, want.float(), TOL[dtype])
    spans = [e for e in rec.to_events() if e["name"] == "moe-dispatch"]
    assert len(spans) == 1 and spans[0]["args"] == {"path": "ref",
                                                   "tokens": 33}
    class OneModelRank:                  # a (data 2, model 1) mesh's shape
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (2, 1)[i]

    assert torch.equal(moe.moe_apply(tp, x, tcfg, mesh=OneModelRank()), got)


def test_moe_apply_skips_experts_no_token_picked():
    """One token routes to top_k experts: the others launch nothing."""
    _, tcfg = _cfgs("deepseek-v2-236b", "float32")
    _, tp = _both(_params(tcfg, 7), "float32")
    called = []
    expert = moe._expert

    def counting(we, e, x):
        called.append((e, x.shape[0]))
        return expert(we, e, x)

    moe._expert = counting
    try:
        x = torch.randn((1, 1, tcfg.d_model), generator=torch.Generator()
                        .manual_seed(0))
        got = moe.moe_apply(tp, x, tcfg)
    finally:
        moe._expert = expert
    assert len(called) == tcfg.moe.top_k and all(n == 1 for _, n in called)
    assert [e for e, _ in called] == sorted(e for e, _ in called)
    _close(got, moe.moe_ref(tp, x, tcfg), TOL["float32"])


@pytest.mark.parametrize("model_size", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_chunked_layout_matches_reference(arch, model_size):
    """to_chunked on the smoke experts and chunked_shapes of the smoke and
    the published configs, for every model-axis size."""
    for tget, jget in ((tconfigs.get_smoke_config, jget_smoke),
                       (tconfigs.get_config, jget_config)):
        assert moe.chunked_shapes(tget(arch), model_size) == \
            jmoe.chunked_shapes(jget(arch), model_size)
    cfg = tconfigs.get_smoke_config(arch)
    m = cfg.moe
    rng = np.random.default_rng(model_size)
    w = [rng.standard_normal(s).astype(np.float32)
         for s in ((m.n_experts, cfg.d_model, m.d_expert),
                   (m.n_experts, cfg.d_model, m.d_expert),
                   (m.n_experts, m.d_expert, cfg.d_model))]
    got = moe.to_chunked(*map(torch.from_numpy, w), model_size)
    want = jmoe.to_chunked(*map(jnp.asarray, w), model_size)
    shapes = moe.chunked_shapes(cfg, model_size)
    for g, wnt, name in zip(got, want, ("w_gate", "w_up", "w_down")):
        assert tuple(g.shape) == shapes[name]
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_moe_combine_matches_reference(tp):
    """ops.moe_combine and ref.moe_combine_ref, by name, against
    repro.kernels.ref.moe_combine_ref (and its ops.moe_combine): gated
    partials summed over the tp blocks, scattered to tokens, empty slots
    (token t_out, gate 0) dropped, repeated tokens summed."""
    rng = np.random.default_rng(tp)
    ep, capacity, d, t_out = 3, 8, 16, 10
    back = rng.standard_normal((ep * tp * capacity, d)).astype(np.float32)
    tok = rng.integers(0, t_out, ep * capacity).astype(np.int32)
    gate = rng.random(ep * capacity).astype(np.float32)
    empty = rng.random(ep * capacity) < 0.3
    tok[empty], gate[empty] = t_out, 0.0
    kw = dict(tp=tp, capacity=capacity, t_out=t_out)
    want = jref.moe_combine_ref(jnp.asarray(back), jnp.asarray(tok),
                                jnp.asarray(gate), **kw)
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(jops.moe_combine(
            jnp.asarray(back), jnp.asarray(tok), jnp.asarray(gate), **kw)))
    args = (torch.from_numpy(back), torch.from_numpy(tok),
            torch.from_numpy(gate))
    for fn in (ops.moe_combine, ref.moe_combine_ref):
        got = fn(*args, **kw)
        assert tuple(got.shape) == (t_out, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert empty.any() and len(set(tok[~empty])) < (~empty).sum()
