"""repro_torch's model stack held to repro's at the smoke configs.

Parameters come from ``repro.models.common.init_params`` and reach the port
through ``params_from_numpy``; token ids are made with numpy from a seed.
Everything runs on the CPU, where the port takes the plain versions of its
kernels (the CUDA kernels are held to those on the card, in
``test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import decoder as jdec
from repro.models.common import init_params as jinit_params
from repro.models.common import param_shapes as jparam_shapes
from repro_torch import configs as tconfigs
from repro_torch.models import common, decoder
from repro_torch.models.attention import mla_attention

ARCHS = ("glm4-9b", "mamba2-780m")
JCTX = jdec.RunCtx(mesh=None, use_kernel="ref")
CTX = decoder.RunCtx(device="cpu")
# bf16 rounds at other places in the two frameworks (XLA fuses elementwise
# chains and keeps their float32 intermediates; torch rounds after every
# op), and the differences pass through every layer and the lm head; 2e-3
# holds the float32 runs, where the algorithms are compared.
TOL = {"float32": 2e-3, "bfloat16": 6e-2}


def _setup(arch, dtype, seed):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype)
    params = jinit_params(jcfg, jax.random.PRNGKey(seed))
    tparams = common.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                       "cpu")
    return jcfg, tcfg, params, tparams


def _tokens(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _ref_layer_caches(jcfg, caches):
    """The reference's prefix/body/suffix cache tree as one dict per layer."""
    plan = jdec.layer_plan(jcfg)
    out = [None] * jcfg.n_layers
    for i, c in enumerate(caches["prefix"]):
        out[i] = c
    for j, c in enumerate(caches["body"] or []):
        for g in range(plan.n_groups):
            out[plan.prefix + g * plan.period + j] = jax.tree.map(
                lambda a, g=g: a[g], c)
    for i, c in enumerate(caches["suffix"]):
        out[plan.suffix_start + i] = c
    return out


def _into_ring(ring, prompt):
    """Copy each prompt cache leaf into the leading slice of the ring's."""
    if isinstance(ring, dict):
        return {k: _into_ring(ring[k], prompt[k]) for k in ring}
    if isinstance(ring, list):
        return [_into_ring(r, p) for r, p in zip(ring, prompt)]
    ring[tuple(slice(0, n) for n in prompt.shape)] = prompt.to(ring.dtype)
    return ring


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """forward, prefill (logits and caches) and one decode_step after the
    prompt cache moves into a longer ring, against repro's
    (mirrors tests/test_models.py::test_decode_matches_forward)."""
    jcfg, tcfg, params, tparams = _setup(arch, dtype, 1)
    tol = TOL[dtype]
    b, s = 2, 33
    toks = _tokens(1, jcfg.vocab_size, b, s)
    full_j = jdec.forward(jcfg, JCTX, params, {"tokens": jnp.asarray(toks)})
    full_t = decoder.forward(tcfg, CTX, tparams,
                             {"tokens": torch.from_numpy(toks)})
    assert full_t.shape == (b, s, tcfg.vocab_size)
    assert full_t.dtype == tcfg.compute_dtype()
    _close(full_t, full_j, tol)

    prompt = toks[:, :s - 1]
    logits0_j, caches_j = jdec.prefill(jcfg, JCTX, params,
                                       {"tokens": jnp.asarray(prompt)})
    logits0, caches = decoder.prefill(tcfg, CTX, tparams,
                                      {"tokens": torch.from_numpy(prompt)})
    _close(logits0, logits0_j, tol)
    _close(logits0, full_j[:, s - 2], tol)
    ref_caches = _ref_layer_caches(jcfg, caches_j)
    assert len(caches) == tcfg.n_layers
    for got, want in zip(caches, ref_caches):
        assert got.keys() == want.keys()
        for mixer in got:
            assert got[mixer].keys() == want[mixer].keys()
            for leaf in got[mixer]:
                assert tuple(got[mixer][leaf].shape) == \
                    want[mixer][leaf].shape
                _close(got[mixer][leaf], want[mixer][leaf], tol)

    ring = decoder.init_cache(tcfg, b, s + 4, tcfg.compute_dtype(), "cpu")
    ring = _into_ring(ring, caches)
    logits1, new = decoder.decode_step(tcfg, CTX, tparams, ring,
                                       torch.from_numpy(toks[:, s - 1]),
                                       s - 1)
    _close(logits1, full_j[:, s - 1], tol)
    assert len(new) == tcfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_vector_positions_match_scalar(arch):
    """Continuous batching: per-row pos == scalar pos when rows align
    (mirrors tests/test_models.py::test_decode_vector_positions_match_scalar)."""
    _, tcfg, _, tparams = _setup(arch, "float32", 2)
    b, s = 3, 16
    toks = _tokens(2, tcfg.vocab_size, b, s)
    _, caches = decoder.prefill(tcfg, CTX, tparams,
                                {"tokens": torch.from_numpy(toks)})
    tok = torch.tensor([1, 2, 3], dtype=torch.int32)
    outs = []
    for pos in (torch.tensor(s, dtype=torch.int32),
                torch.full((b,), s, dtype=torch.int32)):
        ring = _into_ring(decoder.init_cache(tcfg, b, s + 4, torch.float32,
                                             "cpu"), caches)
        outs.append(decoder.decode_step(tcfg, CTX, tparams, ring, tok,
                                        pos)[0])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_decode_rows_at_different_depths():
    """A [B] pos whose rows differ equals each row decoded on its own."""
    _, tcfg, _, tparams = _setup("glm4-9b", "float32", 3)
    b, s = 2, 12
    toks = _tokens(3, tcfg.vocab_size, b, s)
    _, caches = decoder.prefill(tcfg, CTX, tparams,
                                {"tokens": torch.from_numpy(toks)})
    tok = torch.tensor([5, 7], dtype=torch.int32)
    pos = torch.tensor([s, s - 3], dtype=torch.int32)
    ring = _into_ring(decoder.init_cache(tcfg, b, s + 4, torch.float32,
                                         "cpu"), caches)
    both, _ = decoder.decode_step(tcfg, CTX, tparams, ring, tok, pos)
    for row in range(b):
        one = _into_ring(decoder.init_cache(tcfg, 1, s + 4, torch.float32,
                                            "cpu"),
                         [{m: {k: t[row:row + 1] for k, t in c[m].items()}
                           for m in c} for c in caches])
        alone, _ = decoder.decode_step(tcfg, CTX, tparams, one,
                                       tok[row:row + 1], int(pos[row]))
        np.testing.assert_allclose(both[row].numpy(), alone[0].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_pinned_to_reference(arch):
    """Every field of CONFIG and smoke_config() equals the reference's,
    and the parameter trees agree leaf for leaf."""
    for tget, jget in ((tconfigs.get_config, jget_config),
                       (tconfigs.get_smoke_config, jget_smoke)):
        tcfg, jcfg = tget(arch), jget(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert common.param_shapes(tcfg) == jparam_shapes(jcfg)
        assert tcfg.param_count() == jcfg.param_count()
    assert common.layer_plan(tconfigs.get_config(arch)).kinds == tuple(
        common.LayerKind(k.mixer, k.ffn)
        for k in jdec.layer_plan(jget_config(arch)).kinds)


def test_registry_names_roadmap_for_unported_archs():
    assert tconfigs.ARCH_IDS == ARCHS
    with pytest.raises(KeyError, match="ROADMAP"):
        tconfigs.get_config("mixtral-8x7b")
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_config("no-such-arch")


def test_unported_layer_kinds_raise():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("glm4-9b"),
                              moe=common.MoEConfig(n_experts=4, d_expert=32))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        common.init_params(cfg, gen, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mla_attention()
    _, tcfg, _, tparams = _setup("glm4-9b", "float32", 0)
    kind = common.LayerKind("attn", "moe")
    x = torch.zeros((1, 2, tcfg.d_model))
    pos = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decoder.block_apply(tcfg, CTX, kind, tparams["layers"][0], x, pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_reference_init(arch):
    """Shapes of the port's layout, special inits, truncated-normal std."""
    cfg = tconfigs.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = common.init_params(cfg, gen, "cpu", torch.float32)
    shapes = common.layer_param_shapes(cfg)
    assert len(params["layers"]) == cfg.n_layers

    def walk(p, s):
        if isinstance(s, dict):
            assert p.keys() == s.keys()
            for k in s:
                walk(p[k], s[k])
        else:
            assert tuple(p.shape) == s

    for p, s in zip(params["layers"], shapes):
        walk(p, s)
    assert torch.equal(params["final_norm"], torch.ones(cfg.d_model))
    w = params["embed"]
    std = cfg.vocab_size ** -0.5
    assert w.abs().max() <= 3 * std + 1e-7
    assert abs(float(w.std()) / std - 0.987) < 0.02  # N(0,1) cut at 3: 0.987
    if cfg.ssm is not None:
        m = params["layers"][0]["mamba"]
        nh = cfg.ssm.n_heads(cfg.d_model)
        np.testing.assert_allclose(m["A_log"].numpy(),
                                   np.log(np.linspace(1.0, 16.0, nh)),
                                   rtol=1e-6)
        assert torch.equal(m["D"], torch.ones(nh))
        np.testing.assert_allclose(
            torch.nn.functional.softplus(m["dt_bias"]).numpy(), 0.01,
            rtol=1e-5)
    again = common.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"], params["embed"])


def test_decoder_module_runs_the_functions():
    _, tcfg, _, tparams = _setup("mamba2-780m", "float32", 4)
    model = decoder.Decoder(tcfg, tparams, CTX)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in common._leaves(common.param_shapes(tcfg)))
    toks = torch.from_numpy(_tokens(4, tcfg.vocab_size, 2, 40))
    got, caches = model.prefill({"tokens": toks})
    want, _ = decoder.prefill(tcfg, CTX, tparams, {"tokens": toks})
    assert torch.equal(got, want)
    ring = _into_ring(model.init_cache(2, 44), caches)
    logits, _ = model.decode_step(ring, toks[:, -1], 40)
    assert logits.shape == (2, tcfg.vocab_size)
    assert torch.isfinite(logits).all()
