"""repro_torch's model stack held to repro's at the smoke configs.

Parameters come from ``repro.models.common.init_params`` and reach the port
through ``params_from_numpy``; token ids are made with numpy from a seed.
Everything runs on the CPU, where the port takes the plain versions of its
kernels (the CUDA kernels are held to those on the card, in
``test_torch_cuda.py`` and ``chip_smoke.py``).

The MoE archs route each token to its top-k experts.  In float32 both
packages route every token alike.  In bfloat16 the two frameworks round the
hidden states at other places, and where two experts' router probabilities
lie closer than ``NEAR_TIE`` their order can swap: the token then takes
another expert, and in a causal model every later position of its sequence
sees it.  The bf16 comparisons record both packages' routing, require each
such flip to be a near-tie, say so in a warning, and compare the positions
before it.
"""
import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import decoder as jdec
from repro.models import moe as jmoe
from repro.models.common import init_params as jinit_params
from repro.models.common import param_shapes as jparam_shapes
from repro_torch import configs as tconfigs
from repro_torch.models import common, decoder
from repro_torch.models import moe as tmoe

# The registered archs whose features all have ported layers
# (common.unported_features is empty): held to repro.models here.
ARCHS = ("glm4-9b", "mamba2-780m", "phi4-mini-3.8b", "deepseek-v2-236b",
         "mixtral-8x7b")
JCTX = jdec.RunCtx(mesh=None, use_kernel="ref")
CTX = decoder.RunCtx(device="cpu")
# bf16 rounds at other places in the two frameworks (XLA fuses elementwise
# chains and keeps their float32 intermediates; torch rounds after every
# op), and the differences pass through every layer and the lm head; 2e-3
# holds the float32 runs, where the algorithms are compared.
TOL = {"float32": 2e-3, "bfloat16": 6e-2}
# bf16 keeps 8 significant bits: two router probabilities closer than this
# can change order between the frameworks
NEAR_TIE = 1e-2
NEVER = 1 << 30


@contextlib.contextmanager
def recorded_routing():
    """Record every ``router_topk`` call of both packages, in layer order:
    ``(logits, ids)`` per call, under ``"ref"`` and ``"port"``.  The
    reference's calls run inside ``lax.scan``; an ordered callback hands
    their values out."""
    rec = {"ref": [], "port": []}
    jorig, torig = jmoe.router_topk, tmoe.router_topk

    def jrec(logits, *a, **k):
        out = jorig(logits, *a, **k)
        jax.debug.callback(
            lambda lg, ids: rec["ref"].append((np.asarray(lg),
                                               np.asarray(ids))),
            logits, out[1], ordered=True)
        return out

    def trec(logits, *a, **k):
        out = torig(logits, *a, **k)
        rec["port"].append((logits.numpy(), out[1].numpy()))
        return out

    jmoe.router_topk, tmoe.router_topk = jrec, trec
    try:
        yield rec
    finally:
        jmoe.router_topk, tmoe.router_topk = jorig, torig


def routing_agrees(rec, b, positions, dtype):
    """The first position of each of the ``b`` sequences from which on the
    two packages' routing differs (``NEVER`` when it does not).

    Each call routes ``b`` sequences of ``len(positions)`` tokens, row
    ``seq * len(positions) + t`` at position ``positions[t]``.  In float32
    the expert ids must be equal.  In bfloat16 each flip at a position no
    earlier flip of its sequence reaches must be a near-tie, and a warning
    names it.
    """
    jax.effects_barrier()
    calls = list(zip(rec["ref"], rec["port"]))
    rec["ref"].clear()
    rec["port"].clear()
    s = len(positions)
    first = [NEVER] * b
    for layer, ((lj, ij), (lt, it)) in enumerate(calls):
        if dtype == "float32":
            np.testing.assert_array_equal(it, ij)
            continue
        seen = list(first)
        for row in np.nonzero((np.sort(ij, -1) != np.sort(it, -1)).any(-1))[0]:
            seq, pos = divmod(int(row), s)
            pos = positions[pos]
            if pos < seen[seq]:
                probs = np.sort(torch.softmax(torch.from_numpy(lt[row]), -1)
                                .numpy())[::-1]
                k = ij.shape[1]
                gap = float(probs[k - 1] - probs[k])
                assert gap < NEAR_TIE, (
                    f"layer {layer}, sequence {seq}, position {pos}: routing "
                    f"differs at a gap of {gap} (not a near-tie)")
                warnings.warn(
                    f"bf16 routing near-tie at MoE call {layer}, sequence "
                    f"{seq}, position {pos}: top-{k} probabilities "
                    f"{probs[k - 1]:.5f} / {probs[k]:.5f} swap between the "
                    "frameworks; compared before it")
                first[seq] = min(first[seq], pos)
    return first


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


def _close_before(got: torch.Tensor, want, tol, upto, pos=None):
    """Sequence ``i`` (dim 0) compared at the positions before ``upto[i]``:
    along dim 1 when ``pos`` is None, else whole when ``pos < upto[i]``."""
    want = np.asarray(want, np.float32)
    for i, u in enumerate(upto):
        if pos is None:
            _close(got[i, :u], want[i, :u], tol)
        elif pos < u:
            _close(got[i], want[i], tol)


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
    with recorded_routing() as rec:
        full_j = jdec.forward(jcfg, JCTX, params,
                              {"tokens": jnp.asarray(toks)})
        full_t = decoder.forward(tcfg, CTX, tparams,
                                 {"tokens": torch.from_numpy(toks)})
        upto = routing_agrees(rec, b, range(s), dtype)
        assert full_t.shape == (b, s, tcfg.vocab_size)
        assert full_t.dtype == tcfg.compute_dtype()
        _close_before(full_t, full_j, tol, upto)

        prompt = toks[:, :s - 1]
        logits0_j, caches_j = jdec.prefill(jcfg, JCTX, params,
                                           {"tokens": jnp.asarray(prompt)})
        logits0, caches = decoder.prefill(tcfg, CTX, tparams,
                                          {"tokens": torch.from_numpy(prompt)})
        upto = [min(u, v) for u, v in
                zip(upto, routing_agrees(rec, b, range(s - 1), dtype))]
        _close_before(logits0, logits0_j, tol, upto, pos=s - 2)
        _close_before(logits0, np.asarray(full_j)[:, s - 2], tol, upto,
                      pos=s - 2)
        ref_caches = _ref_layer_caches(jcfg, caches_j)
        assert len(caches) == tcfg.n_layers
        for got, want in zip(caches, ref_caches):
            assert got.keys() == want.keys()
            for mixer in got:
                assert got[mixer].keys() == want[mixer].keys()
                for leaf in got[mixer]:
                    assert tuple(got[mixer][leaf].shape) == \
                        want[mixer][leaf].shape
                    _close_before(got[mixer][leaf], want[mixer][leaf], tol,
                                  upto, pos=None if mixer == "attn"
                                  else s - 2)

        ring = decoder.init_cache(tcfg, b, s + 4, tcfg.compute_dtype(), "cpu")
        ring = _into_ring(ring, caches)
        logits1, new = decoder.decode_step(tcfg, CTX, tparams, ring,
                                           torch.from_numpy(toks[:, s - 1]),
                                           s - 1)
        # the reference's forward is the oracle here: record its routing
        # of position s - 1 again beside the port's decode
        jdec.forward(jcfg, JCTX, params, {"tokens": jnp.asarray(toks)})
        rec["ref"][:] = [(lg.reshape(b, s, -1)[:, s - 1],
                          ids.reshape(b, s, -1)[:, s - 1])
                         for lg, ids in rec["ref"]]
        upto = [min(u, v) for u, v in
                zip(upto, routing_agrees(rec, b, [s - 1], dtype))]
        _close_before(logits1, np.asarray(full_j)[:, s - 1], tol, upto,
                      pos=s - 1)
        assert len(new) == tcfg.n_layers
    assert max(upto) == NEVER, "every sequence's routing flipped"


def test_mixtral_window_masks_past_the_smoke_window():
    """mixtral's smoke window is 64 keys: at 80 tokens it masks, in the
    forward and in a decode step whose ring holds more than the window."""
    jcfg, tcfg, params, tparams = _setup("mixtral-8x7b", "float32", 5)
    assert tcfg.sliding_window == 64
    b, s = 2, 81
    toks = _tokens(5, tcfg.vocab_size, b, s)
    full_j = jdec.forward(jcfg, JCTX, params, {"tokens": jnp.asarray(toks)})
    full_t = decoder.forward(tcfg, CTX, tparams,
                             {"tokens": torch.from_numpy(toks)})
    _close(full_t, full_j, TOL["float32"])
    unmasked = dataclasses.replace(tcfg, sliding_window=None)
    open_t = decoder.forward(unmasked, CTX, tparams,
                             {"tokens": torch.from_numpy(toks)})
    assert not torch.allclose(open_t[:, 64:], full_t[:, 64:], atol=1e-3)
    torch.testing.assert_close(open_t[:, :64], full_t[:, :64])
    _, caches = decoder.prefill(tcfg, CTX, tparams,
                                {"tokens": torch.from_numpy(toks[:, :-1])})
    ring = _into_ring(decoder.init_cache(tcfg, b, s + 7, torch.float32,
                                         "cpu"), caches)
    logits, _ = decoder.decode_step(tcfg, CTX, tparams, ring,
                                    torch.from_numpy(toks[:, -1]),
                                    torch.full((b,), s - 1,
                                               dtype=torch.int32))
    _close(logits, np.asarray(full_j)[:, -1], TOL["float32"])


def test_mla_layer_matches_reference():
    """mla_attention alone (deepseek-v2's smoke dims): prefill output and
    latent cache, then a decode step with [B] positions at two depths
    through the absorbed form, against repro.models.attention's."""
    from repro.models.attention import mla_attention as jmla
    from repro_torch.models.attention import init_attn_cache, mla_attention

    jcfg, tcfg, params, tparams = _setup("deepseek-v2-236b", "float32", 6)
    jp, tp = params["prefix"]["layer0"]["attn"], tparams["layers"][0]["attn"]
    rng = np.random.default_rng(6)
    b, s, ring_len = 2, 9, 12
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want, jcache = jmla(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                        return_cache=True, use_kernel="ref")
    got, cache = mla_attention(tp, torch.from_numpy(x), tcfg,
                               torch.from_numpy(pos), return_cache=True)
    _close(got, want, TOL["float32"])
    assert cache.keys() == jcache.keys() == {"c_kv", "k_pe"}
    for leaf in cache:
        _close(cache[leaf], jcache[leaf], TOL["float32"])
    ring = init_attn_cache(tcfg, b, ring_len, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in ring.items()} == {
        "c_kv": (b, ring_len, 16), "k_pe": (b, ring_len, 8)}
    for leaf in ring:
        ring[leaf][:, :s] = cache[leaf]
    jring = {k: jnp.asarray(v.numpy()) for k, v in ring.items()}
    depth = np.array([s, s - 3], np.int32)       # rows at their own depths
    x1 = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    want, jnew = jmla(jp, jnp.asarray(x1), jcfg, jnp.asarray(depth[:, None]),
                      cache=jring, cache_index=jnp.asarray(depth),
                      return_cache=True, use_kernel="ref")
    got, new = mla_attention(tp, torch.from_numpy(x1), tcfg,
                             torch.from_numpy(depth[:, None]), cache=ring,
                             cache_index=torch.from_numpy(depth),
                             return_cache=True)
    _close(got, want, TOL["float32"])
    for leaf in new:
        assert new[leaf] is ring[leaf]           # written in place
        _close(new[leaf], jnew[leaf], TOL["float32"])


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
    """All ten architectures are registered (a config is data: the serving
    simulator prices with it); building the layers of one whose features
    the port does not run yet raises, naming the ROADMAP item.  Which
    archs build follows from their features alone."""
    from repro.configs import ARCH_IDS as JARCH_IDS

    assert tconfigs.ARCH_IDS == JARCH_IDS and len(JARCH_IDS) == 10
    gen = torch.Generator().manual_seed(0)
    for arch in tconfigs.ARCH_IDS:
        assert tconfigs.get_config(arch).name == arch
        cfg = tconfigs.get_smoke_config(arch)
        assert (not common.unported_features(cfg)) == (arch in ARCHS)
        assert (not common.unported_features(tconfigs.get_config(arch))) \
            == (arch in ARCHS)
        if arch in ARCHS:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            common.init_params(cfg, gen, "cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            common.params_from_numpy(cfg, {}, "cpu")
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_config("no-such-arch")


def test_unported_layer_kinds_raise():
    """The features still unported refuse by name (gemma3's local/global
    pattern, zamba2's shared attention, qwen2-vl's M-RoPE among them); MoE,
    MLA and a sliding window on every layer build, and an MoE block runs
    as the reference's does."""
    gen = torch.Generator().manual_seed(0)
    # the refusal reads the config's features, not its name
    renamed = dataclasses.replace(tconfigs.get_smoke_config("glm4-9b"),
                                  name="my-dense-model")
    assert common.init_params(renamed, gen, "cpu")["layers"]
    for feature in (dict(mlp_act="gelu"), dict(use_qk_norm=True),
                    dict(sliding_window=8, global_every=2),
                    dict(mrope_sections=(2, 3, 3)), dict(causal=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            common.init_params(dataclasses.replace(renamed, **feature), gen,
                               "cpu")
    for feature in (dict(sliding_window=8),
                    dict(moe=common.MoEConfig(n_experts=4, d_expert=32)),
                    dict(mla=common.MLAConfig(8, 8, 8, 4, 8))):
        cfg = dataclasses.replace(renamed, **feature)
        assert not common.unported_features(cfg)
        assert common.init_params(cfg, gen, "cpu")["layers"]
    zamba = tconfigs.get_smoke_config("zamba2-1.2b")
    with pytest.raises(NotImplementedError, match="shared attention"):
        common.init_params(zamba, gen, "cpu")
    kind = common.LayerKind("shared_attn", "dense")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decoder.block_apply(zamba, CTX, kind, {}, torch.zeros((1, 2, 64)),
                            torch.zeros((1, 2), dtype=torch.int32))
    # a positive MoE block: mixtral's layer against the reference's
    jcfg, tcfg, params, tparams = _setup("mixtral-8x7b", "float32", 0)
    kind = common.LayerKind("attn_local", "moe")
    x = np.random.default_rng(0).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    want, _ = jdec.block_apply(
        jcfg, JCTX, kind, jax.tree.map(lambda a: a[0],
                                       params["blocks"]["pos0"]),
        None, jnp.asarray(x), jnp.asarray(pos))
    got, _ = decoder.block_apply(tcfg, CTX, kind, tparams["layers"][0],
                                 torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want, TOL["float32"])


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
