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

# Every registered arch, held to repro.models here; the decode tests take
# the causal ones (hubert-xlarge is an encoder: a forward test of its own)
ARCHS = ("glm4-9b", "mamba2-780m", "phi4-mini-3.8b", "deepseek-v2-236b",
         "mixtral-8x7b", "zamba2-1.2b", "minitron-4b", "gemma3-27b",
         "qwen2-vl-2b", "hubert-xlarge")
CAUSAL = tuple(a for a in ARCHS if jget_config(a).causal)
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
# archs whose bf16 smoke runs are held to the reference computed layer by
# layer (jdec.block_apply in a Python loop, the port's order of work): its
# scanned stack rounds elsewhere in bf16 (XLA compiles the scan body), and
# differs from its own layer-by-layer run by more than TOL here (zamba2:
# 0.108 in the logits, gemma3: 0.168, the hidden state growing through
# eight layers).  The port rounds as the layer-by-layer run does (its
# activations are jax.nn's op chains, common.silu / common.gelu_tanh) and
# is as far from the scanned stack as that run is
# (test_bf16_port_is_the_reference_by_layer).
BY_LAYER_BF16 = ("gemma3-27b", "zamba2-1.2b")
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


def _reference_by_layer(jcfg, params, tparams, batch, caches=None,
                        pos=None):
    """The reference's prefill computed layer by layer (``jdec.block_apply``
    in a Python loop, the port's order of work): its logits ``[B, S, V]``
    and one cache dict per layer.  With ``caches`` (one ring per layer) and
    ``pos``, a decode step the same way, ``batch`` holding one position."""
    x = jdec.embed_in(jcfg, params, _jax(batch))
    s = x.shape[1]
    if pos is not None:
        positions = jnp.broadcast_to(jnp.asarray(pos, jnp.int32),
                                     (x.shape[0], 1))
        if jcfg.mrope_sections is not None:
            positions = jnp.broadcast_to(positions[None], (3,) + positions.shape)
    elif "positions" in batch:
        positions = jnp.asarray(batch["positions"])
    else:
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None],
                                     (x.shape[0], s))
    shared = tparams.get("shared_attn")
    out = []
    for i, (kind, layer) in enumerate(zip(jdec.layer_plan(jcfg).kinds,
                                          tparams["layers"])):
        x, c = jdec.block_apply(jcfg, JCTX, kind, _numpy_tree(layer),
                                None if shared is None
                                else _numpy_tree(shared), x, positions,
                                cache=None if caches is None else caches[i],
                                cache_index=None if pos is None
                                else jnp.asarray(pos, jnp.int32),
                                return_cache=True)
        out.append(c)
    return jdec.lm_logits(jcfg, JCTX, params, x), out


def _ref_ring(prompt, ring):
    """The reference's prompt cache leaves copied into the leading slice of
    a longer ring's (any tree of jnp arrays)."""
    return jax.tree.map(
        lambda r, p: r.at[tuple(slice(0, n) for n in p.shape)].set(
            p.astype(r.dtype)), ring, prompt)


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


def _batch(cfg, seed, b, s):
    """numpy inputs as tests/test_models.py makes them: token ids, or the
    stub frontend's ``embeds`` for the vlm and audio families; M-RoPE
    positions ``[3, B, S]`` with the three sections equal (text)."""
    if cfg.family in ("vlm", "audio"):
        batch = {"embeds": np.random.default_rng(seed).standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": _tokens(seed, cfg.vocab_size, b, s)}
    if cfg.mrope_sections is not None:
        batch["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32), (3, b, s)).copy()
    return batch


def _cut(batch, n):
    """The first ``n`` positions of every input (positions on their last
    axis)."""
    return {k: v[..., :n] if k == "positions" else v[:, :n]
            for k, v in batch.items()}


def _cut_at(batch, i):
    """Position ``i`` of every input, as a one-position batch."""
    return {k: v[..., i:i + 1] if k == "positions" else v[:, i:i + 1]
            for k, v in batch.items()}


def _step_input(batch, i):
    """decode_step's input for position ``i``: token ids ``[B]`` or the
    position's embeddings ``[B, 1, d]``."""
    if "tokens" in batch:
        return batch["tokens"][:, i]
    return batch["embeds"][:, i:i + 1]


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


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
@pytest.mark.parametrize("arch", CAUSAL)
def test_decode_matches_reference(arch, dtype):
    """forward, prefill (logits and caches) and one decode_step after the
    prompt cache moves into a longer ring, against repro's
    (mirrors tests/test_models.py::test_decode_matches_forward)."""
    jcfg, tcfg, params, tparams = _setup(arch, dtype, 1)
    tol = TOL[dtype]
    b, s = 2, 33
    batch = _batch(tcfg, 1, b, s)
    ring_len, dt = s + 4, jnp.dtype(dtype)
    if dtype == "bfloat16" and arch in BY_LAYER_BF16:
        def forward_j(bt):
            return _reference_by_layer(jcfg, params, tparams, bt)[0]

        def prefill_j(bt):
            logits, caches = _reference_by_layer(jcfg, params, tparams, bt)
            return logits[:, -1], caches, caches

        def decode_j(prompt_caches, step, pos):
            rings = [_ref_ring(c, jdec._layer_cache(jcfg, kind, b, ring_len,
                                                    dt))
                     for c, kind in zip(prompt_caches,
                                        jdec.layer_plan(jcfg).kinds)]
            return _reference_by_layer(jcfg, params, tparams, step, rings,
                                       pos)[0][:, 0]
    else:
        def forward_j(bt):
            return jdec.forward(jcfg, JCTX, params, _jax(bt))

        def prefill_j(bt):
            logits, caches = jdec.prefill(jcfg, JCTX, params, _jax(bt))
            return logits, _ref_layer_caches(jcfg, caches), caches

        def decode_j(prompt_caches, step, pos):
            ring = _ref_ring(prompt_caches,
                             jdec.init_cache(jcfg, b, ring_len, dt))
            tok = step.get("tokens", step.get("embeds"))
            return jdec.decode_step(jcfg, JCTX, params, ring,
                                    jnp.asarray(tok[:, 0] if "tokens" in step
                                                else tok), pos)[0]
    with recorded_routing() as rec:
        full_j = forward_j(batch)
        full_t = decoder.forward(tcfg, CTX, tparams, _torch(batch))
        upto = routing_agrees(rec, b, range(s), dtype)
        assert full_t.shape == (b, s, tcfg.vocab_size)
        assert full_t.dtype == tcfg.compute_dtype()
        _close_before(full_t, full_j, tol, upto)

        prompt = _cut(batch, s - 1)
        logits0_j, ref_caches, ref_raw = prefill_j(prompt)
        logits0, caches = decoder.prefill(tcfg, CTX, tparams, _torch(prompt))
        upto = [min(u, v) for u, v in
                zip(upto, routing_agrees(rec, b, range(s - 1), dtype))]
        _close_before(logits0, logits0_j, tol, upto, pos=s - 2)
        _close_before(logits0, np.asarray(full_j)[:, s - 2], tol, upto,
                      pos=s - 2)
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

        ring = decoder.init_cache(tcfg, b, ring_len, tcfg.compute_dtype(),
                                  "cpu")
        ring = _into_ring(ring, caches)
        logits1, new = decoder.decode_step(
            tcfg, CTX, tparams, ring,
            torch.from_numpy(_step_input(batch, s - 1)), s - 1)
        # the oracle is the reference's own decode step from its own
        # prompt cache (in bf16 its decode differs from its forward by more
        # than TOL: deepseek-v2's absorbed MLA, 0.095)
        logits1_j = decode_j(ref_raw, _cut_at(batch, s - 1), s - 1)
        upto = [min(u, v) for u, v in
                zip(upto, routing_agrees(rec, b, [s - 1], dtype))]
        _close_before(logits1, logits1_j, tol, upto, pos=s - 1)
        assert len(new) == tcfg.n_layers
    assert max(upto) == NEVER, "every sequence's routing flipped"


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activations_round_like_jax(act):
    """In bf16 common.silu and common.gelu_tanh equal jax.nn.silu and
    jax.nn.gelu bit for bit (each op rounded, as the reference's are);
    F.silu / F.gelu, which round once, differ at many elements."""
    x = np.random.default_rng(0).standard_normal(1 << 14).astype(
        np.float32) * 4
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    jfn, tfn, once = {
        "silu": (jax.nn.silu, common.silu, torch.nn.functional.silu),
        "gelu": (jax.nn.gelu, common.gelu_tanh,
                 lambda t: torch.nn.functional.gelu(t, approximate="tanh")),
    }[act]
    want = np.asarray(jfn(xj).astype(jnp.float32))
    np.testing.assert_array_equal(tfn(xt).float().numpy(), want)
    assert (once(xt).float().numpy() != want).mean() > 0.1


@pytest.mark.parametrize("arch", BY_LAYER_BF16)
def test_bf16_port_is_the_reference_by_layer(arch):
    """bf16 logits: the port within TOL of the reference computed layer by
    layer, and no further from the reference's scanned stack than that
    layer-by-layer run is (the gap past TOL is the reference's own)."""
    jcfg, tcfg, params, tparams = _setup(arch, "bfloat16", 1)
    batch = _batch(tcfg, 1, 2, 33)
    port = decoder.forward(tcfg, CTX, tparams, _torch(batch)).float().numpy()
    by_layer = np.asarray(_reference_by_layer(jcfg, params, tparams, batch)[0],
                          np.float32)
    scanned = np.asarray(jdec.forward(jcfg, JCTX, params, _jax(batch)),
                         np.float32)
    _close(torch.from_numpy(port), by_layer, TOL["bfloat16"])
    own = np.abs(by_layer - scanned).max()
    print(f"{arch} bf16 logits: port - by layer "
          f"{np.abs(port - by_layer).max()}, port - scanned "
          f"{np.abs(port - scanned).max()}, by layer - scanned {own}")
    assert np.abs(port - scanned).max() <= own + TOL["bfloat16"]


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


@pytest.mark.parametrize("arch", CAUSAL)
def test_decode_vector_positions_match_scalar(arch):
    """Continuous batching: per-row pos == scalar pos when rows align
    (mirrors tests/test_models.py::test_decode_vector_positions_match_scalar)."""
    _, tcfg, _, tparams = _setup(arch, "float32", 2)
    b, s = 3, 16
    _, caches = decoder.prefill(tcfg, CTX, tparams,
                                _torch(_batch(tcfg, 2, b, s)))
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
    """All ten architectures are registered and every one builds: through
    ``init_params`` in the port's layout, and through ``params_from_numpy``
    from the reference's parameters, leaf for leaf (zamba2's
    ``shared_attn`` block held once, not per site).  The name dates from
    when the registry named ROADMAP items for archs the port refused; no
    arch is refused now."""
    from repro.configs import ARCH_IDS as JARCH_IDS

    assert tconfigs.ARCH_IDS == JARCH_IDS and len(JARCH_IDS) == 10
    assert sorted(ARCHS) == sorted(JARCH_IDS)
    gen = torch.Generator().manual_seed(0)
    for arch in tconfigs.ARCH_IDS:
        assert tconfigs.get_config(arch).name == arch
        cfg = tconfigs.get_smoke_config(arch)
        built = common.init_params(cfg, gen, "cpu")
        assert len(built["layers"]) == cfg.n_layers
        _, _, params, tparams = _setup(arch, "float32", 0)
        assert tparams.keys() == built.keys()
        assert ("shared_attn" in tparams) == (arch == "zamba2-1.2b")
        n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
        n_port = sum(t.numel() for t in _tensors(tparams))
        assert n_port == n_ref == cfg.param_count()
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_config("no-such-arch")


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def _numpy_tree(tree):
    """A port parameter subtree as the reference's jnp arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _block_against_reference(jcfg, tcfg, tparams, layer, kind, positions,
                             seed, s=9):
    """Layer ``layer`` of the port (``block_apply``, the shared block
    handed over where the kind reads it) against ``jdec.block_apply`` on
    the same parameters and a seeded ``x``; returns the port's output."""
    b = positions.shape[-2]
    x = np.random.default_rng(seed).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    shared = tparams.get("shared_attn")
    want, _ = jdec.block_apply(
        jcfg, JCTX, kind, _numpy_tree(tparams["layers"][layer]),
        None if shared is None else _numpy_tree(shared), jnp.asarray(x),
        jnp.asarray(positions))
    got, _ = decoder.block_apply(
        tcfg, CTX, kind, tparams["layers"][layer], torch.from_numpy(x),
        torch.from_numpy(positions), shared_p=shared)
    _close(got, want, TOL["float32"])
    return got


# each feature the port once refused, on glm4-9b's smoke config, and the
# layer whose block runs it: (fields, layer, kind)
FEATURES = [
    (dict(mlp_act="gelu"), 0, ("attn", "dense")),
    (dict(use_qk_norm=True), 0, ("attn", "dense")),
    (dict(use_qk_norm=True, gemma_norm=True), 0, ("attn", "dense")),
    (dict(sliding_window=4, global_every=2, rope_theta_global=1e6), 0,
     ("attn_local", "dense")),
    (dict(sliding_window=4, global_every=2, rope_theta_global=1e6), 1,
     ("attn", "dense")),
    (dict(mrope_sections=(2, 3, 3), partial_rotary=1.0), 0,
     ("attn", "dense")),
    (dict(causal=False), 0, ("attn", "dense")),
    (dict(ssm=common.SSMConfig(d_state=16, head_dim=16, chunk=32),
          hybrid_attn_every=2), 1, ("shared_attn", "dense")),
]


def test_unported_layer_kinds_raise():
    """The features the port once refused (gelu, QK norm, gemma norms, the
    local/global pattern with dual theta, M-RoPE, bidirectional attention,
    shared attention) now build, and each one's block equals
    ``jdec.block_apply``; an MoE block too.  The name dates from when these
    kinds raised; none raises now."""
    gen = torch.Generator().manual_seed(0)
    for i, (fields, layer, kind) in enumerate(FEATURES):
        jssm = fields.get("ssm")
        jfields = dict(fields)
        if jssm is not None:         # the reference's own dataclass
            from repro.models.common import SSMConfig as JSSMConfig

            jfields["ssm"] = JSSMConfig(**dataclasses.asdict(jssm))
        tcfg = dataclasses.replace(tconfigs.get_smoke_config("glm4-9b"),
                                   name="my-model", dtype="float32",
                                   **fields)
        jcfg = dataclasses.replace(jget_smoke("glm4-9b"), name="my-model",
                                   dtype="float32", **jfields)
        assert common.layer_plan(tcfg).kinds[layer] == common.LayerKind(*kind)
        assert common.init_params(tcfg, gen, "cpu")["layers"]
        params = jinit_params(jcfg, jax.random.PRNGKey(i))
        tparams = common.params_from_numpy(
            tcfg, jax.tree.map(np.asarray, params), "cpu")
        s = 9
        pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
        if tcfg.mrope_sections is not None:       # distinct t / h / w
            pos = np.stack([pos, pos // 3, pos % 3]).astype(np.int32)
        _block_against_reference(jcfg, tcfg, tparams, layer,
                                 common.LayerKind(*kind), pos, i, s)
    # a positive MoE block: mixtral's layer against the reference's
    jcfg, tcfg, params, tparams = _setup("mixtral-8x7b", "float32", 0)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    _block_against_reference(jcfg, tcfg, tparams, 0,
                             common.LayerKind("attn_local", "moe"), pos, 0,
                             s=5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_forward_matches_reference(dtype):
    """The encoder: a bidirectional forward over frame embeddings (the
    stub frontend's ``embeds``), logits against repro's."""
    jcfg, tcfg, params, tparams = _setup("hubert-xlarge", dtype, 7)
    assert not tcfg.causal and tcfg.family == "audio"
    batch = _batch(tcfg, 7, 2, 40)
    want = jdec.forward(jcfg, JCTX, params, _jax(batch))
    got = decoder.forward(tcfg, CTX, tparams, _torch(batch))
    assert got.shape == (2, 40, tcfg.vocab_size)
    assert got.dtype == tcfg.compute_dtype()
    _close(got, want, TOL[dtype])
    # bidirectional: the first frame's logits read the last frame
    later = {"embeds": batch["embeds"].copy()}
    later["embeds"][:, -1] += 1.0
    moved = decoder.forward(tcfg, CTX, tparams, _torch(later))
    assert not torch.allclose(moved[:, 0], got[:, 0])


def _vision_positions(b, grid, n_text):
    """Qwen2-VL's M-RoPE positions ``[3, B, S]``: a ``grid`` x ``grid``
    patch image at t = 0 (h = row, w = column), then text, whose three
    sections run on together from the largest image position + 1."""
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    img = np.stack([np.zeros_like(rows), rows, cols])
    text = grid + np.arange(n_text)
    pos = np.concatenate([img, np.stack([text] * 3)], axis=1)
    return np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).astype(
        np.int32).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2vl_prefill_with_distinct_sections(dtype):
    """qwen2-vl's backbone over a 4 x 4 patch image and then text: the
    temporal, height and width sections differ, so a wrong section split
    of the rotary bands would show.  forward and prefill (logits and KV
    caches) against repro's."""
    jcfg, tcfg, params, tparams = _setup("qwen2-vl-2b", dtype, 8)
    b, grid, n_text = 2, 4, 9
    s = grid * grid + n_text
    batch = {"embeds": np.random.default_rng(8).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32),
        "positions": _vision_positions(b, grid, n_text)}
    assert len({tuple(p) for p in batch["positions"][:, 0]}) == 3
    want = jdec.forward(jcfg, JCTX, params, _jax(batch))
    got = decoder.forward(tcfg, CTX, tparams, _torch(batch))
    _close(got, want, TOL[dtype])
    logits_j, caches_j = jdec.prefill(jcfg, JCTX, params, _jax(batch))
    logits, caches = decoder.prefill(tcfg, CTX, tparams, _torch(batch))
    _close(logits, logits_j, TOL[dtype])
    for got_c, want_c in zip(caches, _ref_layer_caches(jcfg, caches_j)):
        for leaf in ("k", "v"):
            _close(got_c["attn"][leaf], want_c["attn"][leaf], TOL[dtype])
    # the sections matter: the same inputs with text positions throughout
    # give other logits
    flat = dict(batch, positions=np.broadcast_to(
        np.arange(s, dtype=np.int32), (3, b, s)).copy())
    other = decoder.forward(tcfg, CTX, tparams, _torch(flat))
    assert not torch.allclose(other, got, atol=1e-2)


def test_zamba2_shared_sites_read_one_block_and_own_caches():
    """zamba2's shared attention: every shared site reads the same
    ``params["shared_attn"]`` tensors (the block is held once), each site
    keeps its own MLP and writes its own KV cache."""
    _, tcfg, _, tparams = _setup("zamba2-1.2b", "float32", 9)
    kinds = common.layer_plan(tcfg).kinds
    sites = [i for i, k in enumerate(kinds) if k.mixer == "shared_attn"]
    assert sites == [2, 5]
    for i in sites:
        assert "attn" not in tparams["layers"][i]
        assert tparams["layers"][i].keys() == {"mlp", "ln_mlp"}
    seen = []
    plain = decoder.gqa_attention

    def watch(p, *a, **k):
        seen.append(p)
        return plain(p, *a, **k)

    decoder.gqa_attention = watch
    try:
        toks = torch.from_numpy(_tokens(9, tcfg.vocab_size, 2, 12))
        _, caches = decoder.prefill(tcfg, CTX, tparams, {"tokens": toks})
    finally:
        decoder.gqa_attention = plain
    assert len(seen) == len(sites)
    for p in seen:                        # the very same tensors each time
        assert all(p[k] is tparams["shared_attn"]["attn"][k] for k in p)
    a, b = (caches[i]["attn"] for i in sites)
    assert a.keys() == b.keys() == {"k", "v"}
    for leaf in a:
        assert a[leaf].data_ptr() != b[leaf].data_ptr()
        assert not torch.allclose(a[leaf], b[leaf])
    assert all(caches[i].keys() == {"mamba"} for i, k in enumerate(kinds)
               if k.mixer == "mamba")
    model = decoder.Decoder(tcfg, tparams, CTX)
    assert sum(p.numel() for p in model.parameters()) == tcfg.param_count()


@pytest.mark.parametrize("layer,kind", [(0, "attn_local"), (5, "attn")])
def test_gemma3_blocks_match_reference(layer, kind):
    """gemma3's local (1 of the 5: window, theta 1e4) and global (theta
    1e6) layers alone: (1 + w) pre- and post-block norms, QK norms, GeGLU,
    at 40 positions, past the smoke window of 32."""
    jcfg, tcfg, _, tparams = _setup("gemma3-27b", "float32", 10)
    assert common.layer_plan(tcfg).kinds[layer] == common.LayerKind(
        kind, "dense")
    assert tparams["layers"][layer].keys() >= {"ln_post_attn", "ln_post_mlp"}
    for p in (tparams["layers"][layer], tparams["layers"][layer]["attn"]):
        for name, t in p.items():      # norms away from their init
            if name.endswith("norm") or name.startswith("ln_"):
                t.copy_(torch.linspace(-0.5, 0.5, t.numel()))
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    _block_against_reference(jcfg, tcfg, tparams, layer,
                             common.LayerKind(kind, "dense"), pos, 10, s=40)


def test_zamba2_shared_block_matches_reference():
    """zamba2's shared site alone, prefill and then one decode step into
    its own ring at per-row depths, against ``jdec.block_apply``."""
    jcfg, tcfg, _, tparams = _setup("zamba2-1.2b", "float32", 11)
    kind = common.LayerKind("shared_attn", "dense")
    b, s, ring_len = 2, 7, 10
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    _block_against_reference(jcfg, tcfg, tparams, 2, kind, pos, 11, s=s)
    rng = np.random.default_rng(11)
    ring = {k: rng.standard_normal((b, ring_len, tcfg.n_kv_heads,
                                    tcfg.head_dim)).astype(np.float32)
            for k in ("k", "v")}
    depth = np.array([s, s - 2], np.int32)
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    shared, p = tparams["shared_attn"], tparams["layers"][2]
    want, jnew = jdec.block_apply(
        jcfg, JCTX, kind, _numpy_tree(p), _numpy_tree(shared),
        jnp.asarray(x), jnp.asarray(depth[:, None]),
        cache={"attn": {k: jnp.asarray(v) for k, v in ring.items()}},
        cache_index=jnp.asarray(depth), return_cache=True)
    tring = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    got, new = decoder.block_apply(
        tcfg, CTX, kind, p, torch.from_numpy(x),
        torch.from_numpy(depth[:, None]), shared_p=shared,
        cache={"attn": tring}, cache_index=torch.from_numpy(depth),
        return_cache=True)
    _close(got, want, TOL["float32"])
    for leaf in ("k", "v"):
        assert new["attn"][leaf] is tring[leaf]       # written in place
        _close(new["attn"][leaf], jnew["attn"][leaf], TOL["float32"])


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
    if "shared_attn" in params:
        walk(params["shared_attn"], common.param_shapes(cfg)["shared_attn"])
    # gemma's (1 + w) norms start at zero, every other norm at one
    assert torch.equal(params["final_norm"],
                       torch.full((cfg.d_model,),
                                  0.0 if cfg.gemma_norm else 1.0))
    # norms and the SSM's special leaves equal the reference's init
    # (common.py:477-497 there): its q/k norms stay one under gemma
    _, _, _, ref = _setup(arch, "float32", 0)
    special = set(common._NORM_NAMES) | {"A_log", "D", "dt_bias"}

    def same(p, r, name=""):
        if isinstance(p, dict):
            assert p.keys() == r.keys()
            for k in p:
                same(p[k], r[k], k)
        elif isinstance(p, list):
            for a, b in zip(p, r):
                same(a, b)
        elif name in special:
            torch.testing.assert_close(p, r, rtol=1e-6, atol=0)

    same(params, ref)
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
