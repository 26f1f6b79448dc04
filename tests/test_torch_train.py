"""repro_torch's training path held to repro's on the CPU.

Loss and gradients of every arch, the AdamW update, the train step with
microbatches, remat, checkpoints, compression and the training launcher.
Parameters come from ``repro.models.common.init_params`` and reach the
port through ``params_from_numpy``; the reference runs its plain functions
(``use_kernel="ref"``), and its gradients reach the port's layout the same
way.  Everything runs in float32, where the algorithms are compared (the
model stack's tolerance, 2e-3, here of each gradient leaf's largest
value).  The kernels' own backward runs on the card
(``test_torch_cuda.py``, ``chip_smoke.py``); here the autograd Functions
around them are run with the kernels' plain versions standing in.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import decoder as jdec
from repro.models.common import init_params as jinit_params
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import train as launch_train
from repro_torch.models import common, decoder
from repro_torch.train import checkpoint as ck
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from repro_torch.train.tree import (leaves, leaves_with_paths, tree_map,
                                    unflatten)

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("glm4-9b", "mamba2-780m", "phi4-mini-3.8b", "deepseek-v2-236b",
         "mixtral-8x7b", "zamba2-1.2b", "minitron-4b", "gemma3-27b",
         "qwen2-vl-2b", "hubert-xlarge")
JCTX = jdec.RunCtx(mesh=None, use_kernel="ref")
CTX = decoder.RunCtx(device="cpu")
LOSS_TOL = 1e-5          # relative, the loss
GRAD_TOL = 2e-3          # of each gradient leaf's largest |g|
OPT_TOL = 1e-6           # params, m and v after AdamW steps
STEP_LOSS_TOL = 1e-4     # the train step's losses over three steps


def _setup(arch, seed=0):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32")
    params = jinit_params(jcfg, jax.random.PRNGKey(seed))
    tparams = common.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                       "cpu")
    return jcfg, tcfg, params, tparams


def _data(cfg, b, s, step=0, seed=0):
    """One numpy batch of the synthetic pipeline (tokens or embeddings,
    labels, M-RoPE positions where the arch takes them)."""
    return JSyntheticLM(JDataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed,
        stub_frontend=cfg.family in ("vlm", "audio"), d_model=cfg.d_model,
        mrope=cfg.mrope_sections is not None)).batch(step)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _port(tcfg, jtree):
    """A reference tree (params or grads) in the port's layout."""
    return common.params_from_numpy(tcfg, jax.tree.map(np.asarray, jtree),
                                    "cpu")


def _close_leafwise(got, want, tol):
    for (path, g), w in zip(leaves_with_paths(got), leaves(want)):
        assert g.shape == w.shape, path
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol * scale + 1e-12, \
            f"{path}: |diff| {err} > {tol} x max|g| {scale}"


def _port_grads(tcfg, ctx, tparams, batch):
    p = tree_map(lambda a: a.clone().requires_grad_(True), tparams)
    loss, aux = decoder.loss_fn(tcfg, ctx, p, batch)
    flat = leaves(p)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(flat, grads)]
    return loss, aux, unflatten(tparams, grads)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """decoder.loss_fn and its gradients, every arch at its smoke config:
    the loss within 1e-5 relative, every gradient leaf within 2e-3 of its
    largest |g| (the reference's through jax.value_and_grad)."""
    jcfg, tcfg, params, tparams = _setup(arch, 3)
    batch = _data(tcfg, 2, 24, seed=3)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jdec.loss_fn(jcfg, JCTX, p, _jax(batch)), has_aux=True)(
            params)
    loss, aux, grads = _port_grads(tcfg, CTX, tparams, _torch(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    assert float(aux["ntokens"]) == float(jaux["ntokens"])
    _close_leafwise(grads, _port(tcfg, jgrads), GRAD_TOL)
    assert all(bool(torch.isfinite(g).all()) for g in leaves(grads))


def test_loss_ignores_negative_labels():
    """labels < 0 take no part: the mean is over the rest, and a batch with
    none left has loss 0 over a denominator of 1, as in the reference."""
    _, tcfg, _, tparams = _setup("glm4-9b")
    batch = _torch(_data(tcfg, 2, 16))
    logits = decoder.forward(tcfg, CTX, tparams, batch).float()
    labels = batch["labels"].long()
    keep = labels >= 0
    want = torch.nn.functional.cross_entropy(logits[keep], labels[keep])
    loss, aux = decoder.loss_fn(tcfg, CTX, tparams, batch)
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    assert int(aux["ntokens"]) == int(keep.sum())
    batch["labels"] = torch.full_like(batch["labels"], -1)
    loss, aux = decoder.loss_fn(tcfg, CTX, tparams, batch)
    assert float(loss) == 0.0 and float(aux["ntokens"]) == 0.0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "glm4-9b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads_equal_none(arch, remat):
    """remat recomputes the same ops: the gradients equal remat none's."""
    _, tcfg, _, tparams = _setup(arch, 4)
    batch = _torch(_data(tcfg, 2, 24, seed=4))
    _, _, want = _port_grads(tcfg, CTX, tparams, batch)
    ctx = decoder.RunCtx(device="cpu", remat=remat)
    loss, _, got = _port_grads(tcfg, ctx, tparams, batch)
    for (path, g), w in zip(leaves_with_paths(got), leaves(want)):
        assert torch.equal(g, w), path


def test_runctx_checks_remat():
    with pytest.raises(ValueError, match="remat"):
        decoder.RunCtx(device="cpu", remat="some")


def test_inference_entry_points_record_no_graph():
    """forward is differentiable, but parameters that do not require grad
    (init_params, the frozen Decoder) give outputs with no graph, and
    prefill / decode_step run without autograd."""
    _, tcfg, _, tparams = _setup("zamba2-1.2b")
    batch = _torch(_data(tcfg, 2, 8))
    assert decoder.forward(tcfg, CTX, tparams, batch).grad_fn is None
    p = tree_map(lambda a: a.clone().requires_grad_(True), tparams)
    assert decoder.forward(tcfg, CTX, p, batch).grad_fn is not None
    logits, _ = decoder.prefill(tcfg, CTX, p, batch)
    assert logits.grad_fn is None


# ---------------------------------------------------------------------------
# the kernels' autograd Functions
# ---------------------------------------------------------------------------

@pytest.fixture
def plain_launchers(monkeypatch):
    """The Functions' kernel launches replaced by the plain versions (run
    without autograd, as a kernel runs), so the Functions run here."""
    def attention(q, k, v, **kw):
        with torch.no_grad():
            return ref.sdpa_ref(q, k, v, **kw)

    def ssd(x, dt, a, b_mat, c_mat, *, chunk, h0):
        with torch.no_grad():
            y, final = ref.ssd_ref(x, dt, a, b_mat, c_mat, chunk=chunk, h0=h0)
        return y.to(x.dtype), final

    monkeypatch.setattr(tflash, "flash_attention", attention)
    monkeypatch.setattr(tssd, "ssd_scan", ssd)
    for k in ops.backward_recomputes:
        monkeypatch.setitem(ops.backward_recomputes, k, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_grads_are_the_plain_versions(plain_launchers,
                                                          dtype):
    """ops._Attention's backward: the plain version's input gradients,
    bit for bit, and one recompute counted per backward."""
    g = torch.Generator().manual_seed(0)
    b, s, hq, hkv, d = 2, 40, 4, 2, 16
    q, k, v = (torch.randn((b, s, h, d), generator=g).to(dtype)
               for h in (hq, hkv, hkv))
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s).contiguous()
    w = torch.randn((b, s, hq, d), generator=g)
    opts = dict(causal=True, sliding_window=None, logit_softcap=0.0,
                scale=None)

    def run(fn):
        leaves_ = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves_)
        return [out] + list(torch.autograd.grad((out.float() * w).sum(),
                                                leaves_))

    got = run(lambda q_, k_, v_: ops._Attention.apply(q_, k_, v_, pos, pos,
                                                      opts))
    want = run(lambda q_, k_, v_: ref.sdpa_ref(
        q_, k_, v_, q_positions=pos, kv_positions=pos, **opts))
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    assert sum(ops.backward_recomputes.values()) == 1
    name = tflash.variant(dtype, s, hq, hkv, d, d)
    assert ops.backward_recomputes[f"flash_attention.{name}"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_grads_are_the_plain_versions(plain_launchers, dtype):
    """ops._SSD's backward, through ops.ssd's padding: the plain
    version's input gradients (x, dt, A, B, C and h0), bit for bit, with
    the final state's gradient taken too."""
    g = torch.Generator().manual_seed(1)
    b, s, h, p, n, chunk = 2, 40, 4, 8, 16, 16
    x = torch.randn((b, s, h, p), generator=g).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    a = -torch.rand((h,), generator=g) - 0.5
    bm, cm = (torch.randn((b, s, 1, n), generator=g).to(dtype)
              for _ in range(2))
    h0 = torch.randn((b, h, p, n), generator=g)
    wy, wf = torch.randn((b, s, h, p), generator=g), torch.randn(h0.shape,
                                                                 generator=g)

    def run(fn):
        leaves_ = [t.clone().requires_grad_(True)
                   for t in (x, dt, a, bm, cm, h0)]
        y, final = fn(*leaves_)
        loss = (y.float() * wy).sum() + (final * wf).sum()
        return [y, final] + list(torch.autograd.grad(loss, leaves_))

    def plain(x_, dt_, a_, b_, c_, h0_):
        y, final = ops.ssd(x_, dt_, a_, b_, c_, chunk=chunk, h0=h0_,
                           plain=True)
        return y.to(x_.dtype), final

    def function(x_, dt_, a_, b_, c_, h0_):
        pad = (-s) % chunk
        xs = [ref.pad_seq(t, pad) for t in (x_, dt_, b_, c_)]
        y, final = ops._SSD.apply(xs[0], xs[1], a_, xs[2], xs[3], h0_, chunk)
        return y[:, :s], final

    got, want = run(function), run(plain)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
    name = tssd.variant(dtype, p, n, chunk)
    assert ops.backward_recomputes[f"ssd_scan.{name}"] == 1


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_decay_mask_follows_the_reference_layout():
    """The port's per-layer tree, masked as the reference masks its
    group-stacked one: a body Mamba layer's conv_b (2-D when stacked) is
    decayed, the same leaf in an unrolled suffix layer (1-D) is not."""
    jcfg, tcfg, params, _ = _setup("zamba2-1.2b")
    plan = common.layer_plan(tcfg)
    assert plan.suffix > 0 and tcfg.n_layers - 1 >= plan.suffix_start
    want = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32),
                        jopt._decay_mask(params), params)
    want = _port(tcfg, want)
    tparams = _port(tcfg, params)
    got = opt.decay_mask(tparams, ts.body_layers(tcfg))
    for (path, m), w in zip(leaves_with_paths(got), leaves(want)):
        assert bool((w == m).all()), path
    layers = got["layers"]
    body_mamba = next(i for i in ts.body_layers(tcfg)
                      if "mamba" in layers[i])
    assert layers[body_mamba]["mamba"]["conv_b"] == 1.0
    assert layers[plan.suffix_start]["mamba"]["conv_b"] == 0.0
    assert layers[body_mamba]["mamba"]["A_log"] == 0.0


def test_optimizer_update_matches_reference():
    """Two AdamW steps fed the same numpy gradients: params, m and v
    within 1e-6 of the reference's, the count, lr and grad norm too."""
    jcfg, tcfg, params, tparams = _setup("zamba2-1.2b", 5)
    rng = np.random.default_rng(5)
    cfg = jopt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                         clip_norm=0.5)
    tcfg_opt = opt.OptConfig(**dataclasses.asdict(cfg))
    jstate, tstate = jopt.init(params), opt.init(tparams)
    for _ in range(2):
        jg = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), params)
        params, jstate, jm = jopt.update(cfg, params, jg, jstate)
        tparams, tstate, tm = opt.update(tcfg_opt, tparams, _port(tcfg, jg),
                                         tstate, body=ts.body_layers(tcfg))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=OPT_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=OPT_TOL)
    assert int(tstate.count) == int(jstate.count) == 2
    for got, want in ((tparams, params), (tstate.m, jstate.m),
                      (tstate.v, jstate.v)):
        for (path, g), w in zip(leaves_with_paths(got),
                                leaves(_port(tcfg, want))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=OPT_TOL,
                                       atol=OPT_TOL, err_msg=str(path))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_schedule_matches_reference(schedule):
    cfg = jopt.OptConfig(warmup_steps=10, total_steps=50, schedule=schedule)
    tcfg = opt.OptConfig(**dataclasses.asdict(cfg))
    for step in (0, 5, 9, 10, 30, 49, 80):
        np.testing.assert_allclose(
            float(opt.schedule_lr(tcfg, torch.tensor(step, dtype=torch.int32))),
            float(jopt.schedule_lr(cfg, jnp.asarray(step, jnp.int32))),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-1.2b", "qwen2-vl-2b"])
def test_train_step_matches_reference(arch, microbatches):
    """Three train steps (fp32 masters, the compute dtype's cast, AdamW),
    with and without gradient accumulation (qwen2-vl's M-RoPE positions
    split along their batch axis): losses within 1e-4."""
    jcfg, tcfg, params, tparams = _setup(arch, 6)
    ocfg = jopt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    jstep = jax.jit(jts.make_train_step(jcfg, JCTX, jts.TrainConfig(
        opt=ocfg, microbatches=microbatches)))
    tstep = ts.make_train_step(tcfg, CTX, ts.TrainConfig(
        opt=opt.OptConfig(**dataclasses.asdict(ocfg)),
        microbatches=microbatches))
    jstate, tstate = jopt.init(params), opt.init(tparams)
    for step in range(3):
        batch = _data(tcfg, 4, 16, step=step, seed=6)
        params, jstate, jm = jstep(params, jstate, _jax(batch))
        tparams, tstate, tm = tstep(tparams, tstate, _torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=STEP_LOSS_TOL)


def test_microbatches_split_positions_on_their_batch_axis():
    b, s = 4, 6
    batch = {"embeds": torch.zeros(b, s, 3), "labels": torch.zeros(b, s),
             "positions": torch.arange(b)[None, :, None].expand(3, b, s)}
    parts = ts._split(batch, 2)
    assert [tuple(p["positions"].shape) for p in parts] == [(3, 2, s)] * 2
    assert parts[1]["positions"][0, :, 0].tolist() == [2, 3]
    assert tuple(parts[1]["embeds"].shape) == (2, s, 3)


def test_eval_step():
    _, tcfg, _, tparams = _setup("glm4-9b")
    batch = _torch(_data(tcfg, 2, 16))
    aux = ts.make_eval_step(tcfg, CTX)(tparams, batch)
    loss, _ = decoder.loss_fn(tcfg, CTX, tparams, batch)
    assert float(aux["loss"]) == float(loss) and aux["loss"].grad_fn is None


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(3.5),
                  "e": torch.randn((4,), generator=g).to(torch.bfloat16)},
            "l": [torch.ones(2), opt.OptState(torch.zeros(3), torch.ones(3),
                                              torch.tensor(7))]}


def _equal(a, b):
    for (path, x), y in zip(leaves_with_paths(a), leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ck.save(tmp_path, 7, t)
    got, step = ck.restore(tmp_path, _tree(1))
    assert step == 7
    _equal(got, t)
    assert isinstance(got["l"][1], opt.OptState)
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 7 and len(manifest["leaves"]) == 8


def test_uncommitted_checkpoint_is_ignored(tmp_path):
    """A step directory without its .COMMITTED marker (a crash between the
    rename and the marker) and a leftover .tmp are not restored."""
    ck.save(tmp_path, 1, _tree(1))
    ck.save(tmp_path, 2, _tree(2))
    (tmp_path / "step_00000002.COMMITTED").unlink()
    (tmp_path / "step_00000003.tmp").mkdir()
    assert ck.committed_steps(tmp_path) == [1]
    got, step = ck.restore(tmp_path, _tree())
    assert step == 1
    _equal(got, _tree(1))
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path / "empty", _tree())


def test_restore_refuses_another_tree(tmp_path):
    ck.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="another tree"):
        ck.restore(tmp_path, {"a": torch.zeros(8, 16)})


def test_prune_keeps_newest(tmp_path):
    for s in range(5):
        ck.save(tmp_path, s, _tree(s))
    ck.prune(tmp_path, keep=2)
    assert ck.committed_steps(tmp_path) == [3, 4]
    assert not (tmp_path / "step_00000000").exists()


def test_async_checkpointer_copies_before_the_tree_changes(tmp_path):
    """submit copies to host at once: an in-place update after it (as the
    optimizer makes) does not reach the checkpoint; close joins the
    worker."""
    w = ck.AsyncCheckpointer(tmp_path, keep=2)
    t = _tree()
    for s in (1, 2, 3):
        w.submit(s, t)
        t["a"].add_(1.0)
    w.close()
    assert not w._thread.is_alive()
    assert ck.committed_steps(tmp_path) == [2, 3]
    got, _ = ck.restore(tmp_path, _tree(), step=3)
    torch.testing.assert_close(got["a"], _tree()["a"] + 2.0)


def test_async_checkpointer_surfaces_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    w = ck.AsyncCheckpointer(blocker / "sub")
    w.submit(1, _tree())
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        w.close()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(tmp, *extra):
    return launch_train.main(["--device", "cpu", "--arch", "zamba2-1.2b",
                              "--preset", "smoke", "--batch", "2", "--seq",
                              "32", "--log-every", "100", "--ckpt-dir",
                              str(tmp), "--ckpt-every", "3", *extra])


def test_launch_train_resume_equals_straight(tmp_path):
    """3 steps, then a resume to 6, equal 6 straight steps bit for bit:
    the losses of steps 3-5 and every leaf of the step-6 checkpoint."""
    straight = _launch(tmp_path / "a", "--steps", "6")
    first = _launch(tmp_path / "b", "--steps", "3")
    resumed = _launch(tmp_path / "b", "--steps", "6", "--resume")
    assert straight["steps"] == 6 and first["steps"] == 3
    assert resumed["steps"] == 3
    assert first["losses"] == straight["losses"][:3]
    assert resumed["losses"] == straight["losses"][3:]
    assert all(np.isfinite(straight["losses"]))
    assert straight["step_s"] > 0 and straight["peak_mem_gb"] is None
    for i in range(len(list((tmp_path / "a" / "step_00000006")
                            .glob("leaf_*.npy")))):
        a = np.load(tmp_path / "a" / "step_00000006" / f"leaf_{i:05d}.npy")
        b = np.load(tmp_path / "b" / "step_00000006" / f"leaf_{i:05d}.npy")
        assert np.array_equal(a, b), i


@pytest.mark.parametrize("preset", ["smoke", "p100m", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scaled_config_matches_reference(arch, preset):
    from repro.launch.train import scaled_config as jscaled
    assert dataclasses.asdict(launch_train.scaled_config(arch, preset)) == \
        dataclasses.asdict(jscaled(arch, preset))


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--preset", "smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# compression and data (mirroring tests/test_checkpoint_data.py)
# ---------------------------------------------------------------------------

def test_compression_error_feedback_converges():
    """Accumulated dequantized sums track the true sums (error feedback),
    and each step equals the reference's."""
    rng = np.random.default_rng(0)
    g_stream = [(rng.standard_normal(256) * 0.01).astype(np.float32)
                for _ in range(50)]
    res, jres = torch.zeros(256), jnp.zeros(256, jnp.float32)
    acc = torch.zeros(256)
    for g in g_stream:
        c, res = comp.compress(torch.from_numpy(g), res)
        jc, jres = jcomp.compress(jnp.asarray(g), jres)
        np.testing.assert_array_equal(c.q.numpy(), np.asarray(jc.q))
        np.testing.assert_allclose(res.numpy(), np.asarray(jres), atol=1e-9)
        acc = acc + comp.decompress(c)
    true = sum(g_stream)
    err = np.abs(acc.numpy() - true).max()
    assert err < 2 * float(res.abs().max() + 1e-6) + 1e-3


def test_compression_wire_dtype_is_int8():
    c, _ = comp.compress(torch.ones(16) * 0.5, torch.zeros(16))
    assert c.q.dtype == torch.int8
    np.testing.assert_allclose(comp.decompress(c).numpy(), 0.5, rtol=1e-2)


def test_compression_tree_roundtrip():
    t = {"w": torch.randn(8, 4), "b": [torch.randn(3), torch.randn(5)]}
    comp_t, res = comp.compress_tree(t, comp.init_residuals(t))
    back = comp.decompress_tree(comp_t)
    for (path, x), y, r in zip(leaves_with_paths(t), leaves(back),
                               leaves(res)):
        torch.testing.assert_close(y + r, x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rel", ["data/pipeline.py", "data/__init__.py"])
def test_data_pipeline_is_a_pinned_copy(rel):
    assert (REPO / "src/repro_torch" / rel).read_text() == \
        (REPO / "src/repro" / rel).read_text()


def test_data_batches_match_reference():
    cfg = dict(vocab_size=512, seq_len=16, global_batch=4, seed=2,
               stub_frontend=True, d_model=8, mrope=True)
    a, b = SyntheticLM(DataConfig(**cfg)), JSyntheticLM(JDataConfig(**cfg))
    for step in (0, 7):
        x, y = a.batch(step), b.batch(step)
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
