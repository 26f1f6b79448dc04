"""Tensor parallelism of the dense stack in gloo worlds, held to GSPMD.

Each rank holds only its blocks of the leaves that
``repro_torch.dist.sharding.param_pspecs`` shards (``shard_params``) and
computes the same function as the reference's GSPMD run, which
partitions the same parameters under ``repro.dist.sharding.
param_shardings`` on a ``(2, 4)`` ``("data", "model")`` mesh of 8 host
devices.  The reference runs once, in four children with ``XLA_FLAGS`` (two cases
each: its compiles are the slow part); the port once, in an 8-rank gloo
world (``tests/torch_gloo.py``'s ``tp8``).
Both take the same seeded parameters (the reference's layout, drawn as
``init_params`` draws them, through numpy) and the same numpy inputs, in
f32: forward logits, prefill and two decode steps, one
train step.  The cases cover kv heads split inside a head (glm4-9b's 2
kv heads on 4 ranks), tied vocab-parallel logits with local/global
attention (gemma3), Mamba2's concatenated ``w_in`` (mamba2, zamba2 with
its shared attention block), MLA with shared experts (deepseek-v2),
``embeds`` with M-RoPE (qwen2-vl), an encoder (hubert), and q heads the
model axis does not divide (glm4-9b's 4 heads on a ``(1, 8)`` mesh: the
sequence-parallel path over a gathered ``wq``).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_gloo

SRC = str(Path(__file__).resolve().parents[1] / "src")

CASES = [("glm4", "glm4-9b", (2, 4)),
         ("gemma3", "gemma3-27b", (2, 4)),
         ("mamba2", "mamba2-780m", (2, 4)),
         ("zamba2", "zamba2-1.2b", (2, 4)),
         ("deepseek", "deepseek-v2-236b", (2, 4)),
         ("qwen2vl", "qwen2-vl-2b", (2, 4)),
         ("hubert", "hubert-xlarge", (2, 4)),
         ("split", "glm4-9b", (1, 8))]
CAUSAL = [c for c in CASES if c[0] != "hubert"]
B, S = 4, 16

REFERENCE = """
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_smoke_config
    from repro.dist import sharding as shd
    from repro.models import decoder
    from repro.train import optimizer as opt
    from repro.train.train_step import TrainConfig, make_train_step

    inp = dict(np.load(sys.argv[1]))
    cases = json.loads(sys.argv[3])
    out = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, prefix + "/" + k if prefix else k)
        else:
            out[tag + "|trained|" + prefix] = np.asarray(tree)

    def nested(prefix):
        tree = {}
        for key, arr in inp.items():
            if key.startswith(prefix):
                *path, leaf = key[len(prefix):].split("/")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(arr)
        return tree

    for tag, arch, shape in cases:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        mesh = Mesh(np.array(jax.devices()).reshape(shape),
                    ("data", "model"))
        params = nested(tag + "|params|")
        ps = shd.param_shardings(cfg, mesh)
        put = lambda t: jax.tree.map(jax.device_put, t, ps)
        ctx = decoder.RunCtx(mesh=mesh, batch_axes=("data",),
                             use_kernel="ref", capacity_factor=8.0)
        batch = {k.split("|")[2]: jnp.asarray(v) for k, v in inp.items()
                 if k.startswith(tag + "|batch|")}
        fwd = {k: v for k, v in batch.items() if k != "labels"}
        out[tag + "|fwd"] = jax.jit(
            lambda p, b: decoder.forward(cfg, ctx, p, b))(put(params), fwd)
        if cfg.causal:
            logits, cache = jax.jit(
                lambda p, b: decoder.prefill(cfg, ctx, p, b))(put(params),
                                                             fwd)
            out[tag + "|prefill"] = logits
            ring = decoder.init_cache(cfg, 4, 20, jnp.float32)
            ring = jax.tree.map(
                lambda r, c: r.at[tuple(slice(0, n) for n in c.shape)].set(c),
                ring, cache)
            step = jax.jit(lambda p, c, t, pos: decoder.decode_step(
                cfg, ctx, p, c, t, pos))
            for j, tok in enumerate(inp[tag + "|dec"]):
                lg, ring = step(put(params), ring, jnp.asarray(tok),
                                jnp.int32(16 + j))
                out[tag + "|dec%d" % j] = lg
        state = opt.init(params)
        state = opt.OptState(m=put(state.m), v=put(state.v),
                             count=state.count)
        p1, _, m = jax.jit(make_train_step(cfg, ctx, TrainConfig()))(
            put(params), state, batch)
        out[tag + "|loss"] = m["loss"]
        flat(p1, "")
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _params(inp: dict, tag: str, cfg, model_size: int, seed: int) -> None:
    """The reference's parameter tree (group-stacked, experts chunked at
    ``model_size``) drawn leaf by leaf as ``init_params`` draws it, seeded,
    as ``inp["<tag>|params|a/b/c"]`` numpy leaves."""
    import torch

    from repro_torch.models import common

    gen = torch.Generator().manual_seed(seed)

    def draw(tree, path, name):
        if isinstance(tree, dict):
            for k, v in tree.items():
                draw(v, f"{path}/{k}" if path else k, k)
        else:
            inp[f"{tag}|params|{path}"] = common._init_leaf(
                name, tuple(tree), cfg, gen, "cpu", torch.float32).numpy()

    draw(common.param_shapes(cfg, model_size), "", "")


def _inputs(path: Path) -> None:
    from repro_torch.configs import get_smoke_config

    rng = np.random.default_rng(24)
    inp = {}
    for i, (tag, arch, shape) in enumerate(CASES):
        cfg = get_smoke_config(arch)
        _params(inp, tag, cfg, shape[1], i)
        if cfg.family in ("vlm", "audio"):
            inp[f"{tag}|batch|embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        else:
            inp[f"{tag}|batch|tokens"] = rng.integers(
                0, cfg.vocab_size, (B, S), dtype=np.int32)
        if cfg.mrope_sections is not None:
            pos = np.arange(S, dtype=np.int32)[None, None, :] + \
                rng.integers(0, 3, (3, B, 1), dtype=np.int32)
            inp[f"{tag}|batch|positions"] = pos
        inp[f"{tag}|batch|labels"] = rng.integers(
            0, cfg.vocab_size, (B, S), dtype=np.int32)
        inp[f"{tag}|dec"] = rng.integers(0, cfg.vocab_size, (2, B),
                                         dtype=np.int32)
    np.savez(path, **inp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the port's 8 ranks), once for the file."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs = tmp / "inputs.npz"
    _inputs(inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    # the reference's compiles dominate: four children share the cases
    outs = [tmp / f"reference{i}.npz" for i in range(4)]
    children = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(inputs),
         str(out), json.dumps(CASES[i::4])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, out in enumerate(outs)]
    port = torch_gloo.run_world("tp8", 8, inputs=str(inputs),
                                cases=[list(c) for c in CASES],
                                ckpt=str(tmp / "ckpt"))
    ref = {}
    for child, out in zip(children, outs):
        _, err = child.communicate(timeout=600)
        assert child.returncode == 0, err
        ref.update(np.load(out))
    return ref, port


def _rel(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))
                 / (np.max(np.abs(b)) + 1e-9))


def _same_on_every_rank(port: list, key: str) -> np.ndarray:
    for r in port[1:]:
        np.testing.assert_array_equal(r[key], port[0][key])
    return port[0][key]


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_tp_forward_matches_gspmd(runs, tag):
    """Global logits of the tensor-parallel forward within 2e-4 of the
    largest of the reference's GSPMD run, the same on every rank."""
    ref, port = runs
    got = _same_on_every_rank(port, f"{tag}|fwd")
    assert got.shape == ref[f"{tag}|fwd"].shape
    assert _rel(got, ref[f"{tag}|fwd"]) < 2e-4


@pytest.mark.parametrize("tag", [c[0] for c in CAUSAL])
def test_tp_prefill_and_decode_match_gspmd(runs, tag):
    """The prefill's last logits and two decode steps over the prompt's
    cache moved into longer rings (each rank's blocks of them), within
    2e-4 of the reference's."""
    ref, port = runs
    for key in ("prefill", "dec0", "dec1"):
        got = _same_on_every_rank(port, f"{tag}|{key}")
        assert _rel(got, ref[f"{tag}|{key}"]) < 2e-4, key


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_tp_train_step_matches_gspmd(runs, tag):
    """One train step: the loss within 1e-4 and every trained leaf,
    gathered whole from the ranks' blocks, within atol 3e-5 / rtol 3e-4
    of the reference's (tests/test_sharded.py's bands)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import params_from_numpy
    from repro_torch.train.tree import leaves

    ref, port = runs
    assert abs(float(port[0][f"{tag}|loss"])
               - float(ref[f"{tag}|loss"])) < 1e-4
    arch = next(a for t, a, _ in CASES if t == tag)
    want = params_from_numpy(get_smoke_config(arch),
                             torch_gloo._nested(ref, f"{tag}|trained|"),
                             "cpu")
    want = torch.cat([t.reshape(-1) for t in leaves(want)]).numpy()
    got = _same_on_every_rank(port, f"{tag}|trained")
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-4)


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_tp_ranks_hold_only_their_blocks(runs, tag):
    """Each rank's parameter bytes are the sum of its local shapes under
    param_pspecs, below the whole tree's, with at least one sharded leaf;
    and a checkpoint saved from the blocks (gathered whole, written by
    rank 0) restores each rank's blocks bit for bit."""
    _, port = runs
    for r in port:
        held, local, whole, n_blocks = r[f"{tag}|bytes"]
        assert held == local < whole
        assert n_blocks > 0
        assert float(r[f"{tag}|restored"]) == 0.0


@pytest.mark.parametrize("arch", ["glm4-9b", "deepseek-v2-236b"])
def test_init_params_on_a_mesh_draws_the_whole_trees_blocks(runs, arch):
    """``init_params(mesh=)`` (each leaf drawn whole and cut at once, so a
    rank never holds the whole tree) gives every rank exactly its blocks
    of ``init_params``' tree from the same seed, experts chunked."""
    _, port = runs
    for r in port:
        assert bool(r[f"init|{arch}"])
