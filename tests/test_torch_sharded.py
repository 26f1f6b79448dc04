"""The port's mesh paths in gloo worlds on the CPU, held to the reference.

Each case mirrors one of ``tests/test_sharded.py``.  The inputs come from
a numpy seed; the reference's side runs once, in a child process with 8
host devices (``XLA_FLAGS``, as ``tests/test_sharded.py`` runs it), and
the port's side once, in an 8-rank gloo world
(``tests/torch_gloo.py``'s ``sharded8``) plus a 4-rank one (``train4``).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_gloo

SRC = str(Path(__file__).resolve().parents[1] / "src")

REFERENCE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np, dataclasses
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.configs import get_smoke_config
    from repro.models import moe
    from repro.models.common import ModelConfig, MoEConfig
    from repro.train.compression import compressed_psum

    inp = dict(np.load(sys.argv[1]))
    out = {}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))

    def params(prefix, model_size):
        wg, wu, wd = (jnp.asarray(inp[prefix + "_" + k])
                      for k in ("wg", "wu", "wd"))
        cg, cu, cd = moe.to_chunked(wg, wu, wd, model_size=model_size)
        return {"router": jnp.asarray(inp[prefix + "_router"]),
                "experts": {"w_gate": cg, "w_up": cu, "w_down": cd}}

    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              dtype="float32")
    p4 = params("mix", 4)
    with mesh:
        for cf in (8.0, 1.0):
            x = jnp.asarray(inp["mix_x%d" % cf])
            out["rep%d" % cf] = moe.moe_sharded(
                p4, x, cfg, mesh, batch_axes=("data",), capacity_factor=cf)
            out["a2a%d" % cf] = moe.moe_sharded_a2a(
                p4, x, cfg, mesh, batch_axes=("data",), capacity_factor=cf)
        for style, mc in (
                ("mixtral", MoEConfig(n_experts=8, top_k=2, d_expert=64)),
                ("deepseek", MoEConfig(n_experts=2, top_k=2, d_expert=128))):
            scfg = ModelConfig(name=style, family="moe", n_layers=1,
                               d_model=32, n_heads=2, n_kv_heads=2,
                               head_dim=16, d_ff=64, vocab_size=64,
                               dtype="float32", moe=mc)
            out["tp_" + style] = moe.moe_apply(
                params(style, 4), jnp.asarray(inp[style + "_x"]), scfg,
                mesh, dispatch="a2a", batch_axes=("data",),
                capacity_factor=8.0)
        out["ragged"] = moe.moe_apply(
            p4, jnp.asarray(inp["ragged_x"]), cfg, mesh, dispatch="a2a",
            batch_axes=("data",), capacity_factor=8.0)

    pmesh = Mesh(np.array(jax.devices()).reshape(8,), ("data",))

    def body(g, r):
        o, new_r = compressed_psum(g[0], r[0], "data")
        return o[None], new_r[None]

    g = jnp.asarray(inp["psum_g"])
    o, r = shard_map(body, mesh=pmesh,
                     in_specs=(P("data", None), P("data", None)),
                     out_specs=(P("data", None), P("data", None)),
                     check_rep=False)(g, jnp.zeros_like(g))
    out["psum"], out["psum_res"] = o, r
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _inputs(path: Path) -> None:
    """Every input of the file's cases, from numpy seeds (the reference's
    test seeds where it has them)."""
    rng = np.random.default_rng(0)
    d, e, f = 64, 4, 128                      # mixtral smoke: d, experts, f
    inp = {"mix_router": rng.standard_normal((d, e)) * 0.1,
           "mix_wg": rng.standard_normal((e, d, f)) * 0.05,
           "mix_wu": rng.standard_normal((e, d, f)) * 0.05,
           "mix_wd": rng.standard_normal((e, f, d)) * 0.05,
           "mix_x8": rng.standard_normal((4, 16, d)),
           "mix_w": rng.standard_normal((4, 16, d)),
           "ragged_x": rng.standard_normal((4, 15, d)),
           # 32 tokens a rank: enough for the a2a path's 16-row expert
           # blocks to overflow at capacity factor 1
           "mix_x1": rng.standard_normal((4, 64, d))}
    rng = np.random.default_rng(2)
    for style, (ne, fe) in (("mixtral", (8, 64)), ("deepseek", (2, 128))):
        inp[f"{style}_router"] = rng.standard_normal((32, ne)) * 0.1
        inp[f"{style}_wg"] = rng.standard_normal((ne, 32, fe)) * 0.05
        inp[f"{style}_wu"] = rng.standard_normal((ne, 32, fe)) * 0.05
        inp[f"{style}_wd"] = rng.standard_normal((ne, fe, 32)) * 0.05
        inp[f"{style}_x"] = rng.standard_normal((8, 16, 32))
    inp["psum_g"] = np.random.default_rng(0).standard_normal((8, 128)) * 0.01
    rng = np.random.default_rng(4)
    c, n = 32, 8
    inp["rates"] = rng.gamma(1.0, 1.0, (c, n)) * (rng.random((c, n)) < 0.6)
    inp["owner"] = np.where(rng.random(c) < 0.9, rng.integers(0, n, c), -1)
    inp["fwd"] = rng.random(c) * 1e-3
    inp["move"] = rng.random(c) * 1e-2
    inp["cpu"] = rng.random(n)
    inp["co_rates"] = rng.random((c, c)) * (rng.random((c, c)) < 0.2)
    np.savez(path, **{k: (np.asarray(v, np.float32)
                          if np.asarray(v).dtype.kind == "f"
                          else np.asarray(v, np.int32))
                      for k, v in inp.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, the port's 8-rank results, the
    port's 4-rank results), each computed once for the file."""
    tmp = tmp_path_factory.mktemp("sharded")
    inputs, ref_out = tmp / "inputs.npz", tmp / "reference.npz"
    _inputs(inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(inputs),
         str(ref_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port8 = torch_gloo.run_world("sharded8", 8, inputs=str(inputs))
    port4 = torch_gloo.run_world("train4", 4)
    _, err = child.communicate(timeout=300)
    assert child.returncode == 0, err
    return (dict(np.load(inputs)), dict(np.load(ref_out)), port8, port4)


def _rel(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))
                 / (np.max(np.abs(b)) + 1e-9))


def _same_on_every_rank(ranks: list, key: str) -> np.ndarray:
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("path", ["rep", "a2a"])
@pytest.mark.parametrize("cf", [8, 1])
def test_moe_sharded_paths_match_reference(runs, path, cf):
    """moe_sharded / moe_sharded_a2a on the (2, 4) mesh against the
    reference's same function on the same mesh, without drops (capacity
    factor 8) and with them (1.0): the same capacity, slot order and
    drops, in f32 at 2e-4 of max |y|.  Every rank returns the global
    result."""
    _, ref, port8, _ = runs
    got = _same_on_every_rank(port8, f"{path}{cf}")
    assert got.shape == ref[f"{path}{cf}"].shape
    assert _rel(got, ref[f"{path}{cf}"]) < 2e-4
    oracle = _rel(got, port8[0][f"mix_ref{cf}"])
    assert oracle < 2e-4 if cf == 8 else oracle > 1e-2   # drops at 1.0


def test_moe_a2a_autotune_picks_it_and_caches_the_cell(runs):
    """moe_apply's auto dispatch on the mesh: the serving-size cell (8
    tokens a rank, ep 4) prices token a2a, its verdict is cached under the
    reference's key, and the output is the oracle's."""
    _, _, port8, _ = runs
    r0 = port8[0]
    assert tuple(r0["auto_key"][:2]) == (8, 4) and bool(r0["auto_verdict"])
    assert _rel(_same_on_every_rank(port8, "auto8"), r0["mix_ref8"]) < 2e-4


@pytest.mark.parametrize("style", ["mixtral", "deepseek"])
def test_moe_a2a_tp_chunks_match_dense_reference(runs, style):
    """tp-aware a2a: mixtral-style (ep 4, tp 1) and deepseek-style (2
    experts on 4 ranks: ep 2, tp 2).  Against the reference's a2a at f32
    tolerance, and against the port's dense oracle as the reference holds
    its own: tp 1 bit for bit (no psum leg), tp 2 at 1e-6 of max |y| (one
    float reassociation across the partial sums)."""
    _, ref, port8, _ = runs
    got = _same_on_every_rank(port8, f"tp_{style}")
    assert _rel(got, ref[f"tp_{style}"]) < 2e-4
    if style == "mixtral":
        np.testing.assert_array_equal(got, port8[0][f"tp_{style}_ref"])
    else:
        assert _rel(got, port8[0][f"tp_{style}_ref"]) < 1e-6


def test_moe_a2a_ragged_tokens_pad_not_fallback(runs):
    """4 x 15 = 60 tokens on the 8-way shard grid pad to 64 and mask the
    pad rows: the forced a2a path still equals the oracle and the
    reference."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    class Mesh24:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (2, 4)[i]

    cfg = get_smoke_config("mixtral-8x7b")
    shards, ep, tp, t_pad = moe._a2a_plan(cfg, 60, Mesh24(), ("data",),
                                          "model")
    assert (shards, t_pad) == (8, 64)
    _, ref, port8, _ = runs
    got = _same_on_every_rank(port8, "ragged")
    assert got.shape == (4, 15, 64)
    assert _rel(got, ref["ragged"]) < 2e-4
    np.testing.assert_array_equal(got, port8[0]["ragged_ref"])


@pytest.mark.parametrize("path", ["rep", "a2a"])
def test_moe_sharded_gradients_are_the_oracles(runs, path):
    """Training through the sharded paths: each rank's gradients, summed
    over the data axis (and expert chunks over the model axis, as the
    train step sums them), equal the dense oracle's (no drops)."""
    _, _, port8, _ = runs
    r = port8[3]
    for k in ("gx", "grouter", "gwg", "gwu", "gwd"):
        assert _rel(r[f"{path}_{k}"], r[f"ref_{k}"]) < 1e-5, k


def test_dispatch_verdict_cache_and_flip():
    """The verdict of a cell is priced once and cached under the
    reference's key; token traffic scales with the batch and weight
    traffic does not, so it flips to replication at 10,000 tokens a rank.
    Equal to the reference's verdicts."""
    from repro.models import moe as jmoe
    from repro.configs import get_smoke_config as jsmoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    cfg = get_smoke_config("mixtral-8x7b")
    moe._DISPATCH_CACHE.clear()
    assert moe.dispatch_verdict(cfg, 8, 4) is True
    (key,) = moe._DISPATCH_CACHE
    assert key[:2] == (8, 4)
    assert moe.dispatch_verdict(cfg, 8, 4) is True
    assert len(moe._DISPATCH_CACHE) == 1
    assert moe.dispatch_verdict(cfg, 10_000, 4) is False
    jcfg = jsmoke("mixtral-8x7b")
    for t, ep, tp in ((8, 4, 1), (10_000, 4, 1), (64, 2, 2), (4096, 8, 1)):
        assert moe.dispatch_verdict(cfg, t, ep, tp) == \
            jmoe.dispatch_verdict(jcfg, t, ep, tp)


def test_compressed_psum_matches_reference_bitwise(runs):
    """The int8 all-reduce over 8 ranks (one gradient row each) gives the
    reference's shard_map result bit for bit: the mean on every rank and
    each rank's residual."""
    _, ref, port8, _ = runs
    for r, res in enumerate(port8):
        np.testing.assert_array_equal(res["psum"], ref["psum"][r])
        np.testing.assert_array_equal(res["psum_res"], ref["psum_res"][r])
    true_mean = runs[0]["psum_g"].mean(axis=0)
    np.testing.assert_allclose(port8[0]["psum"], true_mean, atol=5e-4)


@pytest.mark.parametrize("case,shape", [("train41", (4, 1)),
                                        ("train42", (4, 2)),
                                        ("seqpar", (1, 4)),
                                        ("moe22", (2, 2))])
def test_mesh_train_step_matches_single_device(runs, case, shape):
    """One train step of glm4 (f32) on the mesh against the port's
    single-device step: loss within 1e-4, parameters within atol 3e-5 and
    rtol 3e-4 (the reference's test_sharded_train_step bands).  ``seqpar``
    gives glm4 six heads on a four-rank model axis: its attention runs
    sequence-parallel.  ``moe22`` is mixtral's smoke config with its
    experts chunked over a model axis of 2 (the sharded MoE paths under
    autograd)."""
    _, _, port8, port4 = runs
    res = port8[0] if case == "train42" else port4[0]
    assert abs(float(res[f"{case}_one_loss"])
               - float(res[f"{case}_mesh_loss"])) < 1e-4
    np.testing.assert_allclose(res[f"{case}_mesh_params"],
                               res[f"{case}_one_params"], atol=3e-5,
                               rtol=3e-4)
    ranks = port8 if case == "train42" else port4
    _same_on_every_rank(ranks, f"{case}_mesh_params")


@pytest.mark.parametrize("arch", ["glm4", "deepseek"])
def test_seq_sharded_decode_matches_single_device(runs, arch):
    """Two decode steps over rings cut into 4 seq chunks (glm4 on (1, 4, 2)
    with its kv heads over the model axis, deepseek-v2's MLA latent cache
    on (2, 4, 1)) equal the single-device steps within 2e-4; each rank's
    ring holds 32 / 4 positions.  A prefill on the mesh leaves each rank
    its block of the single-device prompt cache."""
    _, _, port8, _ = runs
    r0 = port8[0]
    assert r0[f"{arch}_ring"][1] == 8
    if arch == "glm4":
        assert r0[f"{arch}_ring"][2] == 1          # 2 kv heads / model 2
    for step in ("got1", "got"):
        got = _same_on_every_rank(port8, f"{arch}_{step}")
        want = r0[f"{arch}_{step.replace('got', 'ref')}"]
        assert float(np.max(np.abs(got - want))) < 2e-4, step
    # a prefill of 4 x 8 tokens on the same mesh: the global logits, and
    # every rank's block of the prompt cache (seq chunks of 2, kv heads)
    for r in port8:
        logits_err, cache_err = r[f"{arch}_prefill"]
        assert logits_err < 2e-4 and cache_err < 2e-4


@pytest.mark.parametrize("mesh,shards", [("181", 8.0), ("241", 4.0)])
def test_seq_sharded_migrate_roundtrip(runs, mesh, shards):
    """A session exported from a store on a seq mesh and imported into
    another slot of another store decodes as it did: on (1, 8, 1) (the
    reference's case: glm4's store reports seq_shards 8 and the blob
    carries it, a mamba2 store reports 1) and on (2, 4, 1), where the
    slots are also cut over the data axis and the column's chunks are
    broadcast from the rank that holds its slot.  The column's bytes are
    the unsharded store's."""
    _, _, port8, _ = runs
    for r in port8:
        assert r[f"mig{mesh}_slots"][0] != r[f"mig{mesh}_slots"][1]
        np.testing.assert_allclose(r[f"mig{mesh}_dst"], r[f"mig{mesh}_src"],
                                   rtol=1e-4, atol=1e-4)
        assert list(r[f"mig{mesh}_seq_shards"]) == [shards, shards, 1.0]
        assert r[f"mig{mesh}_ring"][1] == 64 // shards
        assert r[f"mig{mesh}_nbytes"][0] == r[f"mig{mesh}_nbytes"][1]


@pytest.mark.parametrize("co", [0.0, 0.5])
def test_sharded_scorer_is_bitwise_score_moves_np(runs, co):
    """The planner's scores with the classes split over an 8-rank plan mesh
    (make_plan_mesh) equal the reference's numpy twin bit for bit, on
    every rank."""
    from repro.plan.score import score_moves_np

    inp, _, port8, _ = runs
    assert int(port8[0]["plan_mesh"]) == 8
    want = score_moves_np(inp["rates"], inp["owner"], inp["fwd"],
                          inp["move"], inp["cpu"], horizon_ms=50.0,
                          min_frac=0.1, load_gain=0.3, co_gain=co,
                          co_rates=inp["co_rates"])
    np.testing.assert_array_equal(
        _same_on_every_rank(port8, f"scores_co{co}"), want)
