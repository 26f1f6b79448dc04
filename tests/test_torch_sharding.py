"""The port's sharding rules against :mod:`repro.dist.sharding`, in-process.

The rules need no process group: a mesh is given by its axis sizes (a
``jax.sharding.AbstractMesh`` for the reference, the same mapping for the
port).  The port keeps one dict per layer where the reference stacks its
scanned body on a leading group axis; both index dims from the end, so a
body layer's spec is the reference's without that axis.  Specs are
compared normalized (jax 0.9 stores a one-name tuple as the bare name).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_smoke_config as jsmoke
from repro.dist import sharding as jshd
from repro.models import decoder as jdecoder
from repro.train import elastic as jelastic
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.dist import sharding as shd
from repro_torch.models import decoder
from repro_torch.models.common import layer_plan
from repro_torch.train import elastic

MESHES = {
    "1x8": ((1, 8), ("data", "model")),
    "8x1x1": ((8, 1, 1), ("data", "seq", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x4x2": ((1, 4, 2), ("data", "seq", "model")),
}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), dict(zip(names, shape))


def _norm(spec) -> tuple:
    return shd.normalize(tuple(spec))


def _per_layer(cfg, tree, stacked_key, one_key):
    """The reference's prefix / stacked body / suffix entries as one entry
    per layer in the port's order, the body's group axis dropped."""
    plan = layer_plan(cfg)
    out = []
    for i in range(cfg.n_layers):
        if i < plan.prefix:
            out.append((one_key(tree, "prefix", i), False))
        elif i < plan.suffix_start:
            g, j = divmod(i - plan.prefix, plan.period)
            out.append((stacked_key(tree, j), True))
        else:
            out.append((one_key(tree, "suffix", i), False))
    return out


def _unstack(spec, stacked: bool) -> tuple:
    spec = tuple(spec)
    return spec[1:] if stacked and spec else spec


def _walk(port, ref, stacked, path=()):
    """Every (path, port spec, reference spec) pair of congruent trees."""
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in port:
            yield from _walk(port[k], ref[k], stacked, path + (k,))
    else:
        yield path, port, _unstack(ref, stacked)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    got = shd.param_pspecs(cfg, pmesh)
    want = jshd.param_pspecs(jcfg, jmesh)
    assert sorted(k for k in got if k != "layers") == \
        sorted(k for k in want if k not in ("prefix", "blocks", "suffix"))
    for k in got:
        if k != "layers":
            for path, a, b in _walk(got[k], want[k], False, (k,)):
                assert _norm(a) == _norm(b), path
    layers = _per_layer(cfg, want, lambda t, j: t["blocks"][f"pos{j}"],
                        lambda t, part, i: t[part][f"layer{i}"])
    assert len(got["layers"]) == len(layers)
    for i, (mine, (theirs, stacked)) in enumerate(zip(got["layers"], layers)):
        for path, a, b in _walk(mine, theirs, stacked, (i,)):
            assert _norm(a) == _norm(b), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_smoke_config(a).causal])
def test_cache_pspecs_match_reference(arch, mesh):
    """With and without a seq axis (the encoder, hubert, has no decode
    cache in either package)."""
    jmesh, pmesh = _meshes(mesh)
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    batch, max_len = 8, 32
    got = shd.cache_pspecs(cfg, pmesh, decoder.init_cache(
        cfg, batch, max_len, torch.float32, "meta"), batch)
    tree = jax.eval_shape(lambda: jdecoder.init_cache(jcfg, batch, max_len,
                                                      jnp.float32))
    want = jshd.cache_pspecs(jcfg, jmesh, tree, batch)
    layers = _per_layer(cfg, want, lambda t, j: t["body"][j],
                        lambda t, part, i: t[part][
                            i if part == "prefix"
                            else i - layer_plan(cfg).suffix_start])
    for i, (mine, (theirs, stacked)) in enumerate(zip(got, layers)):
        for path, a, b in _walk(mine, theirs, stacked, (i,)):
            assert _norm(a) == _norm(b), path


@pytest.mark.parametrize("mesh", sorted(MESHES) + ["pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_pspecs_match_reference(arch, mesh):
    if mesh == "pod":
        jmesh = AbstractMesh((2, 4, 2), ("pod", "data", "model"))
        pmesh = {"pod": 2, "data": 4, "model": 2}
    else:
        jmesh, pmesh = _meshes(mesh)
    cfg = get_smoke_config(arch)
    for b in (8, 6, 4, 1):
        shapes = {"tokens": (b, 16), "labels": (b, 16),
                  "embeds": (b, 16, cfg.d_model), "positions": (3, b, 16),
                  "pos": ()}
        got = shd.batch_pspecs(cfg, pmesh, {
            k: torch.empty(s, device="meta") for k, s in shapes.items()})
        want = jshd.batch_pspecs(jsmoke(arch), jmesh, {
            k: jax.ShapeDtypeStruct(s, jnp.float32)
            for k, s in shapes.items()})
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}, b


def test_mesh_axes_and_normalize():
    ax = shd.MeshAxes.for_mesh({"pod": 2, "data": 4, "seq": 2, "model": 8})
    jax_ = jshd.MeshAxes.for_mesh(AbstractMesh(
        (2, 4, 2, 8), ("pod", "data", "seq", "model")))
    assert (ax.batch, ax.model, ax.seq) == (jax_.batch, jax_.model, jax_.seq)
    assert shd.normalize((("data",), None, ("pod", "data"))) == \
        ("data", None, ("pod", "data"))


def test_kv_buffer_spec_matches_reference():
    for shape in ((4, 32, 4, 16), (2, 4, 32, 4, 16), (4, 30, 2, 16),
                  (4, 32, 24), (2, 4, 32, 8), (4, 32, 3, 16)):
        for bdim in (0, 1):
            if len(shape) <= bdim + 1:
                continue
            for batch in (None, ("data",), ("pod", "data")):
                for msize in (1, 2, 4):
                    for seq, ssize in ((None, 1), ("seq", 1), ("seq", 4),
                                       ("seq", 8)):
                        kw = dict(bdim=bdim, batch=batch, msize=msize,
                                  seq=seq, ssize=ssize)
                        assert _norm(shd.kv_buffer_spec(shape, **kw)) == \
                            _norm(jshd.kv_buffer_spec(shape, **kw)), \
                            (shape, kw)


def test_divisible_batch_axes_matches_reference():
    jmesh = AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    pmesh = {"pod": 2, "data": 4, "model": 2}
    for n in range(0, 33):
        for axes in (("pod", "data"), ("data",), ("pod",), ()):
            assert shd._divisible_batch_axes(n, axes, pmesh) == \
                jshd._divisible_batch_axes(n, axes, jmesh), (n, axes)


def test_plan_remesh_matches_reference():
    for survivors in range(1, 40):
        for model in (1, 2, 4, 8, 16):
            assert dataclasses.asdict(elastic.plan_remesh(survivors, model)) \
                == dataclasses.asdict(jelastic.plan_remesh(survivors, model))


def test_plan_score_shardings_match_reference():
    for size in (2, 4, 8):
        jmesh = AbstractMesh((size,), (jshd.PLAN_AXIS,))
        pmesh = {shd.PLAN_AXIS: size}
        for c in (1, 6, 8, 12, 16, 64):
            got = shd.plan_score_shardings(pmesh, c)
            want = jshd.plan_score_shardings(jmesh, c) if c % size == 0 \
                else None
            if want is None:
                assert got is None, (size, c)
                continue
            assert {k: _norm(v) for k, v in got.items()} == \
                {k: _norm(v.spec) for k, v in want.items()}, (size, c)


def test_local_shard_cuts_this_ranks_block():
    """A rank's block shapes: an expert chunk stack cut over the model
    axis, a dim the axis does not divide refused, and a dim cut over two
    axes at once."""
    cfg = get_smoke_config("mixtral-8x7b")
    specs = shd.param_pspecs(cfg, {"data": 2, "model": 4})
    shapes = shd.param_tree_shapes(cfg, 4)
    wg = specs["layers"][0]["moe"]["experts"]["w_gate"]
    assert wg == ("model", None, None, None)
    assert shd.local_shape(shapes["layers"][0]["moe"]["experts"]["w_gate"],
                           wg, {"data": 2, "model": 4})[0] == 1
    with pytest.raises(ValueError, match="divide"):
        shd.local_shape((6, 4), ("model", None), {"model": 4})
    assert np.prod(shd.local_shape((8, 6), (("data", "model"), None),
                                   {"data": 2, "model": 4})) == 6
