"""The port's dry run (``repro_torch.launch.dryrun``) and its counting
pass (``launch/op_count.py``), held to a real world and to the reference.

* The counting pass is exact: smoke cells of glm4-9b and mamba2 on a
  ``(1, 4)`` mesh count the same dot FLOPs and the same collective
  records on every rank of a world of fake ranks (fake tensors, no data)
  as on the ranks of a real 4-rank gloo world running the same code.
* Against the reference, on a ``(2, 4)`` mesh of 8 host devices: each
  device's argument bytes equal the sum of the reference's per-device
  shard shapes under ``repro.dist.sharding.param_shardings`` (and its
  batch and cache shardings), and the dot FLOPs of a device sit within
  10% of ``repro.launch.hlo_count.analyze`` of the compiled module, for
  the smoke cells of glm4-9b, mamba2, mixtral and deepseek-v2, prefill and
  train.
* ``count_serve`` (a prefill, its cache moved into rings, a decode step:
  the pass ``chip_smoke.py``'s ``mesh_tp`` ranks run) counts the same on
  fake ranks, on the ``(1, 4)`` sub-mesh of the 512-rank world
  (``make_fake_mesh``, as the smoke's dry run takes it) and on real ones.
* ``run_cell`` on the production mesh (a world of 512 fake ranks, in a
  process of its own): an OK cell carries every key, a SKIP cell the
  reference's reason.

The reference child, the fake worlds and the real world run side by
side, once for the file.
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
TESTS = str(Path(__file__).resolve().parent)

# (arch, kind, seq, global batch)
EXACT = [(a, k, 32, 4) for a in ("glm4-9b", "mamba2-780m")
         for k in ("train", "prefill", "decode")]
AGREE = [(a, k, 32, 8) for a in ("glm4-9b", "mamba2-780m", "mixtral-8x7b",
                                 "deepseek-v2-236b")
         for k in ("prefill", "train")]
# (arch, global batch, prompt, ring): the mesh_tp cells at smoke width
SERVE = [("glm4-9b", 1, 32, 40), ("zamba2-1.2b", 2, 32, 40)]

FAKE = """
    import json, sys
    sys.path.insert(0, sys.argv[2])
    import numpy as np
    import torch.distributed as dist
    from torch.testing._internal.distributed import fake_pg
    import torch_gloo

    out = {}
    for world, shape, ranks, cells, serve in json.loads(sys.argv[3]):
        for r in ranks:
            dist.init_process_group("fake", store=fake_pg.FakeStore(),
                                    rank=r, world_size=world)
            res = torch_gloo.count_cells(cells, tuple(shape), fake=True,
                                         serve=serve)
            out.update({"%d|%d|%s" % (world, r, k): v
                        for k, v in res.items()})
            dist.destroy_process_group()
    np.savez(sys.argv[1], **out)
"""

REFERENCE = """
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import get_smoke_config
    from repro.configs import shapes
    from repro.dist import sharding as shd
    from repro.launch import hlo_count
    from repro.models import decoder
    from repro.models.common import param_shapes
    from repro.train import optimizer as opt
    from repro.train.train_step import TrainConfig, make_train_step

    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    out = {}
    for arch, kind, seq, batch in json.loads(sys.argv[2]):
        name = "smoke_" + kind
        shapes.SHAPES[name] = shapes.ShapeSpec(name, seq, batch, kind)
        cfg = get_smoke_config(arch)
        ctx = decoder.RunCtx(mesh=mesh, batch_axes=("data",),
                             use_kernel="ref",
                             remat="dots" if kind == "train" else "none")
        pdt = jnp.float32 if kind == "train" else jnp.bfloat16
        pstr = jax.tree.map(
            lambda s, sh: jax.ShapeDtypeStruct(tuple(s), pdt, sharding=sh),
            param_shapes(cfg, model_size=4), shd.param_shardings(cfg, mesh),
            is_leaf=lambda s: isinstance(s, tuple))
        specs = shapes.input_specs(cfg, name)
        bp = shd.batch_pspecs(cfg, mesh, specs)
        bstr = {k: jax.ShapeDtypeStruct(v.shape, v.dtype,
                                        sharding=NamedSharding(mesh, bp[k]))
                for k, v in specs.items()}
        if kind == "train":
            z = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                s.shape, jnp.float32, sharding=s.sharding), pstr)
            ostr = opt.OptState(m=z, v=z, count=jax.ShapeDtypeStruct(
                (), jnp.int32, sharding=NamedSharding(mesh,
                                                      jax.sharding.PartitionSpec())))
            args = (pstr, ostr, bstr)
            fn = make_train_step(cfg, ctx, TrainConfig())
        else:
            args = (pstr, bstr)
            fn = lambda p, b: decoder.prefill(cfg, ctx, p, b)
        compiled = jax.jit(fn).lower(*args).compile()
        tag = arch + "|" + kind
        out[tag + "|dot"] = hlo_count.analyze(compiled.as_text()).flops
        out[tag + "|args"] = sum(
            int(np.prod(s.sharding.shard_shape(s.shape)))
            * np.dtype(s.dtype).itemsize for s in jax.tree.leaves(args))
        out[tag + "|xla_args"] = \\
            compiled.memory_analysis().argument_size_in_bytes
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""

PRODUCTION = """
    import json, sys
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh
    cells = [dryrun.run_cell("glm4-9b", "decode_32k", False),
             dryrun.run_cell("hubert-xlarge", "decode_32k", False),
             dryrun.run_cell("glm4-9b", "long_500k", False)]
    mesh, serve = make_fake_mesh((1, 4)), {}
    for arch, batch, prompt, ring in json.loads(sys.argv[1]):
        with FakeTensorMode():
            c, run = dryrun.count_serve(get_smoke_config(arch), mesh, batch,
                                        prompt, ring)
        serve[arch] = [c.dot_flops, [run["prefill_records"],
                                     run["decode_records"]]]
    print(json.dumps({"cells": cells, "serve": serve}))
"""


def _child(code: str, *args, xla_devices: int = 0) -> subprocess.Popen:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    if xla_devices:
        env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={xla_devices}"
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             *map(str, args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(child: subprocess.Popen) -> str:
    out, err = child.communicate(timeout=600)
    assert child.returncode == 0, err
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(fake worlds' counts, the real world's ranks, the reference's
    counts, the production cells), once for the file."""
    tmp = tmp_path_factory.mktemp("dryrun")
    fake_out, ref_out = tmp / "fake.npz", tmp / "reference.npz"
    jobs = [[4, [1, 4], [0, 1, 2, 3], EXACT, SERVE],
            [8, [2, 4], [0], AGREE, []]]
    ref = _child(REFERENCE, ref_out, json.dumps(AGREE), xla_devices=8)
    fake = _child(FAKE, fake_out, TESTS, json.dumps(jobs))
    prod = _child(PRODUCTION, json.dumps(SERVE))
    real = torch_gloo.run_world("count4", 4, cells=EXACT, serve=SERVE)
    _wait(fake)
    cells = json.loads(_wait(prod))
    _wait(ref)
    return dict(np.load(fake_out)), real, dict(np.load(ref_out)), cells


@pytest.mark.parametrize("cell", EXACT, ids=lambda c: f"{c[0]}-{c[1]}")
def test_fake_world_counts_equal_a_real_world(runs, cell):
    """Per rank, the fake world's dot FLOPs equal the real gloo world's
    exactly and its collective records are the same list."""
    fake, real, _, _ = runs
    tag = f"{cell[0]}|{cell[1]}"
    for r, got in enumerate(real):
        assert float(fake[f"4|{r}|{tag}|dot"]) == float(got[f"{tag}|dot"])
        assert float(got[f"{tag}|dot"]) > 0
        want = json.loads(str(got[f"{tag}|records"]))
        assert json.loads(str(fake[f"4|{r}|{tag}|records"])) == want
        assert want, "a model axis of 4 runs collectives"
        assert int(fake[f"4|{r}|{tag}|args"]) == int(got[f"{tag}|args"])


@pytest.mark.parametrize("cell", SERVE, ids=lambda c: c[0])
def test_serve_pass_counts_equal_a_real_world(runs, cell):
    """``count_serve``'s dot FLOPs and the records of the prefill and the
    first decode step: every rank of the fake world, and rank 0 of the
    512-rank world's ``(1, 4)`` sub-mesh, equal the real gloo world's."""
    fake, real, _, prod = runs
    arch = cell[0]
    for r, got in enumerate(real):
        want = json.loads(str(got[f"serve|{arch}|records"]))
        assert all(want), "a model axis of 4 runs collectives in both"
        assert json.loads(str(fake[f"4|{r}|serve|{arch}|records"])) == want
        assert float(fake[f"4|{r}|serve|{arch}|dot"]) == \
            float(got[f"serve|{arch}|dot"]) > 0
    dot, records = prod["serve"][arch]
    assert records == json.loads(str(real[0][f"serve|{arch}|records"]))
    assert float(dot) == float(real[0][f"serve|{arch}|dot"])


@pytest.mark.parametrize("cell", AGREE, ids=lambda c: f"{c[0]}-{c[1]}")
def test_counts_agree_with_the_reference(runs, cell):
    """A device's argument bytes are the reference's per-device shard
    shapes summed, exactly (its compiled ``memory_analysis`` drops the
    arguments the step never reads: mamba2's positions); its dot FLOPs
    are within 10% of ``hlo_count``'s."""
    fake, _, ref, _ = runs
    tag = f"{cell[0]}|{cell[1]}"
    args = int(fake[f"8|0|{tag}|args"])
    assert args == int(ref[f"{tag}|args"])
    assert args >= int(ref[f"{tag}|xla_args"])
    got, want = float(fake[f"8|0|{tag}|dot"]), float(ref[f"{tag}|dot"])
    assert abs(got / want - 1.0) < 0.10, (got, want)


def test_production_mesh_cells(runs):
    """glm4-9b decode_32k on pod16x16 (rank 0 of 512 fake ranks) is OK
    with every key of the reference's cell that has a counterpart; the
    SKIP cells carry the reference's reasons."""
    from repro.configs import get_config
    from repro.configs.shapes import skip_reason

    ok, enc, long_ = runs[3]["cells"]
    assert ok["status"] == "OK", ok.get("error")
    for key in ("n_chips", "tokens", "flops_per_device",
                "dot_flops_per_device", "bytes_per_device", "collectives",
                "memory_estimate", "roofline", "model_flops_global",
                "model_flops_per_device", "useful_flops_ratio",
                "memory_analysis"):
        assert key in ok, key
    assert ok["n_chips"] == 256 and ok["tokens"] == 128
    assert ok["dot_flops_per_device"] > 0
    assert ok["collectives"]["total_count"] > 0
    mem = ok["memory_analysis"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert set(ok["roofline"]) >= {"t_compute_s", "t_memory_s",
                                   "t_collective_s", "dominant"}
    for cell in (enc, long_):
        assert cell["status"] == "SKIP"
        assert cell["skip_reason"] == skip_reason(
            cell["arch"], get_config(cell["arch"]), cell["shape"])
