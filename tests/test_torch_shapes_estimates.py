"""The port's shape grid, analytic estimates, roofline terms and production
mesh (``repro_torch.configs.shapes``, ``launch.estimates``,
``launch.roofline``, ``launch.mesh.make_production_mesh``) against the
reference's ``repro.configs.shapes``, ``repro.launch.estimates``,
``repro.launch.hlo_analysis`` and ``repro.launch.mesh``."""
import ast
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as J
from repro.launch import estimates as JE
from repro.launch import hlo_analysis as JH
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import shapes as T
from repro_torch.launch import estimates as TE
from repro_torch.launch import roofline as TR

REPO = Path(__file__).resolve().parents[1]


def _code(obj, subs=()):
    src = textwrap.dedent(inspect.getsource(obj))
    for a, b in subs:
        src = src.replace(a, b)
    return ast.dump(ast.parse(src))


PORT_IMPORTS = (("from repro.", "from repro_torch."),)


@pytest.mark.parametrize("name", ["ShapeSpec", "skip_reason", "grid_cells"])
def test_shapes_are_pinned_copies(name):
    assert _code(getattr(T, name)) == _code(getattr(J, name), PORT_IMPORTS)


def test_shape_tables_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in T.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SHAPES.items()}
    assert list(T.SHAPES) == list(J.SHAPES)
    assert T.SUBQUADRATIC == J.SUBQUADRATIC
    assert T.grid_cells() == J.grid_cells() and len(T.grid_cells()) == 40
    for arch, shape in T.grid_cells():
        assert T.skip_reason(arch, tget_config(arch), shape) == \
            J.skip_reason(arch, jget_config(arch), shape)


# the reference's int32 ids and labels are int64 in the port
DTYPES = {jnp.dtype(jnp.int32): {"tokens": torch.int64, "labels": torch.int64,
                                 "positions": torch.int32, "pos": torch.int32},
          jnp.dtype(jnp.bfloat16): {"embeds": torch.bfloat16}}


@pytest.mark.parametrize("batch", [None, 3])
def test_input_specs_equal_reference_on_every_cell(batch):
    for arch, shape in T.grid_cells():
        got = T.input_specs(tget_config(arch), shape, batch_override=batch)
        want = J.input_specs(jget_config(arch), shape, batch_override=batch)
        assert list(got) == list(want), (arch, shape)
        for k, w in want.items():
            t = got[k]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(w.shape), (arch, shape, k)
            assert t.dtype == DTYPES[jnp.dtype(w.dtype)][k], (arch, shape, k)


@pytest.mark.parametrize("name", ["_cache_bytes_global", "estimate"])
def test_estimates_are_pinned_copies(name):
    """The reference's arithmetic; ``fits`` against the card's memory."""
    subs = PORT_IMPORTS + (("resident < HBM_PER_CHIP",
                            "resident < hbm_per_chip()"),)
    assert _code(getattr(TE, name)) == _code(getattr(JE, name), subs)
    assert TE.C_ACT == JE.C_ACT


@pytest.mark.parametrize("param_bytes", [2, 4])
@pytest.mark.parametrize("chips_tp", [(256, 16), (512, 16), (1, 1)])
def test_estimate_equals_reference_on_every_cell(chips_tp, param_bytes):
    n_chips, tp = chips_tp
    for arch, shape in T.grid_cells():
        got = TE.estimate(tget_config(arch), T.SHAPES[shape], n_chips, tp,
                          param_bytes)
        want = JE.estimate(jget_config(arch), J.SHAPES[shape], n_chips, tp,
                           param_bytes)
        assert got.traffic_bytes == want.traffic_bytes, (arch, shape)
        assert got.residency_bytes == want.residency_bytes, (arch, shape)
        assert got.detail == want.detail, (arch, shape)
        assert list(got.detail) == list(want.detail)
        assert got.fits == (got.residency_bytes < TE.hbm_per_chip())


def test_estimate_fits_key_names_the_card():
    d = TE.estimate(tget_config("glm4-9b"), T.SHAPES["decode_32k"], 1, 1,
                    2).as_dict()
    key = TE.fits_key()
    assert key in d and "fits_16GiB" not in d
    if not torch.cuda.is_available():
        assert TE.hbm_per_chip() == 80 * 1024 ** 3 and key == "fits_80GiB"


def test_model_flops_equals_reference():
    for arch in ("glm4-9b", "mixtral-8x7b", "deepseek-v2-236b"):
        cfg = tget_config(arch)
        for tokens in (1, 4096, 32 * 32768):
            assert TR.model_flops(cfg.param_count(), tokens,
                                  cfg.active_param_count()) == \
                JH.model_flops(cfg.param_count(), tokens,
                               cfg.active_param_count())
    assert TR.model_flops(7, 3) == JH.model_flops(7, 3)


def test_roofline_terms_equal_reference_formula(monkeypatch):
    """Given the reference's constants, the reference's terms; then the
    H100's own."""
    rng = np.random.default_rng(0)
    cases = [(*(float(x) for x in rng.random(3) * 10.0 ** rng.integers(
        6, 15, 3)), int(rng.integers(1, 8))) for _ in range(50)]
    with monkeypatch.context() as m:
        m.setattr(TR, "PEAK_FLOPS", JH.PEAK_FLOPS)
        m.setattr(TR, "HBM_BW", JH.HBM_BW)
        for f, b, c, n in cases:
            # the port's LINK_BW is all of a card's links together
            m.setattr(TR, "LINK_BW", JH.ICI_BW * n)
            assert TR.roofline_terms(f, b, c) == \
                JH.roofline_terms(f, b, c, n_links=n)
    h = TR.roofline_terms(989e12, 3.35e12, 0.0)
    assert h["t_compute_s"] == 1.0 and h["t_memory_s"] == 1.0
    assert TR.roofline_terms(0.0, 0.0, 450e9)["dominant"] == "collective"
    assert TR.roofline_terms(0.0, 0.0, 450e9)["bound_s"] == 1.0
    assert TR.roofline_terms(0.0, 0.0, 0.0)["compute_fraction"] == 0.0


# synthetic optimized-HLO collectives and the same as records
HLO_CASES = [
    ("%ar = bf16[1024,4096]{1,0} all-reduce(bf16[1024,4096]{1,0} %p), "
     "replica_groups=[16,16]<=[256], to_apply=%add",
     ("all-reduce", torch.bfloat16, (1024, 4096), 16)),
    ("%ag = f32[256,128]{1,0} all-gather(f32[64,128]{1,0} %x), "
     "replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}",
     ("all-gather", torch.float32, (256, 128), 4)),
    ("%rs = bf16[64,512]{1,0} reduce-scatter(bf16[512,512]{1,0} %g), "
     "replica_groups=[32,8]<=[256], dimensions={0}, to_apply=%add",
     ("reduce-scatter", torch.bfloat16, (64, 512), 8)),
    ("%a2a = bf16[8,1024,64]{2,1,0} all-to-all(bf16[8,1024,64]{2,1,0} %t), "
     "replica_groups=[64,4]<=[256], dimensions={0}",
     ("all-to-all", torch.bfloat16, (8, 1024, 64), 4)),
    ("%cp = s32[128]{0} collective-permute(s32[128]{0} %v), "
     "source_target_pairs={{0,1},{1,0}}",
     ("collective-permute", torch.int32, (128,), 1)),
    ("%ars = (bf16[2048]{0}, bf16[2048]{0}) all-reduce-start(bf16[2048]{0} "
     "%q), replica_groups=[2,256]<=[512], to_apply=%add",
     ("all-reduce", torch.bfloat16, (2048,), 256)),
    ("%agd = f32[256,128]{1,0} all-gather-done((f32[64,128]{1,0}, "
     "f32[256,128]{1,0}) %ags)", None),
    ("%ags = (f32[16,128]{1,0}, f32[256,128]{1,0}) all-gather-start("
     "f32[16,128]{1,0} %x), replica_groups=[16,16]<=[256], dimensions={0}",
     ("all-gather", torch.float32, (256, 128), 16)),
    ("%f = f32[4]{0} all-reduce(f32[4]{0} %s), replica_groups={}, "
     "to_apply=%add", ("all-reduce", torch.float32, (4,), 1)),
    ("%u = u8[4096]{0} all-gather(u8[256]{0} %k), "
     "replica_groups=[16,16]<=[256], dimensions={0}",
     ("all-gather", torch.uint8, (4096,), 16)),
]


def test_ring_costs_equal_hlo_analysis():
    text = "\n".join(["HloModule m", *(line for line, _ in HLO_CASES),
                      "%add = f32[] add(f32[] %a, f32[] %b)"])
    want = JH.collective_bytes(text)
    got = TR.collective_bytes([r for _, r in HLO_CASES if r is not None])
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.total_bytes == want.total_bytes
    assert got.total_count == want.total_count == 9
    d = got.as_dict()
    assert d["total_bytes"] == want.as_dict()["total_bytes"]
    assert "tpu_bf16_bytes" not in d
    for line, rec in HLO_CASES:       # one collective at a time
        if rec is not None:
            assert TR.collective_bytes([rec]).bytes_by_kind == \
                JH.collective_bytes(line).bytes_by_kind, line
    with pytest.raises(ValueError, match="unknown collective"):
        TR.collective_bytes([("broadcast", torch.float32, (4,), 2)])


# -- make_production_mesh, each case in a process of its own ---------------

MESH_SCRIPT = r"""
import json, os, sys
mode = sys.argv[1]
if mode == "reference":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from repro.launch.mesh import make_production_mesh
    out = {}
    for kw in ({}, {"multi_pod": True}, {"seq": 4}, {"multi_pod": True, "seq": 2}):
        m = make_production_mesh(**kw)
        out[json.dumps(kw)] = [list(m.devices.shape), list(m.axis_names)]
    print(json.dumps(out))
    sys.exit(0)
import torch.distributed as dist
from repro_torch.launch.mesh import make_production_mesh
if mode == "port":
    out = {}
    for kw in ({}, {"multi_pod": True}, {"seq": 4}, {"multi_pod": True, "seq": 2}):
        m = make_production_mesh(**kw)
        out[json.dumps(kw)] = [list(m.mesh.shape), list(m.mesh_dim_names)]
    assert dist.get_backend() == "fake" and dist.get_world_size() == 512
    try:
        make_production_mesh(seq=3)
    except ValueError as e:
        out["seq3"] = str(e)
    print(json.dumps(out))
elif mode == "gloo_up":
    dist.init_process_group("gloo", init_method="tcp://localhost:%s" % sys.argv[2],
                            rank=0, world_size=1)
    try:
        make_production_mesh()
    except RuntimeError as e:
        print(json.dumps({"raised": str(e), "backend": dist.get_backend()}))
    dist.destroy_process_group()
"""


def _run_mesh(mode, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", MESH_SCRIPT, mode, *extra],
                         capture_output=True, text=True, env=env, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_production_mesh_equals_reference():
    ref = _run_mesh("reference")
    port = _run_mesh("port")
    assert port.pop("seq3") == "seq axis 3 must divide the 16-wide data axis"
    assert port == ref
    assert ref['{}'] == [[16, 16], ["data", "model"]]
    assert ref['{"multi_pod": true}'] == [[2, 16, 16], ["pod", "data", "model"]]
    assert ref['{"seq": 4}'] == [[4, 4, 16], ["data", "seq", "model"]]


def test_production_mesh_raises_for_seq_that_does_not_divide():
    from repro.launch.mesh import make_production_mesh as jmesh
    from repro_torch.launch.mesh import make_production_mesh as tmesh
    for f in (jmesh, tmesh):
        with pytest.raises(ValueError, match="must divide"):
            f(seq=3)


def test_production_mesh_never_joins_a_real_process_group():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    got = _run_mesh("gloo_up", str(port))
    assert got["backend"] == "gloo" and "'gloo' process group is up" in \
        got["raised"]
