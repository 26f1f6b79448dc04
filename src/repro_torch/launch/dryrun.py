"""Multi-pod dry run: count every (arch x shape x mesh) cell on the host.

The port of :mod:`repro.launch.dryrun`.  The reference lowers and
compiles each cell against 512 placeholder devices and reads the compiled
module; the port runs its own code for one rank of the production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`, a world of fake
ranks) on fake tensors, through :mod:`.op_count`'s counting pass, with
``use_kernel="ref"`` as the reference.  Every argument is this rank's
block: the parameters at their local shapes under
:func:`repro_torch.dist.sharding.param_pspecs` (the dense stack tensor-
parallel over the model axis, the experts chunked), AdamW's fp32 moments,
the batch's rows and the caches under ``cache_pspecs``.  Parameters are
zeros of their local shapes (``init_params`` draws numbers, which a fake
tensor does not hold).  The MoE archs take the mesh's capacity paths.

Each cell records, as the reference does where the key means the same:
``status`` / ``skip_reason``, ``n_chips``, ``tokens``,
``flops_per_device`` (dot + elementwise), ``dot_flops_per_device``,
``bytes_per_device`` (the analytic traffic of :mod:`.estimates`),
``collectives`` (ring bytes of the records, :mod:`.roofline`),
``memory_estimate``, ``roofline`` (the H100's constants),
``model_flops_global`` / ``_per_device``, ``useful_flops_ratio``, and
``memory_analysis`` as ``{argument_bytes, peak_bytes}`` (the arguments'
bytes from their local shapes; the counting pass's peak of live
tensors).  ``run_s`` is the cell's host seconds.  The XLA-only keys have
no counterpart and are left out: ``flops_xla_body_once``,
``bytes_xla_body_once``, ``n_while``, ``trip_counts``, ``hlo_bytes``
(and ``lower_s`` / ``compile_s``).  Token ids are int32, as the
reference's.

:func:`count_serve` counts a serving pass (:func:`serve_pass`: a prefill,
its cache moved into rings, decode steps) the same way, on any mesh.

Results are cached as JSON per cell under ``results/dryrun_torch/`` so
reruns skip completed cells (``--force`` recomputes).  The fake world is
process-wide: run it in a process with no other process group.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, input_specs,
                                        skip_reason)
from repro_torch.dist import comm
from repro_torch.dist import sharding as shd
from repro_torch.models import decoder
from repro_torch.models.common import ModelConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.train.tree import leaves

from . import estimates
from .mesh import make_production_mesh
from .op_count import counting
from .roofline import model_flops, roofline_terms

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

_IDS = ("tokens", "labels")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _cell_args(cfg: ModelConfig, spec: ShapeSpec, mesh, *,
               param_bf16: bool = False) -> Dict[str, Any]:
    """The arguments of one cell's step as zeros (fake under
    ``FakeTensorMode``): ``params`` (this rank's blocks), ``opt_state``
    (train), the global ``batch`` and ``caches`` (decode, this rank's
    blocks), and ``argument_bytes``: the bytes this rank holds of them."""
    train = spec.kind == "train"
    pdt = torch.float32 if train and not param_bf16 else torch.bfloat16
    params = shd._map_tree(lambda _, s: torch.zeros(s, dtype=pdt),
                           shd.local_param_shapes(cfg, mesh))
    specs = input_specs(cfg, spec)
    batch = {k: torch.zeros(v.shape, dtype=torch.int32 if k in _IDS
                            else v.dtype) for k, v in specs.items()}
    bspecs = shd.batch_pspecs(cfg, mesh, batch)
    held = [torch.empty(shd.local_shape(t.shape, bspecs[k], mesh),
                        dtype=t.dtype, device="meta")
            for k, t in batch.items()]
    out: Dict[str, Any] = {"params": params, "batch": batch}
    held += leaves(params)
    if train:
        out["opt_state"] = opt.init(params)
        held += leaves(out["opt_state"])
    if spec.kind == "decode":
        out["caches"] = decoder.init_cache(cfg, spec.global_batch,
                                           spec.seq_len, torch.bfloat16,
                                           "cpu", mesh=mesh)
        held += leaves(out["caches"])
    out["argument_bytes"] = _nbytes(held)
    return out


def count_cell(cfg: ModelConfig, spec: ShapeSpec, mesh, *,
               remat: str = "dots", param_bf16: bool = False):
    """Run one cell's step for this rank of ``mesh`` under the counting
    pass; returns ``(Counts, argument_bytes)``.  The caller picks the
    tensors: inside ``FakeTensorMode`` nothing is computed or held."""
    ax = shd.MeshAxes.for_mesh(mesh)
    ctx = decoder.RunCtx("cpu", mesh=mesh, batch_axes=ax.batch,
                         use_kernel="ref",
                         remat=remat if spec.kind == "train" else "none")
    args = _cell_args(cfg, spec, mesh, param_bf16=param_bf16)
    params, batch = args["params"], args["batch"]
    external = leaves(params) + leaves(args.get("opt_state")) + \
        leaves(args.get("caches"))
    with counting(external) as counts:
        if spec.kind == "train":
            make_train_step(cfg, ctx, TrainConfig())(
                params, args["opt_state"], batch)
        elif spec.kind == "prefill":
            decoder.prefill(cfg, ctx, params, batch)
        else:
            decoder.decode_step(cfg, ctx, params, args["caches"],
                                batch["tokens"], batch["pos"])
    return counts, args["argument_bytes"]


def serve_pass(cfg: ModelConfig, ctx: decoder.RunCtx, params, inputs,
               step_tokens: torch.Tensor, ring_len: int) -> Dict[str, Any]:
    """A prefill of ``inputs``, its cache moved into rings of ``ring_len``
    (this rank's blocks on ``ctx.mesh``), then one decode step per row of
    ``step_tokens``: the logits of every pass, and the collective records
    (``[op, dtype, shape, group size]``) of the prefill and of the first
    decode step.  The same pass runs on real ranks and, under
    :func:`count_serve`, on fake ones."""
    b, s = next(iter(inputs.values())).shape[:2]
    with comm.recording() as pre:
        logits, cache = decoder.prefill(cfg, ctx, params, inputs)
    ring = decoder.into_ring(decoder.init_cache(
        cfg, b, ring_len, cfg.compute_dtype(), ctx.device, mesh=ctx.mesh),
        cache)
    del cache
    out, dec_records = [logits], None
    for i, tok in enumerate(step_tokens):
        with comm.recording() as dec:
            logits, ring = decoder.decode_step(cfg, ctx, params, ring, tok,
                                               s + i)
        if dec_records is None:
            dec_records = list(dec)
        out.append(logits)
    return dict(logits=out, prefill_records=_records_json(pre),
                decode_records=_records_json(dec_records or []))


def _records_json(records) -> list:
    return [[op, str(dt).removeprefix("torch."), list(sh), g]
            for op, dt, sh, g in records]


def count_serve(cfg: ModelConfig, mesh, batch: int, prompt: int,
                ring_len: int, steps: int = 1):
    """:func:`serve_pass` for this rank of ``mesh`` under the counting
    pass (``prompt`` tokens a row, ``steps`` decode steps, parameters as
    :func:`count_cell` makes them); returns ``(Counts, its result)``.  The
    caller picks the tensors, as for :func:`count_cell`."""
    spec = ShapeSpec("serve", prompt, batch, "prefill")
    args = _cell_args(cfg, spec, mesh)
    ctx = decoder.RunCtx("cpu", mesh=mesh,
                         batch_axes=shd.MeshAxes.for_mesh(mesh).batch,
                         use_kernel="ref")
    toks = torch.zeros((steps, batch), dtype=torch.int32)
    with counting(leaves(args["params"])) as counts:
        run = serve_pass(cfg, ctx, args["params"], args["batch"], toks,
                         ring_len)
    return counts, run


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             remat: str = "dots", extra_tag: str = "",
             param_bf16: bool = False) -> Dict[str, Any]:
    """One cell on the production mesh (rank 0 of the fake world)."""
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "tag": extra_tag}
    reason = skip_reason(arch, cfg, shape_name)
    if reason:
        cell["status"] = "SKIP"
        cell["skip_reason"] = reason
        return cell

    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = shd.mesh_shape(mesh)
    n_chips = math.prod(shape.values())
    t0 = time.time()
    with FakeTensorMode():
        counts, arg_bytes = count_cell(cfg, spec, mesh, remat=remat,
                                       param_bf16=param_bf16)
    run_s = time.time() - t0
    tokens = spec.global_batch * (1 if spec.kind == "decode"
                                  else spec.seq_len)
    coll = counts.collectives()
    est = estimates.estimate(cfg, spec, n_chips, tp=shape["model"],
                             param_bytes=(2 if param_bf16 else 4))
    terms = roofline_terms(counts.flops, est.traffic_bytes,
                           coll.total_bytes)
    # 6·N·D counts fwd+bwd (train); inference steps are fwd-only -> 2·N·D
    mf = model_flops(cfg.param_count(), tokens, cfg.active_param_count())
    if spec.kind != "train":
        mf /= 3.0
    cell.update({
        "status": "OK",
        "n_chips": n_chips,
        "run_s": round(run_s, 2),
        "tokens": tokens,
        "flops_per_device": counts.flops,
        "dot_flops_per_device": counts.dot_flops,
        "bytes_per_device": est.traffic_bytes,
        "collectives": coll.as_dict(),
        "memory_analysis": {"argument_bytes": arg_bytes,
                            "peak_bytes": counts.peak_bytes},
        "memory_estimate": est.as_dict(),
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips / counts.flops)
        if counts.flops else None,
    })
    return cell


def cell_path(arch: str, shape: str, mesh_name: str, tag: str = "") -> Path:
    t = f"__{tag}" if tag else ""
    return RESULTS_DIR / f"{arch}__{shape}__{mesh_name}{t}.json"


def main(argv: List[str] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--tag", default="")
    ap.add_argument("--param-bf16", action="store_true",
                    help="bf16 weights + fp32 m/v (halves ZeRO gather wire)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                out = cell_path(arch, shape, mesh_name, args.tag)
                if out.exists() and not args.force:
                    print(f"[cached] {arch} {shape} {mesh_name}")
                    continue
                print(f"[run]    {arch} {shape} {mesh_name} ...", flush=True)
                try:
                    cell = run_cell(arch, shape, mp, remat=args.remat,
                                    extra_tag=args.tag,
                                    param_bf16=args.param_bf16)
                except Exception:
                    cell = {"arch": arch, "shape": shape, "mesh": mesh_name,
                            "status": "FAIL",
                            "error": traceback.format_exc()}
                out.write_text(json.dumps(cell, indent=2))
                status = cell["status"]
                extra = ""
                if status == "OK":
                    r = cell["roofline"]
                    extra = (f" run={cell['run_s']}s dom={r['dominant']}"
                             f" tc={r['t_compute_s']:.4f}"
                             f" tm={r['t_memory_s']:.4f}"
                             f" tx={r['t_collective_s']:.4f}")
                elif status == "SKIP":
                    extra = f" ({cell['skip_reason']})"
                print(f"[{status}] {arch} {shape} {mesh_name}{extra}",
                      flush=True)


if __name__ == "__main__":
    main()
