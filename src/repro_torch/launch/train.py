"""End-to-end training entry point.

The port of :mod:`repro.launch.train`: data pipeline -> train step (remat,
in-place AdamW) -> metrics -> async checkpoints -> resume.  As the
reference, it runs on ``make_host_mesh()``: every rank of the world
(``torchrun``: NCCL on the card, gloo with ``--device cpu``; alone, a
world of one) takes its shard of each global batch, and the gradients are
summed over the data axis (:mod:`repro_torch.train.train_step`).
``--no-mesh`` runs on one device with no process group.  Parameters are
seeded from a ``torch.Generator`` on the device, in fp32, the same on
every rank; rank 0 prints and writes the checkpoints.

Example::

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --preset full --steps 4 --batch 2 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch glm4-9b --preset smoke --steps 5 --batch 4 --seq 64
    PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
        --device cpu --arch glm4-9b --preset smoke --steps 5 --batch 8

Presets scale the architecture down while keeping its family features
(GQA ratios, MoE, SSD, ...) intact, as the reference's do.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import init_world, make_host_mesh
from repro_torch.models import decoder
from repro_torch.models.common import init_params
from repro_torch.train import checkpoint, optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step


def scaled_config(arch: str, preset: str):
    if preset == "full":
        return get_config(arch)
    if preset == "smoke":
        return get_smoke_config(arch)
    if preset == "p100m":
        cfg = get_config(arch)
        kw = dict(
            n_layers=min(cfg.n_layers, 10),
            d_model=512,
            n_heads=8 if cfg.n_heads else 0,
            n_kv_heads=min(8, cfg.n_kv_heads) if cfg.n_kv_heads else 0,
            head_dim=64 if cfg.head_dim else 0,
            d_ff=2048 if cfg.d_ff else 0,
            vocab_size=min(cfg.vocab_size, 49152),
            max_seq_len=4096,
        )
        if cfg.moe is not None:
            kw["moe"] = dataclasses.replace(
                cfg.moe, n_experts=min(8, cfg.moe.n_experts), top_k=2,
                d_expert=768, d_shared=768,
                d_first_dense=1536 if cfg.moe.first_dense_layers else 0,
            )
        if cfg.ssm is not None:
            kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=64, head_dim=64)
        if cfg.global_every:
            kw["global_every"] = 4
            kw["sliding_window"] = 128
        if cfg.hybrid_attn_every:
            kw["hybrid_attn_every"] = 4
        return dataclasses.replace(cfg, **kw)
    raise ValueError(preset)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--preset", default="p100m",
                    choices=["smoke", "p100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-mesh", action="store_true",
                    help="one device, no process group")
    args = ap.parse_args(argv)

    cfg = scaled_config(args.arch, args.preset)
    mesh, lead = None, True
    started = False                  # this call started the process group
    if args.no_mesh:
        device = resolve_device(args.device)
    else:
        started = not torch.distributed.is_initialized()
        device = init_world(args.device)
        mesh = make_host_mesh(device=device)
        lead = torch.distributed.get_rank() == 0
    ctx = decoder.RunCtx(device=device, remat=args.remat, use_kernel="auto",
                         mesh=mesh, batch_axes=("data",))
    say = print if lead else (lambda *a, **k: None)
    say(f"arch={cfg.name} preset={args.preset} "
        f"params={cfg.param_count() / 1e6:.1f}M device={device} "
        f"mesh={None if mesh is None else shd.mesh_shape(mesh)}")

    gen = torch.Generator(device).manual_seed(args.seed)
    params = init_params(cfg, gen, device, torch.float32,
                         model_size=ctx.model_size)
    opt_state = opt.init(params)
    tcfg = TrainConfig(
        opt=opt.OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        microbatches=args.microbatches,
    )
    step_fn = make_train_step(cfg, ctx, tcfg)

    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, stub_frontend=cfg.family in ("vlm", "audio"),
        d_model=cfg.d_model, mrope=cfg.mrope_sections is not None,
    )
    ds = SyntheticLM(data_cfg)

    start = 0
    writer = None
    if args.ckpt_dir:
        if lead:
            writer = checkpoint.AsyncCheckpointer(args.ckpt_dir)
        if args.resume and checkpoint.latest_step(args.ckpt_dir) is not None:
            (params, opt_state), start = checkpoint.restore(
                args.ckpt_dir, (params, opt_state))
            say(f"resumed from step {start}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, stamps = [], []
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in ds.batch(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stamps.append(time.time())
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                say(f"step {step:5d} loss {losses[-1]:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)",
                    flush=True)
            if writer and args.ckpt_every and \
                    (step + 1) % args.ckpt_every == 0:
                writer.submit(step + 1, (params, opt_state))
        if writer:
            writer.submit(args.steps, (params, opt_state))
    finally:
        if writer:
            writer.close()
        if started:
            torch.distributed.destroy_process_group()
    step_s = (float(np.mean(np.diff(stamps))) if len(stamps) > 1 else None)
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps": len(losses),
            "losses": losses,
            "step_s": step_s,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None)}


if __name__ == "__main__":
    main()
