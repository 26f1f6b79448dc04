"""Serving on PyTorch: real decode across 2 pods with session migration.

The counterpart of ``examples/serve_migration.py`` on ``repro_torch``.

Phase 1 — reactive routing: a small model decodes real tokens on the
device; the locality router decides per request whether to forward it to
the session's owner pod or to migrate the KV cache.  Watch a session
physically move pods (its cache column is exported/imported) and decoding
stay bit-consistent.

Phase 2 — proactive planning: a hot session keeps arriving at the "wrong"
pod in bursts.  The reactive router forwards every one of those requests
(the KV outweighs the work description, so the byte verdict never
acquires).  With a :class:`repro_torch.plan.PlacementPlanner` attached, the
affinity loop notices the dominant origin between bursts and *prefetches*
the session to it — before the next burst arrives, off the request path —
after which the burst decodes locally.

The model is glm4-9b's smoke config in f32, its weights drawn from a
seeded ``torch.Generator``; on the card each decode step's attention runs
the flash kernel (plain PyTorch on the CPU).

    PYTHONPATH=src python examples/torch/serve_migration.py
    PYTHONPATH=src python examples/torch/serve_migration.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models import decoder
from repro_torch.models.common import init_params
from repro_torch.plan import PlacementPlanner, PlanConfig
from repro_torch.serve.engine import MultiPodEngine, RealBackend, Request
from repro_torch.serve.router import LocalityRouter


def reactive_phase(cfg, params, device="cuda"):
    ctx = decoder.RunCtx(device)
    backend = RealBackend(cfg, ctx, params, n_pods=2, n_slots=8, max_len=96)
    router = LocalityRouter(2, policy="short", kv_bytes_per_token=64.0)
    eng = MultiPodEngine(2, backend, router, device=device)

    rng = np.random.default_rng(0)
    print("phase 1 — reactive routing")
    print("step  sid  origin -> target  action    home")
    for step in range(10):
        sid = int(rng.integers(4))
        origin = sid % 2 if rng.random() < 0.6 else int(rng.integers(2))
        dec = eng.submit(Request(sid=sid, origin=origin, n_tokens=3))
        print(f"{step:4d}  {sid:3d}  {origin} -> {dec.target}        "
              f"{dec.action:8s}  {eng.session_home}")
        eng.run_step()
    eng.drain()
    m = eng.metrics.as_dict()
    print(f"\ndecoded {m['tokens']} tokens; forwards={m['forwards']} "
          f"KV-migrations={m['transfers']} "
          f"lease-reuse={router.metrics.lease_reuse_rate:.2f}")
    for pod, store in enumerate(backend.stores):
        print(f"pod {pod}: sessions={sorted(store.sessions)} ")
    return eng


def planner_phase(cfg, params, device="cuda"):
    ctx = decoder.RunCtx(device)
    backend = RealBackend(cfg, ctx, params, n_pods=2, n_slots=8, max_len=96)
    # heavy per-token KV: the byte verdict always forwards, so only the
    # planner can fix the placement
    router = LocalityRouter(2, policy="short", arbitration="priced",
                            kv_bytes_per_token=8192.0)
    planner = PlacementPlanner(
        2, 8, PlanConfig(epoch_ms=2.0, top_k=2, min_events=3.0,
                         min_frac=0.6, margin=0.5, hysteresis_epochs=2),
        grow=True, device=device)
    eng = MultiPodEngine(2, backend, router, planner=planner, device=device)

    print("\nphase 2 — proactive planning (hot session, bursty origin)")
    eng.submit(Request(sid=0, origin=1, n_tokens=2))   # first lands on pod 1
    eng.run_step()
    print(f"burst 0 from pod 1: owner={router.owner[0]} (misplaced for "
          f"the bursts that follow)")
    for burst in range(3):
        for _ in range(4):
            dec = eng.submit(Request(sid=0, origin=0, n_tokens=1))
            eng.run_step()
        print(f"burst {burst + 1} from pod 0: owner={router.owner[0]} "
              f"last_action={dec.action:8s} "
              f"planned_moves={router.metrics.planned_moves}")
        for _ in range(3):                 # idle gap: the planner epoch fires
            eng.run_step()
    eng.drain()
    m = eng.metrics.as_dict()
    print(f"planner: epochs={m['plan_epochs']} re-homes={m['plan_moves']} "
          f"prefetches={m['plan_prefetches']} — session 0 now decodes "
          f"locally at pod {router.owner[0]} "
          f"(reactive acquires: {router.metrics.acquires})")
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_smoke_config("glm4-9b"), dtype="float32")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev,
                         torch.float32)
    reactive_phase(cfg, params, args.device)
    planner_phase(cfg, params, args.device)


if __name__ == "__main__":
    main()
