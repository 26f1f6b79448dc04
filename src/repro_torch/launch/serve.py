"""Serving entry point: multi-pod engine with the Lilac locality router.

The roofline-priced ``SimBackend`` for any registered architecture, with
the step certifier's epoch store (and the planner, when on) on
``--device`` (the card by default):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --pods 8 --requests 512 --locality 0.8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mixtral-8x7b --preset full --plan-epoch-ms 5

The simulated throughput it prints is a priced TPU pod's (the reference's
constants, :mod:`repro_torch.dist.locality`), not the H100's speed.  Real
decode (``--backend real``) is not ported yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..configs import get_config, get_smoke_config
from ..dist.locality import ROUTER_DEFAULTS
from ..models.common import ModelConfig
from ..serve.certifier import StepCertifier
from ..serve.engine import MultiPodEngine, RealBackend, Request, SimBackend
from ..serve.router import ARBITRATIONS, LocalityRouter


def build_engine(cfg: ModelConfig, n_pods: int, n_sessions: int, *,
                 policy: str = ROUTER_DEFAULTS.policy,
                 arbitration: str = ROUTER_DEFAULTS.arbitration,
                 seq_shards: int = 1, plan_epoch_ms: float = 0.0,
                 device="cuda", jax_min: int = 8, plan_async: bool = True,
                 trace=None) -> MultiPodEngine:
    """``SimBackend`` pods behind a ``LocalityRouter`` priced with ``cfg``'s
    KV bytes per token, the step certifier's epoch store (and the planner,
    when ``plan_epoch_ms`` > 0) on ``device``.  ``jax_min`` is the
    certifier's packed-path threshold; ``plan_async`` the engine's."""
    kv_per_tok = (2.0 * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers
                  if cfg.n_kv_heads else 4096.0 * cfg.n_layers)
    router = LocalityRouter(n_pods, policy=policy, arbitration=arbitration,
                            kv_bytes_per_token=kv_per_tok,
                            seq_shards=seq_shards)
    planner = None
    if plan_epoch_ms > 0:
        from ..plan import PlacementPlanner

        planner = PlacementPlanner.for_serving(
            n_pods, n_sessions, epoch_ms=plan_epoch_ms, device=device)
    return MultiPodEngine(n_pods, SimBackend(cfg), router,
                          StepCertifier(n_pods, jax_min=jax_min,
                                        device=device),
                          planner=planner, trace=trace,
                          plan_async=plan_async)


def run_point(arch: str, policy: str, locality: float, *, n_pods: int = 8,
              n_sessions: int = 256, steps: int = 80, seed: int = 0,
              arbitration: str = "steps", plan_epoch_ms: float = 0.0,
              device="cuda", jax_min: int = 8,
              plan_async: bool = True) -> dict:
    """One point of the serving-locality sweep (one seed): ``steps`` steps
    of ``2 * n_pods`` four-token requests from a seeded mix of home and
    random origins.  Returns ``point`` (the sweep's columns), ``metrics``
    (``EngineMetrics.as_dict()`` without the wall-clock ``plan_block_s``),
    ``router`` (``RouterMetrics``) and ``plan_block_s``."""
    eng = build_engine(get_config(arch), n_pods, n_sessions, policy=policy,
                       arbitration=arbitration, plan_epoch_ms=plan_epoch_ms,
                       device=device, jax_min=jax_min, plan_async=plan_async)
    router = eng.router
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        for _ in range(2 * n_pods):
            sid = int(rng.integers(n_sessions))
            home = sid % n_pods
            origin = home if rng.random() < locality \
                else int(rng.integers(n_pods))
            eng.submit(Request(sid=sid, origin=origin, n_tokens=4))
        eng.run_step()
    eng.drain()
    m = eng.metrics.as_dict()
    point = {
        "tokens_per_s": m["tokens_per_s"],
        "wire_GB": m["wire_GB"],
        "reuse": router.metrics.lease_reuse_rate,
        "transfers": m["transfers"],
        "forwards": m["forwards"],
        "flips": router.metrics.flips,
        "plan_moves": m["plan_moves"],
        "plan_prefetches": m["plan_prefetches"],
        "plan_GB": m["plan_GB"],
    }
    block = m.pop("plan_block_s")
    return dict(point=point, metrics=m,
                router=dataclasses.asdict(router.metrics),
                plan_block_s=block)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--backend", default="sim", choices=["real", "sim"],
                    help="sim: the roofline-priced SimBackend; real decode "
                         "is not ported yet (ROADMAP queue 1 item 8)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the certifier's epoch store and the "
                         "planner's scoring live")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--policy", default=ROUTER_DEFAULTS.policy,
                    choices=["local", "short", "long"])
    ap.add_argument("--arbitration", default=ROUTER_DEFAULTS.arbitration,
                    choices=list(ARBITRATIONS))
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--tokens-per-request", type=int, default=4)
    ap.add_argument("--locality", type=float, default=0.8)
    ap.add_argument("--seq-axis", type=int, default=0, metavar="N",
                    help="price KV state moves as N-way seq-sharded "
                         "columns (0 = off)")
    ap.add_argument("--plan-epoch-ms", type=float, default=0.0,
                    help="run the proactive placement planner "
                         "(repro_torch.plan) every this many ms of "
                         "simulated time (0 = off): affinity-scored lease "
                         "prefetch + session re-homes off the critical path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a repro_torch.obs timeline of the run "
                         "(routing, lease acquires, certify batches, decode "
                         "spans, planner epochs) and export Perfetto "
                         "trace_event JSON here")
    args = ap.parse_args(argv)

    if args.backend == "real":
        RealBackend()                   # raises: ROADMAP queue 1 item 8
    recorder = None
    if args.trace:
        from ..obs import trace as obs_trace

        recorder = obs_trace.TraceRecorder()
        obs_trace.install(recorder)

    cfg = (get_smoke_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")

    seq_shards = max(1, args.seq_axis)
    eng = build_engine(cfg, args.pods, args.sessions, policy=args.policy,
                       arbitration=args.arbitration, seq_shards=seq_shards,
                       plan_epoch_ms=args.plan_epoch_ms, device=args.device,
                       trace=recorder)
    router, planner = eng.router, eng.planner
    rng = np.random.default_rng(args.seed)
    submitted = 0
    while submitted < args.requests:
        for _ in range(min(args.pods * 2, args.requests - submitted)):
            sid = int(rng.integers(args.sessions))
            home = sid % args.pods
            origin = home if rng.random() < args.locality else int(rng.integers(args.pods))
            eng.submit(Request(sid=sid, origin=origin,
                               n_tokens=args.tokens_per_request))
            submitted += 1
        eng.run_step()
    eng.drain()
    m = eng.metrics.as_dict()
    print(f"arch={cfg.name} pods={args.pods} policy={args.policy} "
          f"arbitration={args.arbitration} locality={args.locality} "
          f"seq_shards={seq_shards:g} device={args.device}")
    print(f"tokens={m['tokens']} forwards={m['forwards']} "
          f"kv_migrations={m['transfers']} wire={m['wire_GB']:.4f}GB "
          f"lease_reuse={router.metrics.lease_reuse_rate:.3f}")
    if planner is not None:
        print(f"planner: epochs={m['plan_epochs']} moves={m['plan_moves']} "
              f"prefetches={m['plan_prefetches']} "
              f"planned={m['plan_GB']:.4f}GB")
    print(f"simulated throughput (a priced TPU pod, not this device): "
          f"{m['tokens_per_s']:.0f} tok/s")
    print(f"token latency: p50={m['token_lat_p50_s']:.4g}s "
          f"p99={m['token_lat_p99_s']:.4g}s")
    if recorder is not None:
        from ..obs import trace as obs_trace

        obs_trace.uninstall()
        recorder.export(args.trace)
        print(f"trace: {len(recorder)} events -> {args.trace}")
    return m


if __name__ == "__main__":
    main()
