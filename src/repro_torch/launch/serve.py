"""Serving entry point: multi-pod engine with the Lilac locality router.

Real decode (``--backend real``, the default, as in the reference) runs the
model with seeded weights on ``--device`` (the card by default), one KV
store per pod; the roofline-priced ``SimBackend`` (``--backend sim``) takes
any registered architecture.  The step certifier's epoch store (and the
planner, when on) live on ``--device`` too:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --preset smoke --pods 2 --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sim \
        --arch deepseek-v2-236b --pods 8 --requests 512 --locality 0.8
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sim \
        --device cpu --arch mixtral-8x7b --preset full --plan-epoch-ms 5

The simulated throughput ``--backend sim`` prints is a priced TPU pod's
(the reference's constants, :mod:`repro_torch.dist.locality`), not the
H100's speed.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..dist.locality import ROUTER_DEFAULTS
from ..models import decoder
from ..models.common import ModelConfig, init_params
from ..serve.certifier import StepCertifier
from ..serve.engine import MultiPodEngine, RealBackend, Request, SimBackend
from ..serve.router import ARBITRATIONS, LocalityRouter

# the reference launch's router price of a real backend's KV bytes a token
REAL_KV_BYTES_PER_TOKEN = 256.0


def build_engine(cfg: ModelConfig, n_pods: int, n_sessions: int, *,
                 backend=None, policy: str = ROUTER_DEFAULTS.policy,
                 arbitration: str = ROUTER_DEFAULTS.arbitration,
                 seq_shards: int = 1, plan_epoch_ms: float = 0.0,
                 device="cuda", jax_min: int = 8, plan_async: bool = True,
                 trace=None, sanitize: bool = False) -> MultiPodEngine:
    """Pods behind a ``LocalityRouter``, the step certifier's epoch store
    (and the planner, when ``plan_epoch_ms`` > 0) on ``device``.

    ``backend`` None: ``SimBackend`` pods, the router priced with ``cfg``'s
    KV bytes per token and ``seq_shards``.  A ``RealBackend``: the router
    priced at ``REAL_KV_BYTES_PER_TOKEN`` and the backend's ``seq_shards``,
    as the reference's launch prices it.  ``jax_min`` is the certifier's
    packed-path threshold; ``plan_async`` the engine's; ``sanitize`` the
    certifier's protocol checks."""
    if backend is None:
        backend = SimBackend(cfg)
        kv_per_tok = (2.0 * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers
                      if cfg.n_kv_heads else 4096.0 * cfg.n_layers)
    else:
        kv_per_tok, seq_shards = REAL_KV_BYTES_PER_TOKEN, backend.seq_shards
    router = LocalityRouter(n_pods, policy=policy, arbitration=arbitration,
                            kv_bytes_per_token=kv_per_tok,
                            seq_shards=seq_shards)
    planner = None
    if plan_epoch_ms > 0:
        from ..dist.sharding import make_plan_mesh
        from ..plan import PlacementPlanner

        planner = PlacementPlanner.for_serving(
            n_pods, n_sessions, epoch_ms=plan_epoch_ms, device=device,
            mesh=make_plan_mesh(device=device))
    return MultiPodEngine(n_pods, backend, router,
                          StepCertifier(n_pods, jax_min=jax_min,
                                        sanitize=sanitize, device=device),
                          planner=planner, trace=trace,
                          plan_async=plan_async)


def serve_requests(eng: MultiPodEngine, n_requests: int, n_sessions: int, *,
                   tokens_per_request: int = 4, locality: float = 0.8,
                   seed: int = 0) -> dict:
    """The launch's request loop: ``2 * n_pods`` requests a step (sessions
    drawn from ``seed``, at their home pod with probability ``locality``,
    else at a random one) until ``n_requests`` are in, then drain.
    Returns ``EngineMetrics.as_dict()``."""
    n_pods = eng.n_pods
    rng = np.random.default_rng(seed)
    submitted = 0
    while submitted < n_requests:
        for _ in range(min(n_pods * 2, n_requests - submitted)):
            sid = int(rng.integers(n_sessions))
            home = sid % n_pods
            origin = home if rng.random() < locality \
                else int(rng.integers(n_pods))
            eng.submit(Request(sid=sid, origin=origin,
                               n_tokens=tokens_per_request))
            submitted += 1
        eng.run_step()
    eng.drain()
    return eng.metrics.as_dict()


def serve_real(cfg: ModelConfig, params, *, n_pods: int = 2,
               n_sessions: int = 16, n_requests: int = 64,
               tokens_per_request: int = 4, locality: float = 0.8,
               max_len: int = 256, seed: int = 0, device="cuda",
               policy: str = ROUTER_DEFAULTS.policy,
               arbitration: str = ROUTER_DEFAULTS.arbitration,
               plan_epoch_ms: float = 0.0, trace=None, mesh=None,
               seq_axis: Optional[str] = None) -> MultiPodEngine:
    """The reference launch's ``--backend real`` run (its defaults here):
    a ``RealBackend`` with ``max(8, n_sessions)`` slots of ``max_len`` per
    pod decoding with ``params`` on ``device``, the request loop of
    :func:`serve_requests`.  ``mesh`` / ``seq_axis`` run the decode and
    the KV stores on that mesh (the seq-sharded rings on ``seq_axis``).
    Returns the drained engine."""
    ctx = decoder.RunCtx(device, mesh=mesh, seq_axis=seq_axis)
    backend = RealBackend(cfg, ctx, params, n_pods=n_pods,
                          n_slots=max(8, n_sessions), max_len=max_len)
    eng = build_engine(cfg, n_pods, n_sessions, backend=backend,
                       policy=policy, arbitration=arbitration,
                       plan_epoch_ms=plan_epoch_ms, device=ctx.device,
                       trace=trace)
    serve_requests(eng, n_requests, n_sessions,
                   tokens_per_request=tokens_per_request, locality=locality,
                   seed=seed)
    return eng


def run_point(arch: str, policy: str, locality: float, *, n_pods: int = 8,
              n_sessions: int = 256, steps: int = 80, seed: int = 0,
              arbitration: str = "steps", plan_epoch_ms: float = 0.0,
              device="cuda", jax_min: int = 8,
              plan_async: bool = True, sanitize: bool = False) -> dict:
    """One point of the serving-locality sweep (one seed): ``steps`` steps
    of ``2 * n_pods`` four-token requests from a seeded mix of home and
    random origins.  Returns ``point`` (the sweep's columns), ``metrics``
    (``EngineMetrics.as_dict()`` without the wall-clock ``plan_block_s``),
    ``router`` (``RouterMetrics``) and ``plan_block_s``.  ``sanitize``
    runs the certifier's protocol checks (a violation raises)."""
    eng = build_engine(get_config(arch), n_pods, n_sessions, policy=policy,
                       arbitration=arbitration, plan_epoch_ms=plan_epoch_ms,
                       device=device, jax_min=jax_min, plan_async=plan_async,
                       sanitize=sanitize)
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
    ap.add_argument("--backend", default="real", choices=["real", "sim"],
                    help="real: decode with seeded weights on --device; "
                         "sim: the roofline-priced SimBackend")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and KV stores (real), the "
                         "certifier's epoch store and the planner's "
                         "scoring live")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--policy", default=ROUTER_DEFAULTS.policy,
                    choices=["local", "short", "long"])
    ap.add_argument("--arbitration", default=ROUTER_DEFAULTS.arbitration,
                    choices=list(ARBITRATIONS))
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--tokens-per-request", type=int, default=4)
    ap.add_argument("--locality", type=float, default=0.8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seq-axis", type=int, default=0, metavar="N",
                    help="price KV state moves as N-way seq-sharded "
                         "columns (0 = off); with --backend real, decode "
                         "over a mesh with an N-way seq axis (as many as "
                         "the world's ranks allow)")
    ap.add_argument("--plan-epoch-ms", type=float, default=0.0,
                    help="run the proactive placement planner "
                         "(repro_torch.plan) every this many ms of "
                         "simulated time (0 = off): affinity-scored lease "
                         "prefetch + session re-homes off the critical path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a repro_torch.obs timeline of the run "
                         "(routing, lease acquires, certify batches, decode "
                         "spans, planner epochs, MoE dispatch verdicts) and "
                         "export Perfetto trace_event JSON here")
    args = ap.parse_args(argv)

    recorder = None
    if args.trace:
        from ..obs import trace as obs_trace

        recorder = obs_trace.TraceRecorder()
        # installed module-wide too, so sites with no engine to thread
        # through (models/moe.py) land in the same timeline
        obs_trace.install(recorder)

    cfg = (get_smoke_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")

    if args.backend == "real":
        dev = resolve_device(args.device)
        mesh = seq_axis = None
        if args.seq_axis > 0:
            from .mesh import make_host_mesh

            mesh = make_host_mesh(model=1, seq=args.seq_axis, device=dev)
            if "seq" in mesh.mesh_dim_names:
                seq_axis = "seq"
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), dev)
        eng = serve_real(cfg, params, n_pods=args.pods,
                         n_sessions=args.sessions, n_requests=args.requests,
                         tokens_per_request=args.tokens_per_request,
                         locality=args.locality, max_len=args.max_len,
                         seed=args.seed, device=dev, policy=args.policy,
                         arbitration=args.arbitration,
                         plan_epoch_ms=args.plan_epoch_ms, trace=recorder,
                         mesh=mesh, seq_axis=seq_axis)
        seq_shards = eng.backend.seq_shards
        m = eng.metrics.as_dict()
    else:
        seq_shards = max(1, args.seq_axis)
        eng = build_engine(cfg, args.pods, args.sessions, policy=args.policy,
                           arbitration=args.arbitration,
                           seq_shards=seq_shards,
                           plan_epoch_ms=args.plan_epoch_ms,
                           device=args.device, trace=recorder)
        m = serve_requests(eng, args.requests, args.sessions,
                           tokens_per_request=args.tokens_per_request,
                           locality=args.locality, seed=args.seed)
    router, planner = eng.router, eng.planner
    print(f"arch={cfg.name} pods={args.pods} policy={args.policy} "
          f"arbitration={args.arbitration} locality={args.locality} "
          f"seq_shards={seq_shards:g} backend={args.backend} "
          f"device={args.device}")
    print(f"tokens={m['tokens']} forwards={m['forwards']} "
          f"kv_migrations={m['transfers']} wire={m['wire_GB']:.4f}GB "
          f"lease_reuse={router.metrics.lease_reuse_rate:.3f}")
    if planner is not None:
        print(f"planner: epochs={m['plan_epochs']} moves={m['plan_moves']} "
              f"prefetches={m['plan_prefetches']} "
              f"planned={m['plan_GB']:.4f}GB")
    if args.backend == "sim":
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
