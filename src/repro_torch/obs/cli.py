"""``repro-torch-trace``: export / summarize / diff repro_torch.obs timelines.

The port of :mod:`repro.obs.cli`.

- ``export``  — run the seeded serve_locality smoke scenario with tracing
  on (engine routing, lease acquires, certify batches, decode spans,
  planner epochs) plus one tiny MoE forward (its dispatch span), with the
  certifier's store, the planner and the MoE forward on ``--device`` (the
  card by default), and write the combined Perfetto ``trace_event`` JSON.
- ``summarize`` — per-event-name counts and duration quantiles of an
  exported trace.
- ``diff``    — per-name count/total-duration deltas between two traces
  (the regression view: sim-time stamps make this signal, not noise).

Load exported files at https://ui.perfetto.dev or ``chrome://tracing``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.obs import trace as obs_trace


# --------------------------------------------------------------------------
# export: the seeded smoke scenario, traced
# --------------------------------------------------------------------------

def _run_serve_smoke(rec, *, arch: str, pods: int, sessions: int,
                     steps: int, locality: float, seed: int,
                     plan_epoch_ms: float, device) -> dict:
    """The serve_locality smoke loop with the recorder threaded through."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.plan import PlacementPlanner
    from repro_torch.serve.engine import MultiPodEngine, Request, SimBackend
    from repro_torch.serve.router import LocalityRouter

    cfg = get_config(arch)
    kv_per_tok = 2.0 * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers \
        if cfg.n_kv_heads else 4096.0 * cfg.n_layers
    router = LocalityRouter(pods, policy="short", arbitration="priced",
                            kv_bytes_per_token=kv_per_tok)
    planner = PlacementPlanner.for_serving(pods, sessions,
                                           epoch_ms=plan_epoch_ms,
                                           device=device)
    eng = MultiPodEngine(pods, SimBackend(cfg), router, planner=planner,
                         trace=rec, device=device)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        for _ in range(2 * pods):
            sid = int(rng.integers(sessions))
            home = sid % pods
            origin = home if rng.random() < locality \
                else int(rng.integers(pods))
            eng.submit(Request(sid=sid, origin=origin, n_tokens=4))
        eng.run_step()
    eng.drain()
    return eng.metrics.as_dict()


def _run_moe_smoke(arch: str, seed: int, device) -> None:
    """One tiny MoE forward so the dispatch span fires.

    Params are hand-built in the chunked n_chunks=1 layout from the
    reference's numpy draws — no decoder init, well under a second.
    """
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    m = cfg.moe
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, m.d_expert
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    p = {
        "router": t(rng.standard_normal((d, m.n_experts)) * 0.1),
        "experts": {
            "w_gate": t(rng.standard_normal((1, m.n_experts, d, f)) * 0.05),
            "w_up": t(rng.standard_normal((1, m.n_experts, d, f)) * 0.05),
            "w_down": t(rng.standard_normal((1, m.n_experts, f, d)) * 0.05),
        },
    }
    x = t(rng.standard_normal((1, 4, d)))
    moe.moe_apply(p, x, cfg)


def _cmd_export(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-trace export",
        description="Run the seeded serve_locality smoke with tracing on "
                    "and export a Perfetto trace.")
    ap.add_argument("--out", default="trace.json")
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--locality", type=float, default=0.5)
    ap.add_argument("--plan-epoch-ms", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the certifier's store, the planner's "
                         "scoring and the MoE forward run")
    ap.add_argument("--no-moe", action="store_true",
                    help="skip the MoE forward (the trace then has no "
                         "moe-dispatch span)")
    ns = ap.parse_args(argv)

    rec = obs_trace.TraceRecorder()
    # module-wide install so siteless emitters (models/moe.py) land in the
    # same timeline as the engine's threaded recorder
    obs_trace.install(rec)
    try:
        m = _run_serve_smoke(rec, arch=ns.arch, pods=ns.pods,
                             sessions=ns.sessions, steps=ns.steps,
                             locality=ns.locality, seed=ns.seed,
                             plan_epoch_ms=ns.plan_epoch_ms,
                             device=ns.device)
        if not ns.no_moe:
            _run_moe_smoke(ns.arch, ns.seed, ns.device)
    finally:
        obs_trace.uninstall()
    rec.export(ns.out)
    print(f"{len(rec)} events -> {ns.out}")
    print(f"tokens={m['tokens']} forwards={m['forwards']} "
          f"token_lat_p50={m['token_lat_p50_s']:.4g}s "
          f"p99={m['token_lat_p99_s']:.4g}s")
    for row in obs_trace.summarize(obs_trace.load(ns.out)):
        print(f"  {row['name']:<18} n={row['count']:<6} "
              f"total={row['total_us']:.1f}us")
    return 0


# --------------------------------------------------------------------------
# summarize / diff
# --------------------------------------------------------------------------

def _cmd_summarize(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="repro-torch-trace summarize")
    ap.add_argument("trace", help="exported trace_event JSON")
    ns = ap.parse_args(argv)
    rows = obs_trace.summarize(obs_trace.load(ns.trace))
    if not rows:
        print("empty trace")
        return 0
    print(f"{'name':<20} {'count':>8} {'total_us':>12} "
          f"{'p50_us':>10} {'p99_us':>10}")
    for r in rows:
        p50 = f"{r['p50_us']:.1f}" if "p50_us" in r else "-"
        p99 = f"{r['p99_us']:.1f}" if "p99_us" in r else "-"
        print(f"{r['name']:<20} {r['count']:>8} {r['total_us']:>12.1f} "
              f"{p50:>10} {p99:>10}")
    return 0


def _cmd_diff(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="repro-torch-trace diff")
    ap.add_argument("a")
    ap.add_argument("b")
    ns = ap.parse_args(argv)
    rows = obs_trace.diff(obs_trace.load(ns.a), obs_trace.load(ns.b))
    print(f"{'name':<20} {'count_a':>8} {'count_b':>8} {'d_count':>8} "
          f"{'d_total_us':>12}")
    changed = 0
    for r in rows:
        if r["d_count"] == 0 and abs(r["d_total_us"]) < 1e-9:
            continue
        changed += 1
        print(f"{r['name']:<20} {r['count_a']:>8} {r['count_b']:>8} "
              f"{r['d_count']:>+8} {r['d_total_us']:>+12.1f}")
    if not changed:
        print("(no per-name differences)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"export": _cmd_export, "summarize": _cmd_summarize,
            "diff": _cmd_diff}
    if not argv or argv[0] not in cmds:
        print("usage: repro-torch-trace {export,summarize,diff} [options]\n"
              f"{__doc__}")
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
