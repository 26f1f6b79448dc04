"""Quickstart on PyTorch: the paper's contribution in three minutes.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``:

1. Runs the Bank benchmark on the 4-replica cluster simulator under the
   baseline ALC protocol and under Lilac-TM (fine-grained leases +
   transaction migration), at low and high data locality; the replicas'
   version tables and batched certification live on the device.
2. Shows the same decision machinery routing requests in the multi-pod
   serving engine.

    PYTHONPATH=src python examples/torch/quickstart.py               # the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import BankWorkload, SimConfig, make_cluster
from repro_torch.serve.engine import MultiPodEngine, Request, SimBackend
from repro_torch.serve.router import LocalityRouter


def part1_cluster(device="cuda", duration_ms=600.0, warmup_ms=100.0):
    print("== 1. Replicated STM cluster (paper §4, Bank benchmark) ==")
    print(f"{'algorithm':14s} {'P=0.2':>10s} {'P=0.95':>10s}   lease-reuse @0.95")
    for algo in ("ALC", "FGL", "LILAC-TM-ST"):
        row = [algo]
        for P in (0.2, 0.95):
            cfg = SimConfig(duration_ms=duration_ms, warmup_ms=warmup_ms,
                            device=device)
            wl = BankWorkload(n_nodes=4, n_items=cfg.n_items, locality=P)
            c = make_cluster(algo, wl, cfg)
            m = c.run()
            row.append(f"{c.throughput():8.0f}/s")
            reuse = m.lease_reuse_rate()
        print(f"{row[0]:14s} {row[1]:>10s} {row[2]:>10s}   {reuse:.2f}")
    print()


def part2_serving(device="cuda"):
    """Returns each locality's engine metrics."""
    print("== 2. Same decision, serving layer: migrate request vs move KV ==")
    from repro_torch.configs import get_config

    cfg = get_config("mixtral-8x7b")
    out = {}
    for P in (0.2, 0.95):
        router = LocalityRouter(4, policy="short",
                                kv_bytes_per_token=2048.0 * cfg.n_layers)
        eng = MultiPodEngine(4, SimBackend(cfg), router, device=device)
        rng = np.random.default_rng(0)
        for _ in range(30):
            for _ in range(8):
                sid = int(rng.integers(48))
                origin = sid % 4 if rng.random() < P else int(rng.integers(4))
                eng.submit(Request(sid=sid, origin=origin, n_tokens=4))
            eng.run_step()
        eng.drain()
        m = out[P] = eng.metrics.as_dict()
        print(f"  locality={P}: {m['tokens_per_s']:9.0f} tok/s  "
              f"wire={m['wire_GB']:.2f} GB  forwards={m['forwards']}  "
              f"KV-moves={m['transfers']}  reuse={router.metrics.lease_reuse_rate:.2f}")
    print()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    part1_cluster(args.device)
    part2_serving(args.device)
    print("done — see benchmarks/ for the full paper evaluation.")


if __name__ == "__main__":
    main()
