"""Fault tolerance on PyTorch: node crash mid-run + elastic checkpoint restart.

The counterpart of ``examples/failover_recovery.py`` on ``repro_torch``.

Part 1 — protocol level: a replica crashes during a Lilac-TM run; the
view-synchronous membership reclaims its leases and the survivors keep
committing (throughput before/after shown).

Part 2 — training level: a run checkpoints asynchronously, "loses" ranks,
re-meshes with :mod:`repro_torch.train.elastic` over the survivors and
resumes from the last committed step with re-sharded state.  Here the
world is one rank (NCCL on the card, gloo on the CPU), which the plan
API treats like any other survivor count.

    PYTHONPATH=src python examples/torch/failover_recovery.py
    PYTHONPATH=src python examples/torch/failover_recovery.py --device cpu
"""
import argparse
import tempfile

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import BankWorkload, SimConfig, make_cluster
from repro_torch.launch.mesh import init_world
from repro_torch.train import checkpoint, elastic


def part1_protocol(device="cuda"):
    print("== 1. Replica crash under Lilac-TM ==")
    cfg = SimConfig(duration_ms=800.0, warmup_ms=100.0, device=device)
    wl = BankWorkload(n_nodes=4, n_items=cfg.n_items, locality=0.5)
    c = make_cluster("LILAC-TM-ST", wl, cfg)
    c.events.schedule(300.0, lambda: c.gcs.fail(3))
    m = c.run()
    pre = m.throughput(100.0, 300.0)
    post = m.throughput(400.0, 800.0)
    print(f"  throughput before crash : {pre:8.0f} txn/s (4 nodes)")
    print(f"  throughput after crash  : {post:8.0f} txn/s (3 nodes)")
    zombie = sum(1 for r in c.replicas[:3] for q in r.lm.cq for l in q
                 if l.proc == 3)
    print(f"  leases of the dead node left in survivor queues: {zombie}")
    assert zombie == 0 and post > 0.5 * pre


def part2_elastic(device="cuda"):
    print("\n== 2. Elastic checkpoint restart ==")
    started = not dist.is_initialized()
    dev = init_world(device)
    try:
        gen = torch.Generator(dev).manual_seed(0)
        state = {"w": torch.randn((64, 64), generator=gen, device=dev),
                 "step_count": torch.tensor(0, dtype=torch.int32, device=dev)}
        with tempfile.TemporaryDirectory() as d:
            writer = checkpoint.AsyncCheckpointer(d)
            for step in range(1, 31):
                state = {"w": state["w"] * 0.999,
                         "step_count": torch.tensor(step, dtype=torch.int32,
                                                    device=dev)}
                if step % 10 == 0:
                    writer.submit(step, state)
            writer.close()
            print(f"  committed checkpoints: {checkpoint.committed_steps(d)}")

            # "lose" ranks: re-mesh on the survivors and restore re-sharded
            survivors = list(range(dist.get_world_size()))
            plan = elastic.plan_remesh(len(survivors), model_size=1)
            state2, step2, mesh = elastic.resume_after_failure(
                d, state, survivors, model_size=1, device=dev.type)
            print(f"  resumed at step {step2} on mesh {plan.mesh_shape}; "
                  f"w matches: {torch.allclose(state2['w'], state['w'])}")
            assert step2 == 30
    finally:
        if started:
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    part1_protocol(args.device)
    part2_elastic(args.device)
    print("\nok")


if __name__ == "__main__":
    main()
