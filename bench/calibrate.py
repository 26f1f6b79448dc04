"""The readings a cell's limits are set from, on the card at the cell's
own size: for each seed the numbers ``correct`` compares, for the program
and for what stands in its place.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--controls 3]

Per seed, one JSON line: ``program`` (the program's readings against the
float32 reference, after set-up and as many calls as the check samples),
and on the first ``--controls`` seeds ``control`` (the reference rounded
to fp8, put in the program's place) and, for training, ``half_batch`` (the
reference on half of each batch, the mean over the rest) and
``ssd_grads_zeroed`` (the program with the SSD backward's dA and ddt
zeroed).  Training also records ``own_norm``: the worst leaf's gap
against its own norm alone, and which leaf.  A state left unchanged reads
1 on ``update_gap`` by the measure and needs no run.  The benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))

import torch                                                   # noqa: E402

import compare                                                 # noqa: E402
import run as bench                                            # noqa: E402
import weights                                                 # noqa: E402


def readings(workload: str, seed: int, control: bool, device) -> dict:
    import importlib

    env = bench.environment(workload, seed, device)
    runner = importlib.import_module(f"kinds.{env.mix['kind']}").Run(env)
    t0 = time.perf_counter()
    runner.setup()
    if env.mix["kind"] == "prefill":
        calls = math.ceil(env.mix["check_requests"] / env.mix["batch"])
        for _ in range(calls):
            runner.unit()
    runner.release()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": seed, "program_s": time.perf_counter() - t0}
    side = runner.side()
    t0 = time.perf_counter()
    ref = runner.reference()
    out["reference_s"] = time.perf_counter() - t0
    out["program"] = runner.numbers(side, ref)
    if control:
        t0 = time.perf_counter()
        ctl = runner.reference(fp8=True)
        out["control_s"] = time.perf_counter() - t0
        if env.mix["kind"] == "prefill":
            ctl = compare.control_side(ctl)
        out["control"] = runner.numbers(ctl, ref)
        if env.mix["kind"] == "train":
            half = runner.reference(rows=env.mix["batch"] // 2)
            out["half_batch"] = runner.numbers(half, ref)
    if env.mix["kind"] == "train":
        names = [".".join(map(str, p)) for p, _ in
                 weights.paths(env.family.param_shapes(env.model))]
        out["own_norm"] = _named(compare.own_norm_gaps(side, ref), names)
        if control:
            fault = _ssd_grads_zeroed(workload, seed, device)
            out["ssd_grads_zeroed"] = {
                **runner.numbers(fault, ref),
                **_named(compare.own_norm_gaps(fault, ref), names)}
    return out


def _named(gaps: dict, names: list) -> dict:
    return {k: (g, names[i]) for k, (g, i) in gaps.items()}


class _NoGrad(torch.autograd.Function):
    """Identity that passes no gradient back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def _ssd_grads_zeroed(workload: str, seed: int, device) -> dict:
    """The readings of the program with the SSD's backward returning dA
    and ddt as zeros (A_log and dt_bias get no gradient, nor w_in's dt
    columns)."""
    import importlib

    from repro_torch.kernels import ops

    ssd = ops.ssd

    def broken(x, dt, a, b_mat, c_mat, **kw):
        return ssd(x, _NoGrad.apply(dt), _NoGrad.apply(a), b_mat, c_mat,
                   **kw)

    env = bench.environment(workload, seed, device)
    runner = importlib.import_module(f"kinds.{env.mix['kind']}").Run(env)
    ops.ssd = broken
    try:
        runner.setup()
    finally:
        ops.ssd = ssd
    runner.release()
    gc.collect()
    torch.cuda.empty_cache()
    return runner.side()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(args.workload, seed, i < args.controls,
                                  device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
