"""Device time of each kernel of the SSD `simt` pair, under torch.profiler.

    PYTHONPATH=src python3 tools/ssd_simt_profile.py

Runs the forward (``ssd_scan.ssd_scan``) at mamba2-780m's and zamba2-1.2b's
prefills in f32 (4 x 2048, 48 heads at N 128; 64 heads at N 64; P 64,
chunk 256) and the backward (``ssd_scan_backward``, ``variant="simt"``, with
h0 and the final state's gradient) at zamba2's shape in f32 (1 x 1024) and
bf16 (2 x 2048) and mamba2's in f32 (1 x 1024), a few calls each after a
warm-up, and prints the card's ``nvidia-smi`` name and power limit, then one
JSON line per case: each kernel's name, its device microseconds a call and
its launches a call.  Inputs come from a seed.
"""
from __future__ import annotations

import json
import subprocess
import sys

# name: (kind, dtype, B, S, H, P, N, chunk)
CASES = {
    "fwd_mamba2_f32": ("fwd", "float32", 4, 2048, 48, 64, 128, 256),
    "fwd_zamba2_f32": ("fwd", "float32", 4, 2048, 64, 64, 64, 256),
    "bwd_zamba2_f32": ("bwd", "float32", 1, 1024, 64, 64, 64, 256),
    "bwd_zamba2_bf16": ("bwd", "bfloat16", 2, 2048, 64, 64, 64, 256),
    "bwd_mamba2_f32": ("bwd", "float32", 1, 1024, 48, 64, 128, 256),
}
CALLS = 5


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ssd_scan as ss

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    ss.LIB.build()
    for name, (kind, dtype, b, s, h, p, n, chunk) in CASES.items():
        gen = torch.Generator(device=dev).manual_seed(30)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        td = getattr(torch, dtype)
        x = (rnd(b, s, h, p) * 0.5).to(td)
        dt = torch.nn.functional.softplus(rnd(b, s, h))
        a = -torch.exp(rnd(h) * 0.3)
        bm, cm = ((rnd(b, s, 1, n) * 0.4).to(td) for _ in range(2))
        h0 = rnd(b, h, p, n) * 0.1
        dy = rnd(b, s, h, p).to(td)
        dfinal = rnd(b, h, p, n)
        if kind == "fwd":
            call = lambda: ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk, h0=h0)
        else:
            call = lambda: ss.ssd_scan_backward(
                x, dt, a, bm, cm, h0, dy, dfinal, chunk=chunk,
                variant="simt")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
        kernels = sorted(
            ({"kernel": e.key.split("(")[0],
              "us": e.device_time_total / CALLS,
              "launches": e.count / CALLS}
             for e in prof.key_averages()
             if e.device_time_total > 0 and not e.is_user_annotation),
            key=lambda r: -r["us"])
        print(json.dumps({"case": name, "kernels": kernels}), flush=True)
        del x, bm, cm, dy
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
