"""Time the SSD `simt` kernels of several checkouts in turns, on one card.

Each tree runs in a process of its own, with that tree's ``src`` on
``PYTHONPATH``, so each builds and uses its own kernels.  A run calls the
forward (``ssd_scan.ssd_scan``) at the shapes that reach ``simt``:
mamba2-780m's prefill in f32 (4 x 2048, 48 heads, P 64, N 128, chunk 256),
zamba2-1.2b's in f32 (4 x 2048, 64 heads, N 64) and the reference grid's
first case (2 x 256, 8 heads, P 16, N 32, chunk 64); and the backward
(``ssd_scan_backward``, with h0 and the final state's gradient) at
zamba2's shape in f32 (1 x 1024, ``simt``), in bf16 at 2 x 2048 asked for
by name (``variant="simt"``) and as it runs there (``tc``, whose phase (ii)
is the simt backward's ``own_kernel``).  Inputs come from a seed.  Give the
trees in the order to run them, e.g. parent, change, change, parent, so
that a drift of the host or the card shows::

    git archive HEAD | tar -x -C build/parent        # the parent commit
    python3 tools/ssd_simt_compare.py build/parent . . build/parent

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per run: for each case the variant launched, the mean ms a call over CUDA
events, and a digest of the outputs' bits (equal digests: equal bits).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# name: (kind, dtype, B, S, H, P, N, chunk, backward variant)
CASES = {
    "mamba2_f32": ("fwd", "float32", 4, 2048, 48, 64, 128, 256, None),
    "zamba2_f32": ("fwd", "float32", 4, 2048, 64, 64, 64, 256, None),
    "grid0_f32": ("fwd", "float32", 2, 256, 8, 16, 32, 64, None),
    "zamba2_bwd_f32": ("bwd", "float32", 1, 1024, 64, 64, 64, 256, "simt"),
    "zamba2_bwd_bf16_simt": ("bwd", "bfloat16", 2, 2048, 64, 64, 64, 256,
                             "simt"),
    "zamba2_bwd_bf16_tc": ("bwd", "bfloat16", 2, 2048, 64, 64, 64, 256,
                           None),
}

RUNNER = r"""
import hashlib, json, sys
import torch
from repro_torch.kernels import ssd_scan as ss
cases, iters = json.loads(sys.argv[1]), int(sys.argv[2])
ss.LIB.build()
dev = torch.device("cuda")
out = {}
for name, (kind, dtype, b, s, h, p, n, chunk, want) in cases.items():
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
        counts = ss.variant_launches
        call = lambda: ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    else:
        counts = ss.backward_variant_launches
        call = lambda: ss.ssd_scan_backward(x, dt, a, bm, cm, h0, dy, dfinal,
                                            chunk=chunk, variant=want)
    before = dict(counts)
    res = call()
    ran = [k for k, c in counts.items() if c != before[k]]
    call()
    torch.cuda.synchronize(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        call()
    t1.record()
    torch.cuda.synchronize(dev)
    digest = hashlib.sha256()
    for t in res:
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    out[name] = dict(variant=ran, ms=t0.elapsed_time(t1) / iters,
                     bits=digest.hexdigest()[:16])
    del x, bm, cm, dy, res
    torch.cuda.empty_cache()
print("ssd_result " + json.dumps(out), flush=True)
"""


def run(tree: Path, iters: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree.resolve() / "src"))
    proc = subprocess.run([sys.executable, "-c", RUNNER, json.dumps(CASES),
                           str(iters)], env=env, capture_output=True,
                          text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("ssd_result ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n"
                         f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return dict(tree=str(tree), **json.loads(lines[-1].split(" ", 1)[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi, flush=True)
    for tree in args.trees:
        print(json.dumps(run(tree, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
