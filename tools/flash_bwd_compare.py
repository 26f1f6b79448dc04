"""Time the flash backward kernels of several checkouts in turns, on one card.

Each tree runs in a process of its own, with that tree's ``src`` on
``PYTHONPATH``, so each builds and uses its own kernels.  A run calls
``flash_attention.flash_attention_backward`` (the variant the tree's
launcher picks) at chip_smoke's kernel_grad shapes: bf16, positions
0..S-1, inputs from a seed, the forward's ``out`` and lse.  Give the trees
in the order to run them, e.g. parent, change, change, parent, so that a
drift of the host or the card shows::

    git archive HEAD | tar -x -C build/parent        # the parent commit
    python3 tools/flash_bwd_compare.py build/parent . . build/parent

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per run: for each case the variant launched, the mean ms a call over
CUDA events, and a digest of the gradients' bits (equal digests: equal
gradients).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# name: (B, S, Hq, Hkv, Dk, Dv, causal, window, softcap)
CASES = {
    "zamba2_attention": (2, 2048, 32, 32, 64, 64, True, 0, 0.0),
    "glm4_attention": (1, 2048, 32, 2, 128, 128, True, 0, 0.0),
    "hubert_attention": (2, 1024, 16, 16, 80, 80, False, 0, 0.0),
    "window_softcap": (1, 2048, 16, 8, 128, 128, True, 512, 50.0),
    "mla_attention": (1, 1024, 128, 128, 192, 128, True, 0, 0.0),
    "mla_attention_train": (2, 2048, 128, 128, 192, 128, True, 0, 0.0),
}

RUNNER = r"""
import hashlib, json, sys
import torch
from repro_torch.kernels import flash_attention as fa
cases, iters = json.loads(sys.argv[1]), int(sys.argv[2])
fa.LIB.build()
dev = torch.device("cuda")
out = {}
for name, (b, s, hq, hkv, dk, dv, causal, window, cap) in cases.items():
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=dev)
                     .to(torch.bfloat16) for shape in
                     ((b, s, hq, dk), (b, s, hkv, dk), (b, s, hkv, dv),
                      (b, s, hq, dv)))
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s) \
        .contiguous()
    kw = dict(q_positions=pos, kv_positions=pos, causal=causal,
              sliding_window=window or None, logit_softcap=cap)
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        before = dict(fa.backward_variant_launches)
        call = lambda: fa.flash_attention_backward(q, k, v, o, lse, dout,
                                                   **kw)
        grads = call()
        ran = [n for n, c in fa.backward_variant_launches.items()
               if c != before[n]]
        for _ in range(3):
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
    for g in grads:
        digest.update(g.contiguous().view(torch.int16).cpu().numpy()
                      .tobytes())
    out[name] = dict(variant=ran, ms=t0.elapsed_time(t1) / iters,
                     bits=digest.hexdigest()[:16])
    del q, k, v, dout, o, lse, grads
print("bwd_result " + json.dumps(out), flush=True)
"""


def run(tree: Path, iters: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree.resolve() / "src"))
    proc = subprocess.run([sys.executable, "-c", RUNNER, json.dumps(CASES),
                           str(iters)], env=env, capture_output=True,
                          text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("bwd_result ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n"
                         f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return dict(tree=str(tree), **json.loads(lines[-1].split(" ", 1)[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--iters", type=int, default=20)
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
