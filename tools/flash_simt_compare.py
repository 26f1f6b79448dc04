"""Time the flash `simt` kernels of several checkouts in turns, on one card.

Each tree runs in a process of its own, with that tree's ``src`` on
``PYTHONPATH``, so each builds and uses its own kernels.  A run calls the
forward (``flash_attention.flash_attention``) at the shapes that reach
``simt``: deepseek-v2's MLA in f32 (2 x 2048, 128 heads, Dk 192, Dv 128,
causal), hubert-xlarge's encoder in f32 (4 x 2048, 16 heads, D 80,
bidirectional) and MLA's 3-token serving step (bf16, 2 x 3 rows over 2048
keys, the lse on); and the backward (``flash_attention_backward`` with
``variant="simt"``) at zamba2's attention in f32 (1 x 1024, 32 heads, D
64, causal) and, in bf16 at shapes ``tc`` takes, zamba2's (2 x 2048) and
MLA's (1 x 1024, 128 heads).  Inputs come from a seed; positions are
0..S-1 (the 3-token step's the cache's last three).  Give the trees in the
order to run them, e.g. parent, change, change, parent, so that a drift of
the host or the card shows::

    git archive HEAD | tar -x -C build/parent        # the parent commit
    python3 tools/flash_simt_compare.py build/parent . . build/parent

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per run: for each case the variant launched, the mean ms a call over CUDA
events, and a digest of the output's (and lse's) or the gradients' bits
(equal digests: equal bits).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# name: (kind, dtype, B, Sq, Skv, Hq, Hkv, Dk, Dv, causal, lse)
CASES = {
    "mla_f32": ("fwd", "float32", 2, 2048, 2048, 128, 128, 192, 128, True,
                False),
    "hubert_f32": ("fwd", "float32", 4, 2048, 2048, 16, 16, 80, 80, False,
                   False),
    "mla_step_bf16": ("fwd", "bfloat16", 2, 3, 2048, 128, 128, 192, 128, True,
                      True),
    "zamba2_bwd_f32": ("bwd", "float32", 1, 1024, 1024, 32, 32, 64, 64, True,
                       True),
    "zamba2_bwd_bf16": ("bwd", "bfloat16", 2, 2048, 2048, 32, 32, 64, 64,
                        True, True),
    "mla_bwd_bf16": ("bwd", "bfloat16", 1, 1024, 1024, 128, 128, 192, 128,
                     True, True),
}

RUNNER = r"""
import hashlib, json, sys
import torch
from repro_torch.kernels import flash_attention as fa
cases, iters = json.loads(sys.argv[1]), int(sys.argv[2])
fa.LIB.build()
dev = torch.device("cuda")
out = {}
for name, (kind, dtype, b, sq, skv, hq, hkv, dk, dv, causal,
           lse_on) in cases.items():
    gen = torch.Generator(device=dev).manual_seed(29)
    td = getattr(torch, dtype)
    q, k, v, w = (torch.randn(shape, generator=gen, device=dev).to(td)
                  for shape in ((b, sq, hq, dk), (b, skv, hkv, dk),
                                (b, skv, hkv, dv), (b, sq, hq, dv)))
    qp = torch.arange(skv - sq, skv, dtype=torch.int32,
                      device=dev).expand(b, sq).contiguous()
    kp = torch.arange(skv, dtype=torch.int32, device=dev).expand(b, skv) \
        .contiguous()
    kw = dict(q_positions=qp, kv_positions=kp, causal=causal)
    with torch.no_grad():
        if kind == "fwd":
            counts = fa.variant_launches
            call = lambda: fa.flash_attention(q, k, v, return_lse=lse_on,
                                              **kw)
        else:
            o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            counts = fa.backward_variant_launches
            call = lambda: fa.flash_attention_backward(
                q, k, v, o, lse, w, variant="simt", **kw)
        before = dict(counts)
        res = call()
        ran = [n for n, c in counts.items() if c != before[n]]
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
    for t in res if isinstance(res, tuple) else (res,):
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    out[name] = dict(variant=ran, ms=t0.elapsed_time(t1) / iters,
                     bits=digest.hexdigest()[:16])
    del q, k, v, w, res
    torch.cuda.empty_cache()
print("simt_result " + json.dumps(out), flush=True)
"""


def run(tree: Path, iters: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree.resolve() / "src"))
    proc = subprocess.run([sys.executable, "-c", RUNNER, json.dumps(CASES),
                           str(iters)], env=env, capture_output=True,
                          text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("simt_result ")]
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
