"""The f32 SSD gradient through ``ops.ssd``'s Function, in several processes.

Runs the card test ``test_cuda_ssd_function_grads_match_plain``'s f32 case
(B 2, S 763 padded to 768, H 4, P 64, N 128, chunk 256, no dfinal) for each
seed given, in ``--processes`` fresh processes one after another.  Per
process and seed it prints one JSON line with digests of the bits of the
Function's six gradients (``kernel``), of ``ref.ssd_bwd_ref`` on the same
padded inputs (``plain``) and of autograd through the plain forward
(``autograd``); each side's error against an fp64 evaluation of
``ref.ssd_bwd_ref``, per gradient, as a share of the fp64 gradient's
largest |value|; the errors the test checks (kernel against plain and
against autograd); and the digest of the kernel's gradients when the
caching allocator hands the backward's scratch out of memory filled with
NaN (``kernel_nan_scratch``: equal to ``kernel`` unless the backward reads
memory no launch wrote)::

    PYTHONPATH=src python3 tools/ssd_grad_digests.py --processes 6

Inputs are drawn as the test draws them (numpy ``default_rng``): x, dt, A,
B, C and h0 from ``seed``, the weight on y from ``seed + 1``.  The last
line sums up: for each seed and side, whether its digest was the same in
every process, and the largest error.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

GRADS = ("dx", "ddt", "da", "db", "dc", "dh0")
SHAPE = dict(b=2, s=3 * 256 - 5, h=4, p=64, n=128, chunk=256)


def child(seeds) -> None:
    import hashlib

    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ss

    dev = torch.device("cuda")
    b, s, h, p, n, chunk = (SHAPE[k] for k in ("b", "s", "h", "p", "n",
                                                "chunk"))
    pad = (-s) % chunk

    def digest(ts):
        hsh = hashlib.sha256()
        for t in ts:
            hsh.update(t.detach().contiguous().cpu().numpy().tobytes())
        return hsh.hexdigest()[:16]

    def inputs(seed):
        rng = np.random.default_rng(seed)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
            .to(dev)
        return (t(rng.standard_normal((b, s, h, p)) * 0.5),
                t(np.log1p(np.exp(rng.standard_normal((b, s, h))))),
                t(-np.exp(rng.standard_normal((h,)) * 0.3)),
                t(rng.standard_normal((b, s, 1, n)) * 0.4),
                t(rng.standard_normal((b, s, 1, n)) * 0.4),
                t(rng.standard_normal((b, h, p, n)) * 0.1))

    def grads_of(fn, ins, w):
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        out = fn(*leaves)
        return torch.autograd.grad((out.float() * w).sum(), leaves)

    def rel(got, want):
        return float((got.double() - want).abs().max()) / max(
            float(want.abs().max()), 1e-300)

    for seed in seeds:
        ins = inputs(seed)
        rng = np.random.default_rng(seed + 1)
        w = torch.from_numpy(rng.standard_normal((b, s, h, p))
                             .astype(np.float32)).to(dev)
        g_k = grads_of(lambda *a: ops.ssd(*a[:5], chunk=chunk, h0=a[5])[0],
                       ins, w)
        g_a = grads_of(lambda *a: ops.ssd(*a[:5], chunk=chunk, h0=a[5],
                                          plain=True)[0], ins, w)
        x, dt, a, bm, cm, h0 = ins
        padded = [ref.pad_seq(t, pad) for t in (x, dt, bm, cm)]
        args = (padded[0], padded[1], a, padded[2], padded[3], h0,
                ref.pad_seq(w, pad), None)
        g_p = ref.ssd_bwd_ref(*args, chunk=chunk)
        g_64 = ref.ssd_bwd_ref(*(None if t is None else t.double()
                                 for t in args), chunk=chunk)
        junk = torch.full((1 << 28,), float("nan"), device=dev)
        del junk
        g_nan = ss.ssd_scan_backward(*args, chunk=chunk)
        cut = lambda i, t: t[:, :s] if i in (0, 1, 3, 4) else t
        g_p = [cut(i, t) for i, t in enumerate(g_p)]
        g_64 = [cut(i, t) for i, t in enumerate(g_64)]
        g_nan = [cut(i, t) for i, t in enumerate(g_nan)]
        torch.cuda.synchronize()
        line = dict(
            pid=os.getpid(), seed=seed,
            matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
            precision=torch.get_float32_matmul_precision(),
            digests={"kernel": digest(g_k), "plain": digest(g_p),
                     "autograd": digest(g_a),
                     "kernel_nan_scratch": digest(g_nan)},
            vs_fp64={side: dict(zip(GRADS, (rel(t, t64) for t, t64
                                            in zip(gs, g_64))))
                     for side, gs in (("kernel", g_k), ("plain", g_p),
                                      ("autograd", g_a))},
            kernel_vs_plain=dict(zip(GRADS, (rel(t, t2.double()) for t, t2
                                             in zip(g_k, g_p)))),
            kernel_vs_autograd=dict(zip(GRADS, (rel(t, t2.double())
                                                for t, t2 in zip(g_k, g_a)))))
        print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=6)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[4, 0, 1, 2, 3, 5, 6, 7, 8])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.seeds)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lines = []
    for _ in range(args.processes):
        run = subprocess.run(
            [sys.executable, __file__, "--child", "--seeds",
             *map(str, args.seeds)], capture_output=True, text=True)
        sys.stdout.write(run.stdout)
        if run.returncode:
            sys.stderr.write(run.stderr)
            return run.returncode
        lines += [json.loads(ln) for ln in run.stdout.splitlines()]
    summary = {}
    for seed in args.seeds:
        mine = [ln for ln in lines if ln["seed"] == seed]
        summary[seed] = {
            "same_digest": {side: len({ln["digests"][side] for ln in mine})
                            == 1 for side in mine[0]["digests"]},
            "max_vs_fp64": {side: max(max(ln["vs_fp64"][side].values())
                                      for ln in mine)
                            for side in mine[0]["vs_fp64"]},
            "max_da_vs_fp64": {side: max(ln["vs_fp64"][side]["da"]
                                         for ln in mine)
                               for side in mine[0]["vs_fp64"]},
            "max_kernel_vs_plain": max(max(ln["kernel_vs_plain"].values())
                                       for ln in mine),
            "max_kernel_vs_autograd": max(
                max(ln["kernel_vs_autograd"].values()) for ln in mine)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
