"""Time a train step of several checkouts in turns, on one card.

Each tree runs in a process of its own, with that tree's ``src`` on
``PYTHONPATH``, so each builds and uses its own kernels.  Two cells
(``--cell``): ``zamba2`` runs ``repro_torch.launch.train`` (``--no-mesh``,
zamba2-1.2b at full width and depth); ``deepseek-depth1`` runs
deepseek-v2-236b at full width cut to its first (dense) layer through
``train_step.make_train_step`` with seeded fp32 masters, the loop
``launch.train`` runs (which has no depth flag).  Both take 2 x 2048
tokens of ``SyntheticLM`` a step.  Give the trees in the order to run
them, e.g. parent, change, change, parent, so that a drift of the host or
the card shows::

    git archive HEAD | tar -x -C build/parent        # the parent commit
    python3 tools/train_step_compare.py build/parent . . build/parent
    python3 tools/train_step_compare.py --cell deepseek-depth1 \
        build/parent . . build/parent

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per run (tree, mean step seconds after the first step, tokens/s, peak
device memory in GB, the losses).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

BATCH, SEQ = 2, 2048

RUNNER = r"""
import json, sys
from repro_torch.launch import train
res = train.main(sys.argv[1:])
print("train_result " + json.dumps({k: res[k] for k in
      ("steps", "step_s", "peak_mem_gb", "losses")}), flush=True)
"""

# launch.train's loop over make_train_step, at a depth it cannot be given,
# on chip_smoke's train_mla config (scaled_config(arch, "full") with
# n_layers replaced).  It stays self-contained: it also runs against parent
# trees that have no train_mla phase to import.
DEPTH_RUNNER = r"""
import dataclasses, json, sys, time
import numpy as np
import torch
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.train import scaled_config
from repro_torch.models import decoder
from repro_torch.models.common import init_params
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step
arch, layers, steps, batch, seq = sys.argv[1], *map(int, sys.argv[2:])
dev = torch.device("cuda")
cfg = dataclasses.replace(scaled_config(arch, "full"), n_layers=layers)
params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev,
                     torch.float32)
state = opt.init(params)
step_fn = make_train_step(cfg, decoder.RunCtx(dev), TrainConfig())
ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                            global_batch=batch, seed=0))
torch.cuda.reset_peak_memory_stats(dev)
losses, stamps = [], []
for i in range(steps):
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in ds.batch(i).items()}
    params, state, m = step_fn(params, state, b)
    losses.append(float(m["loss"]))
    torch.cuda.synchronize(dev)
    stamps.append(time.time())
print("train_result " + json.dumps(dict(
    steps=steps, step_s=float(np.mean(np.diff(stamps))),
    peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
    losses=losses)), flush=True)
"""

# cell: (runner, its arguments before the step count's)
CELLS = {
    "zamba2": (RUNNER, lambda steps: [
        "--no-mesh", "--arch", "zamba2-1.2b", "--preset", "full", "--steps",
        str(steps), "--batch", str(BATCH), "--seq", str(SEQ), "--log-every",
        str(steps)]),
    "deepseek-depth1": (DEPTH_RUNNER, lambda steps: [
        "deepseek-v2-236b", "1", str(steps), str(BATCH), str(SEQ)]),
}


def run(tree: Path, cell: str, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree.resolve() / "src"))
    runner, args = CELLS[cell]
    proc = subprocess.run([sys.executable, "-c", runner, *args(steps)],
                          env=env, capture_output=True, text=True,
                          check=False)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("train_result ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n"
                         f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    res = json.loads(lines[-1].split(" ", 1)[1])
    return dict(tree=str(tree), cell=cell, **res,
                tokens_per_s=BATCH * SEQ / res["step_s"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--cell", choices=sorted(CELLS), default="zamba2")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi, flush=True)
    for tree in args.trees:
        print(json.dumps(run(tree, args.cell, args.steps)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
