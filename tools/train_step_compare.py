"""Time the zamba2-1.2b train step of several checkouts in turns, on one card.

Each tree runs ``repro_torch.launch.train`` (``--no-mesh``, zamba2-1.2b
at full width and depth, 2 x 2048 tokens) in a process of its own, with
that tree's ``src`` on ``PYTHONPATH``, so each builds and uses its own
kernels.  Give the trees in the order to run them, e.g. parent, change,
change, parent, so that a drift of the host or the card shows::

    git archive HEAD | tar -x -C build/parent        # the parent commit
    python3 tools/train_step_compare.py build/parent . . build/parent

Prints one JSON line per run (tree, mean step seconds after the first
step, peak device memory in GB, the losses) and the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

RUNNER = r"""
import json, sys
from repro_torch.launch import train
res = train.main(sys.argv[1:])
print("train_result " + json.dumps({k: res[k] for k in
      ("steps", "step_s", "peak_mem_gb", "losses")}), flush=True)
"""


def run(tree: Path, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree.resolve() / "src"))
    args = ["--no-mesh", "--arch", "zamba2-1.2b", "--preset", "full",
            "--steps", str(steps), "--batch", "2", "--seq", "2048",
            "--log-every", str(steps)]
    proc = subprocess.run([sys.executable, "-c", RUNNER, *args], env=env,
                          capture_output=True, text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("train_result ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n"
                         f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return dict(tree=str(tree), **json.loads(lines[-1].split(" ", 1)[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi, flush=True)
    for tree in args.trees:
        print(json.dumps(run(tree, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
