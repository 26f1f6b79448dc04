"""The port's explorer gives the same ``ExploreStats`` in any process.

A cell run in fresh interpreters with different ``PYTHONHASHSEED`` values
must explore the same schedules: a set or dict of strings iterated in hash
order anywhere on the explored path (the explorer's sleep sets, the
fingerprint, the cluster, the planner) would show here as a difference.
Each run is a subprocess; this file imports no JAX.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# the cell, as the cross-package comparison runs it
# (test_torch_explore.py::test_scenario_explores_to_the_references_result),
# and its pct form in SMOKE_CELLS
CELLS = {
    "exhaustive": "ExploreConfig(strategy='exhaustive', window_ms=0.6, "
                  "max_schedules=60)",
    "pct": "next(c for n, a, c in SMOKE_CELLS "
           "if n == 'smoke-planner-failure')",
}

PROGRAM = """
import dataclasses, json
from repro_torch.analysis.explore import (ExploreConfig, SMOKE_CELLS,
                                          explore_scenario)
res = explore_scenario("smoke-planner-failure", {cfg}, {{"device": "cpu"}})
print(json.dumps(dict(ok=res.ok, **dataclasses.asdict(res.stats))))
"""


def _stats(cfg: str, hash_seed: str) -> dict:
    env = dict(os.environ, PYTHONHASHSEED=hash_seed,
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", PROGRAM.format(cfg=cfg)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=240, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_planner_failure_cell_is_equal_under_two_hash_seeds(cell):
    a, b = (_stats(CELLS[cell], seed) for seed in ("0", "1"))
    assert a["ok"] and a["schedules"] > 1
    assert a == b
