"""The control on the card, at each cell's own size: the float32 reference
rounded to fp8 (``reference.decoder``'s ``fp8=True``), put in the
program's place, fails one of the cell's numbers on each of three seeds,
while the program passes all of them.  Marked ``cuda``; skips without a
card.

    python -m pytest -q -m cuda bench/tests/test_bench_control.py
"""
import pytest
import torch

import calibrate
import run as bench

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
CELLS = [w["name"] for w in bench.spec()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_control_is_not_correct(card, workload):
    limits = bench.environment(workload, 0, "cpu").cell["checks"]
    for seed in SEEDS:
        out = calibrate.readings(workload, seed, True, card)
        assert all(out["program"][k] <= v for k, v in limits.items()), out
        assert any(out["control"][k] > v for k, v in limits.items()), out
