"""The command refuses, with no result line, where it may not measure:
without a card, and in a directory that holds only the benchmark."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ARGS = ["--workload", "glm4-9b.prefill-short", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_no_card_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a host with a card measures: the refusal is the CPU's")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
