"""A later cell, configuration, mix or metric is new files and entries
only: a copy of the benchmark gains them with no file of the benchmark
edited, and a run reports them."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

SCRIPT = r"""
import json, sys
sys.path[:0] = [{bench!r}, {src!r}, {tests!r}]
import run, smoke
{call}
print(json.dumps(out))
"""

# a metric and a mix on an existing configuration, at smoke size
NEW_MIX = """out = run.run("glm4-9b.prefill-tiny", 2 ** 31 + 3, 0.5, True, "cpu",
              model=smoke.model("glm4-9b"), mix=smoke.mix("prefill-tiny"))"""
# a configuration of a family the benchmark did not have, read from its
# files alone
NEW_CONFIG = """out = run.run("tiny.prefill-tiny", 2 ** 31 + 4, 0.5, True, "cpu")"""

TINY = {"name": "tiny", "source": "a test", "family": "tiny",
        "reference": "tiny",
        "model": dict(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                      vocab_size=128, mlp_act="swiglu", norm_eps=1e-5,
                      rope_theta=1e4, max_seq_len=256, dtype="bfloat16")}


def _checkout(tmp_path: Path) -> Path:
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    (copy / "src").symlink_to(ROOT / "src")
    return copy


def _files(copy: Path) -> dict:
    return {p.relative_to(copy): p.read_bytes()
            for p in (copy / "bench").rglob("*") if p.is_file()}


def _add(copy: Path, spec: dict) -> None:
    """The new files and entries: a metric reader, a mix, a family, a
    reference, a configuration and two cells."""
    b = copy / "bench"
    (b / "metrics" / "dummy.calls.py").write_text(
        "def read(w):\n    return float(w['trace']['calls']['attention'])\n")
    (b / "traffic" / "prefill-tiny.json").write_text(json.dumps(
        {"kind": "prefill", "batch": 1, "seq_len": 64, "warmup_calls": 1,
         "check_requests": 1}))
    (b / "families" / "tiny.py").write_text(
        (BENCH / "families" / "decoder.py").read_text())
    (b / "reference" / "tiny.py").write_text(
        (BENCH / "reference" / "decoder.py").read_text())
    (b / "configs" / "tiny.json").write_text(json.dumps(TINY))
    for cell in ("glm4-9b.prefill-tiny", "tiny.prefill-tiny"):
        (b / "cells" / f"{cell}.json").write_text(
            (BENCH / "cells" / "glm4-9b.prefill-short.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "a test",
                            "file": "bench/configs/tiny.json",
                            "reduced": [], "why": "a test configuration"})
    for name, config in (("glm4-9b.prefill-tiny", "glm4-9b"),
                         ("tiny.prefill-tiny", "tiny")):
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": "prefill-tiny", "chips": 1,
                                  "why": "a test cell"})
    spec["per_layer"].append({"name": "dummy.calls", "unit": "calls",
                              "better": "higher", "source": "program_span",
                              "layer": "kernels", "moves": "tokens_per_s",
                              "workloads": ["glm4-9b.prefill-tiny",
                                            "tiny.prefill-tiny"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))


def _run(copy: Path, call: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(
            bench=str(copy / "bench"), src=str(copy / "src"),
            tests=str(copy / "bench" / "tests"), call=call)],
        capture_output=True, text=True, env=env, cwd=copy, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_new_metric_mix_and_cell_need_no_edit(tmp_path):
    copy = _checkout(tmp_path)
    before = _files(copy)
    _add(copy, json.loads((copy / "BENCHMARK.json").read_text()))
    for call in (NEW_MIX, NEW_CONFIG):
        result = _run(copy, call)
        assert result["metrics"]["dummy.calls"]["value"] > 0
        assert "mfu" in result["metrics"]
        assert result["attempted"] >= 1 and result["correct"]
    for path, data in before.items():
        assert (copy / path).read_bytes() == data, path
