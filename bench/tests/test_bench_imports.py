"""What the benchmark loads: no JAX and no JAX package anywhere in it,
and nothing of the program in its reference.  Top-level module names are
compared whole: ``repro_torch`` begins with ``repro`` and is not it."""
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

HARNESS = r"""
import importlib, importlib.util, json, sys
sys.path[:0] = [{bench!r}, {src!r}]
import run, tracing, traffic, weights, arith, compare, calibrate
import kinds.train, kinds.prefill, reference
spec = run.spec()
for w in spec["workloads"]:
    env = run.environment(w["name"], 2 ** 31 + 7, "cpu")
    env.family.param_shapes(env.model)
    reference.load(env.config["reference"])
    importlib.import_module("kinds." + env.mix["kind"])
for m in spec["end_to_end"] + spec["per_layer"]:
    run._metric_reader(m["name"])
from repro_torch.models import decoder
from repro_torch.train import train_step, optimizer
from repro_torch.kernels import ops, flash_attention, ssd_scan
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE = r"""
import json, sys
sys.path[:0] = [{bench!r}]
import reference, weights, traffic, compare, arith
for name in {refs!r}:
    reference.load(name)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _loaded(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_jax_package():
    names = _loaded(HARNESS.format(bench=str(BENCH), src=str(ROOT / "src")))
    assert "repro_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names


def test_the_reference_loads_nothing_of_the_program():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    refs = sorted({json.loads((ROOT / c["file"]).read_text())["reference"]
                   for c in spec["configs"]})
    names = _loaded(REFERENCE.format(bench=str(BENCH), refs=refs))
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, \
        names


def test_the_guard_compares_whole_names():
    sys.path.insert(0, str(BENCH))
    import run

    saved = dict(sys.modules)
    try:
        base = set(run.forbidden_modules())
        sys.modules["repro_torch_probe"] = sys.modules["json"]
        sys.modules["reprobe"] = sys.modules["json"]
        assert set(run.forbidden_modules()) == base
        sys.modules["jax.numpy"] = sys.modules["json"]
        sys.modules["repro.core"] = sys.modules["json"]
        assert {"jax", "repro"} <= set(run.forbidden_modules())
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
