"""The benchmark of the PyTorch + CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``bench/configs/
<name>.json``: the model as it is run, its ``family``, the module
``bench/families/<family>.py`` that lays out its weights and counts its
work, and its ``reference``, ``bench/reference/<reference>.py``) and a
traffic mix (``bench/traffic/<name>.json``, whose ``kind`` picks the
runner ``bench/kinds/<kind>.py``); ``bench/cells/<cell>.json`` holds the
limits ``correct`` is judged by, and each metric, end-to-end or
per-layer, is read by ``bench/metrics/<metric>.py``.  A new cell,
configuration, mix or metric is new files and entries; nothing here
names one.

A run: set-up (imports, the kernels' libraries from the checkout's
``build/``, the seed's weights made on the card, the cell's shapes
warmed up) is ``setup_s``; then whole steps or calls for ``--seconds``,
in a closed loop; then the peak memory is read, the program's state freed
and a sample of what the window produced recomputed by the float32
reference.  ``--trace 1`` follows the measured window with a second one
under the profiler, and reports the per-layer metrics (``mfu`` from the
first) instead of the end-to-end ones.  The last line of
standard output is the result; the last lines of standard error are the
numbers compared, each with its limit.

It exits non-zero with no result without the cards the cell asks for,
without the program beside it, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse                                                  # noqa: E402
import gc                                                        # noqa: E402
import importlib                                                 # noqa: E402
import importlib.util                                            # noqa: E402
import json                                                      # noqa: E402
import os                                                        # noqa: E402
import subprocess                                                # noqa: E402
import sys                                                       # noqa: E402
from dataclasses import dataclass                                # noqa: E402
from pathlib import Path                                         # noqa: E402
from typing import Any, Dict, List, Optional                     # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """A run that may not print a result."""


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Env:
    workload: str
    config: Dict[str, Any]           # bench/configs/<name>.json
    model: Dict[str, Any]            # its "model" section
    mix: Dict[str, Any]              # bench/traffic/<name>.json
    cell: Dict[str, Any]             # bench/cells/<workload>.json
    family: Any                      # bench/families/<its "family">.py
    seed: int
    device: Any
    cfg: Any = None                  # the program's ModelConfig


def _json(path: Path) -> Dict:
    return json.loads(path.read_text())


def spec() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def model_config(model: Dict):
    """The program's ``ModelConfig`` of a config file's model section."""
    from repro_torch.models.common import ModelConfig, SSMConfig

    fields = dict(model)
    ssm = fields.pop("ssm", None)
    return ModelConfig(**fields, ssm=SSMConfig(**ssm) if ssm else None)


def environment(workload: str, seed: int, device, *,
                model: Optional[Dict] = None, mix: Optional[Dict] = None
                ) -> Env:
    """The cell's files; ``model`` and ``mix`` replace the files' (the CPU
    tests run a cell's path at a small size)."""
    import traffic
    import weights

    cells = {w["name"]: w for w in spec()["workloads"]}
    if workload not in cells:
        raise Refused(f"unknown workload {workload!r}; known: "
                      f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec()["configs"]}
    config = _json(ROOT / configs[w["config"]]["file"])
    env = Env(workload=workload, config=config,
              model=model if model is not None else config["model"],
              mix=mix if mix is not None else traffic.load(w["traffic"]),
              cell=_json(HERE / "cells" / f"{workload}.json"),
              family=weights.load_family(config["family"]),
              seed=int(seed), device=device)
    env.cfg = model_config(env.model)
    return env


# ---------------------------------------------------------------------------
# Counters the program keeps: which kernels ran, and no plain twin
# ---------------------------------------------------------------------------

class PlainCalls:
    """Counts calls of the kernels' plain twins (``ops`` reaches them on
    the CPU, or when asked for the plain version)."""

    NAMES = ("sdpa_ref", "ssd_ref")

    def __init__(self):
        from repro_torch.kernels import ref

        self.ref = ref
        self.count = {n: 0 for n in self.NAMES}
        self.saved = {n: getattr(ref, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(ref, n, self._counted(n, self.saved[n]))

    def _counted(self, name, fn):
        def counted(*a, **kw):
            self.count[name] += 1
            return fn(*a, **kw)
        return counted

    def remove(self) -> None:
        for n, fn in self.saved.items():
            setattr(self.ref, n, fn)


def launches() -> Dict[str, Any]:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    return {"flash": fa.launches, "flash_variants": dict(fa.variant_launches),
            "flash_backward": fa.backward_launches,
            "flash_backward_variants": dict(fa.backward_variant_launches),
            "ssd": ss.launches, "ssd_variants": dict(ss.variant_launches),
            "ssd_backward": ss.backward_launches,
            "ssd_backward_variants": dict(ss.backward_variant_launches)}


def _delta(after: Dict, before: Dict) -> Dict:
    return {k: (_delta(v, before[k]) if isinstance(v, dict) else v - before[k])
            for k, v in after.items()}


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def _metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _window(runner, seconds: float):
    """Whole units of work until ``seconds`` have passed: the units, and
    the wall time from the start to the last one's completion."""
    import torch

    units: List[Dict] = []
    with torch.profiler.record_function("bench.window"):
        t0 = time.perf_counter()
        t_last = t0
        while time.perf_counter() - t0 < seconds:
            units.append(runner.unit())
            t_last = time.perf_counter()
    return units, t_last - t0


def _traced_window(runner, seconds: float) -> Dict:
    """A second window under the profiler, with the spans around the
    calls into each layer; the trace read against them."""
    import tracing

    spans = tracing.Spans()
    spans.install()
    try:
        with tracing.profiler() as prof:
            units, _ = _window(runner, seconds)
    finally:
        spans.remove()
    return {"units": units,
            "summary": tracing.read(tracing.events(prof), spans)}


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        *, model: Optional[Dict] = None, mix: Optional[Dict] = None
        ) -> Dict[str, Any]:
    """One run of ``workload``; the result line's object, with the numbers
    compared last under ``checks``."""
    import numpy as np
    import torch

    env = environment(workload, seed, device, model=model, mix=mix)
    runner = importlib.import_module(f"kinds.{env.mix['kind']}").Run(env)
    plain = PlainCalls()
    try:
        before = launches()
        runner.setup()
        _sync(device)
        setup_s = time.perf_counter() - T0 - runner.reading_s
        at_setup = launches()
        units, wall_s = _window(runner, seconds)
        window = _delta(launches(), at_setup)
        traced = _traced_window(runner, seconds) if trace else None
    finally:
        plain.remove()
    if torch.device(device).type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    found = forbidden_modules()
    if found:
        raise Refused("loaded by the window's close: " + ", ".join(found))

    done = units + (traced["units"] if trace else [])
    say("setup_s", setup_s, "window_s", wall_s, "units", len(units))
    say("launches", json.dumps({"setup": _delta(at_setup, before),
                                "window": window,
                                "plain_calls": plain.count}))
    summary = traced["summary"] if trace else None
    failed = sum(u["failed"] for u in done) + runner.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    side = runner.side()
    numbers = runner.numbers(side, runner.reference())
    say("check_s", time.perf_counter() - t_check)
    limits = env.cell["checks"]
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in limits) \
        and all(np.isfinite(v) for v in numbers.values())

    # what every reader may read: the measured window (unprofiled), the
    # set-up, the peak, and the profiled window's trace
    w = {"units": units, "wall_s": wall_s, "setup_s": setup_s,
         "peak_bytes": peak, "flops": runner.unit_flops * len(units),
         "trace": summary}
    metrics: Dict[str, Dict] = {}
    for m in spec()["per_layer" if trace else "end_to_end"]:
        if _applies(m, workload):
            v = _metric_reader(m["name"])(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        say("trace", json.dumps({k: summary[k] for k in (
            "window_s", "busy_s", "device_s", "op_device_s",
            "op_activities", "unplaced", "unplaced_names", "activities",
            "bound_s", "calls")}))
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": torch.cuda.get_device_name(device)
           if torch.device(device).type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": bool(correct),
              "attempted": sum(u["requests"] for u in done),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    return result


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise Refused(f"the program is not beside the benchmark "
                          f"({ROOT / 'src' / 'repro_torch'} is missing)")
        sys.path.insert(0, str(ROOT / "src"))
        cells = {w["name"]: w for w in spec()["workloads"]}
        chips = cells.get(args.workload, {}).get("chips", 1)
        import torch

        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise Refused(f"needs {chips} CUDA device(s); found "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        build = ROOT / "build"
        os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
        os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
        torch.set_num_threads(4)
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0))
    except Refused as exc:
        say(f"refused: {exc}")
        return 2
    say("card", power_limit())
    for name, c in result["checks"].items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
