"""The port's examples (``examples/torch/*.py``) against the reference's
(``examples/*.py``), run in-process on the CPU.

Where a part takes long on the CPU it runs at a smaller size that both
scripts are given the same way (the port's part function takes it as an
argument whose default is the reference's value; the reference's script
gets it through its ``SimConfig`` name).
"""
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.serve.engine as JEng
import repro_torch.serve.engine as TEng

REPO = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "serve_migration", "train_100m", "failover_recovery")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_example(name):
    return _load(REPO / "examples" / f"{name}.py", f"ref_example_{name}")


def port_example(name):
    return _load(REPO / "examples" / "torch" / f"{name}.py",
                 f"torch_example_{name}")


def printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue(), out


@pytest.mark.parametrize("name", NAMES)
def test_every_reference_example_has_a_counterpart(name):
    port = (REPO / "examples" / "torch" / f"{name}.py").read_text()
    assert f"examples/{name}.py" in port and "--device" in port
    assert "import jax" not in port and "from repro." not in port


def _shortened(mod, monkeypatch, **kw):
    """The reference script's ``SimConfig`` with ``kw`` over its own
    arguments."""
    base = mod.SimConfig
    monkeypatch.setattr(mod, "SimConfig",
                        lambda **own: base(**{**own, **kw}))


def test_quickstart_part1_prints_the_reference_lines(monkeypatch):
    ref = ref_example("quickstart")
    _shortened(ref, monkeypatch, duration_ms=200.0, warmup_ms=40.0)
    want, _ = printed(ref.part1_cluster)
    got, _ = printed(port_example("quickstart").part1_cluster, "cpu",
                     duration_ms=200.0, warmup_ms=40.0)
    assert got == want
    assert "LILAC-TM-ST" in got and len(got.splitlines()) == 6


def test_quickstart_part2_metrics_key_for_key(monkeypatch):
    ref = ref_example("quickstart")
    engines = []

    class Recorded(JEng.MultiPodEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(ref, "MultiPodEngine", Recorded)
    want, _ = printed(ref.part2_serving)
    got, metrics = printed(port_example("quickstart").part2_serving, "cpu")
    assert got == want
    assert len(engines) == len(metrics) == 2
    for eng, (P, m) in zip(engines, metrics.items()):
        w = eng.metrics.as_dict()
        assert list(m) == list(w)
        for k in w:
            if k != "plan_block_s":           # host wall clock
                assert m[k] == w[k], (P, k)


def test_failover_part1_prints_the_reference_lines():
    want, _ = printed(ref_example("failover_recovery").part1_protocol)
    got, _ = printed(port_example("failover_recovery").part1_protocol, "cpu")
    assert got == want
    assert "left in survivor queues: 0" in got


def test_failover_part2_resumes_on_a_world_of_one():
    got, _ = printed(port_example("failover_recovery").part2_elastic, "cpu")
    assert got.splitlines()[2:] == [
        "  committed checkpoints: [10, 20, 30]",
        "  resumed at step 30 on mesh (1, 1); w matches: True"]
    assert not torch.distributed.is_initialized() or \
        torch.distributed.get_backend() == "gloo"


def _record_steps(monkeypatch, cls, log):
    step = cls.step

    def recorded(self, pod, sids):
        out = step(self, pod, sids)
        log.append((pod, {int(k): int(v) for k, v in out.items()}))
        return out

    monkeypatch.setattr(cls, "step", recorded)


@pytest.mark.parametrize("phase", ["reactive_phase", "planner_phase"])
def test_serve_migration_decodes_the_reference_tokens(phase, monkeypatch):
    """The reference's params carried across: the same lines, the same
    tokens decoded at each step, the same metrics (moves included)."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.models.common import init_params as jinit
    from repro_torch.configs import get_smoke_config as tsmoke
    from repro_torch.models.common import params_from_numpy

    jcfg = dataclasses.replace(jsmoke("glm4-9b"), dtype="float32")
    tcfg = dataclasses.replace(tsmoke("glm4-9b"), dtype="float32")
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                "cpu", torch.float32)
    jlog, tlog = [], []
    _record_steps(monkeypatch, JEng.RealBackend, jlog)
    _record_steps(monkeypatch, TEng.RealBackend, tlog)
    want, jeng = printed(_returning_engine(ref_example("serve_migration"),
                                           phase, monkeypatch), jcfg, jparams)
    got, teng = printed(getattr(port_example("serve_migration"), phase),
                        tcfg, tparams, "cpu")
    assert got == want
    assert tlog == jlog and sum(len(t) for _, t in tlog) > 10
    w, m = jeng.metrics.as_dict(), teng.metrics.as_dict()
    for k in w:
        if k != "plan_block_s":
            assert m[k] == w[k], k


def _returning_engine(mod, phase, monkeypatch):
    """The reference's phase, returning the engine it built."""
    engines = []

    class Recorded(JEng.MultiPodEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(mod, "MultiPodEngine", Recorded)

    def run(*args):
        getattr(mod, phase)(*args)
        return engines[-1]

    return run


def test_train_100m_loss_falls(tmp_path):
    """The script's trainer at a CPU size: 6 steps of 4 x 64 tokens (the
    script's batch; its loss falls from the sixth step on)."""
    got, out = printed(port_example("train_100m").main,
                       ["--device", "cpu", "--steps", "6", "--seq", "64",
                        "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 6 and out["last_loss"] < out["first_loss"]
    assert "preset=p100m" in got and got.rstrip().splitlines()[-1] == (
        f"first loss {out['first_loss']:.4f} -> last loss "
        f"{out['last_loss']:.4f}")
    assert (tmp_path / "step_00000006.COMMITTED").exists()
