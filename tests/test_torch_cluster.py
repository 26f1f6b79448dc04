"""Seeded simulator runs of the port on the CPU, byte-identical to repro.core.

Bank (with a node failure at 120 ms) and a small TPC-C layout run through
both packages over {sequential, batched} lease mode x {sequential, batched}
certify mode, with every drain through the batched certification path
(``certify_jax_min=1``), every settle through the device path
(``lease_jax_min=1``) and per-transaction slot costs.  The replica stores,
``commit_times`` and every ``Metrics`` counter must match.

Also here: the port imports neither jax nor anything of repro, and the
default device refuses to run without a card.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T

REPO = Path(__file__).resolve().parents[1]
MODES = [(lease, cert) for lease in ("sequential", "batched")
         for cert in ("sequential", "batched")]


def _run(pkg, workload, lease_mode, certify_mode):
    kw = dict(duration_ms=150.0, warmup_ms=30.0, seed=1,
              lease_mode=lease_mode, certify_mode=certify_mode,
              certify_jax_min=1, lease_jax_min=1, cert_slot_mode="per_txn")
    if pkg is T:
        kw["device"] = "cpu"
    if workload == "bank":
        cfg = pkg.SimConfig(**kw)
        wl = pkg.BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items,
                              locality=0.6)
        c = pkg.make_cluster("LILAC-TM-ST", wl, cfg)
        c.events.schedule(120.0, lambda: c.gcs.fail(3))
    else:
        lay = pkg.TpccLayout(n_nodes=4)
        ccmap = pkg.TpccConflictMap(lay)
        cfg = pkg.SimConfig(n_items=lay.n_items, n_classes=ccmap.n_classes,
                            **kw)
        c = pkg.make_cluster("LILAC-TM-ST", pkg.TpccWorkload(lay), cfg,
                             ccmap=ccmap)
    m = c.run()
    return c, dataclasses.asdict(m)


@pytest.mark.parametrize("workload", ["bank", "tpcc"])
@pytest.mark.parametrize("lease_mode,certify_mode", MODES)
def test_port_byte_identical_to_reference(workload, lease_mode,
                                          certify_mode):
    ref, m_ref = _run(J, workload, lease_mode, certify_mode)
    port, m_port = _run(T, workload, lease_mode, certify_mode)
    assert m_port == m_ref               # incl. commit_times and cert_batches
    assert m_ref["commits"] > 0 and m_ref["rw_commits"] > 0
    if certify_mode == "batched":
        assert m_ref["cert_batches"] > 0
    for a, b in zip(ref.replicas, port.replicas):
        assert a.store.values.tobytes() == b.store.values.tobytes()
        assert a.store.versions.tobytes() == b.store.versions.tobytes()
        assert a.store.clock == b.store.clock
        np.testing.assert_array_equal(b.store.device_versions().numpy(),
                                      b.store.versions.astype(np.int32))
        assert a.lm.owner_view() == b.lm.owner_view()


def test_load_state_starts_from_reference_state():
    """A port cluster seeded with a reference replica's state continues
    byte-identically to the reference cluster seeded the same way."""
    src, _ = _run(J, "bank", "sequential", "sequential")
    state = src.replicas[0].store
    runs = []
    for pkg in (J, T):
        kw = dict(duration_ms=60.0, warmup_ms=10.0, seed=4,
                  certify_jax_min=1)
        if pkg is T:
            kw["device"] = "cpu"
        cfg = pkg.SimConfig(**kw)
        c = pkg.make_cluster("LILAC-TM-ST", pkg.BankWorkload(
            n_nodes=cfg.n_nodes, n_items=cfg.n_items), cfg)
        if pkg is T:
            c.load_state(state.values, state.versions, state.clock)
        else:
            for r in c.replicas:
                r.store.values[:] = state.values
                r.store.versions[:] = state.versions
                r.store.clock = state.clock
        runs.append((dataclasses.asdict(c.run()),
                     [r.store.values.tobytes() for r in c.replicas]))
    assert runs[0] == runs[1]


def test_traced_run_matches_reference_trace():
    """The copied recorder sees the same events as the reference's, and
    tracing does not perturb the run."""
    out = []
    for pkg in (J, T):
        kw = dict(duration_ms=80.0, warmup_ms=10.0, seed=2, trace=True)
        if pkg is T:
            kw["device"] = "cpu"
        cfg = pkg.SimConfig(**kw)
        c = pkg.make_cluster("LILAC-TM-ST", pkg.BankWorkload(
            n_nodes=cfg.n_nodes, n_items=cfg.n_items, locality=0.6), cfg)
        out.append((dataclasses.asdict(c.run()), c.trace.to_events()))
    assert out[0] == out[1]
    assert len(out[1][1]) > 100


@pytest.mark.parametrize("rel", [
    "core/conflict.py", "core/events.py", "core/forwarder.py", "core/gcs.py",
    "core/lease.py", "core/stats.py", "core/workloads.py", "obs/trace.py",
])
def test_framework_free_modules_are_copies(rel):
    """The port re-hosts these reference modules verbatim (only the
    package-relative import of the recorder differs)."""
    ref = (REPO / "src/repro" / rel).read_text()
    port = (REPO / "src/repro_torch" / rel).read_text()
    ref = ref.replace("from repro.obs import trace as obs_trace",
                      "from ..obs import trace as obs_trace")
    assert port == ref


def test_unported_options_raise():
    """The sanitizer and the explorer still raise; SimConfig.plan is ported
    and runs (held byte for byte to repro.core in test_torch_plan.py)."""
    from repro_torch.plan import SIM_PLAN_DEFAULTS

    cfg = T.SimConfig(device="cpu", sanitize=True)
    wl = T.BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items)
    with pytest.raises(NotImplementedError, match="sanitize"):
        T.Cluster(cfg, wl)
    with pytest.raises(NotImplementedError, match="explore"):
        T.Cluster(T.SimConfig(device="cpu", explore=object()), wl)
    cfg = T.SimConfig(device="cpu", plan=SIM_PLAN_DEFAULTS, n_classes=64,
                      duration_ms=200.0, warmup_ms=20.0)
    c = T.Cluster(cfg, wl)
    m = c.run()
    assert c.planner is not None and c.planner.device.type == "cpu"
    assert m.plan_epochs > 0 and m.commits > 0


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")


def test_default_device_raises_without_card(no_card):
    cfg = T.SimConfig()
    assert cfg.device == "cuda"
    wl = T.BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Cluster(cfg, wl)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.VersionedStore(8)


def test_port_imports_neither_jax_nor_repro():
    """Every module of repro_torch, and chip_smoke.py, import without
    loading jax or any module of the reference package."""
    code = f"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {str(REPO / 'src')!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location(
    'chip_smoke', {str(REPO / 'chip_smoke.py')!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
assert not bad, bad
assert 'repro_torch.core.cluster' in names, names
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 17
