"""repro_torch.analysis.explore on the CPU, held to repro.analysis.explore.

The reference's ``tests/test_explore.py`` case for case (trace round-trip,
ddmin, identity-policy byte-identity on a real cluster, POR reduction, the
smoke grid, the CLI) against the port with ``device="cpu"``.  Then every
registered scenario explored by both packages: the same outcome, invariant,
``ExploreStats`` field for field and minimized deviations; and the kernel
cell (every drain through ``validate_batch``'s drain route, every settle
through the device ops; their CPU twins here) exploring the schedules the
numpy-path cell explores.
"""
import dataclasses
from dataclasses import replace

import numpy as np
import pytest

import repro.analysis.explore as JX
from repro_torch.analysis.explore import (KERNEL_CELL, SMOKE_CELLS,
                                          ExploreConfig, ExploreStats,
                                          _explore_exhaustive, _smoke_build,
                                          explore_scenario, main, run_smoke)
from repro_torch.analysis.scenarios import SCENARIOS
from repro_torch.analysis.trace import Cand, Decision, Trace, ddmin
from repro_torch.core.events import SchedulePolicy

CPU = {"device": "cpu"}


# ---------------------------------------------------------------------------
# ddmin
# ---------------------------------------------------------------------------

def test_ddmin_reduces_to_the_failing_core():
    items = list(range(16))
    culprits = {3, 11}
    calls = []

    def test_fn(subset):
        calls.append(list(subset))
        return culprits <= set(subset)

    out = ddmin(items, test_fn)
    assert sorted(out) == sorted(culprits)
    # 1-minimality: dropping either remaining element loses the failure
    for x in out:
        assert not test_fn([y for y in out if y != x])


def test_ddmin_single_culprit_and_degenerate_inputs():
    assert ddmin([7], lambda s: True) == [7]
    assert ddmin([], lambda s: True) == []
    out = ddmin(list(range(10)), lambda s: 4 in s)
    assert out == [4]


# ---------------------------------------------------------------------------
# Trace JSON round-trip
# ---------------------------------------------------------------------------

def test_trace_json_roundtrip():
    tr = Trace(
        model="mutant-stale-piggyback", args={"mutant": True},
        window_ms=0.6,
        violation=("blocked-and-drained", "piggyback on blocked LOR"),
        decisions=[
            Decision(time=1.05, chosen=9, default=4, cands=[
                Cand(seq=4, time=1.05, kind="to", node=0, label="to:lease:1",
                     keys=(0,), eligible=True),
                Cand(seq=9, time=1.05, kind="opt", node=0,
                     label="opt:lease:2", keys=(0, 2), eligible=True),
                Cand(seq=12, time=1.05, kind="to", node=1, label="",
                     keys=None, eligible=False),
            ]),
            Decision(time=2.0, chosen=20, default=20,
                     cands=[Cand(seq=20, time=2.0)]),
        ])
    back = Trace.from_json(tr.to_json())
    assert back.to_json() == tr.to_json()
    assert back.violation == tr.violation
    assert back.chosen == [9, 20]
    assert back.deviations() == [(0, 9)]
    assert back.decisions[0].cands[1].keys == (0, 2)
    assert back.decisions[0].cands[2].eligible is False


# ---------------------------------------------------------------------------
# Identity: the policy seam is byte-invisible when it never reorders
# ---------------------------------------------------------------------------

def test_identity_policy_byte_identical_to_no_policy():
    from repro_torch.core.cluster import Cluster, SimConfig
    from repro_torch.core.workloads import BankWorkload

    def run(explore):
        cfg = SimConfig(n_nodes=3, threads_per_node=2, n_items=48,
                        n_classes=6, duration_ms=40.0, warmup_ms=0.0,
                        drain_ms=30.0, certify_jax_min=1 << 30,
                        lease_jax_min=1 << 30, seed=3, sanitize=True,
                        explore=explore, device="cpu")
        wl = BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items,
                          locality=0.6)
        c = Cluster(cfg, wl)
        c.run()
        c.events.run(cfg.duration_ms + cfg.drain_ms + 60_000.0)
        return c

    a = run(None)
    b = run(ExploreConfig(policy=SchedulePolicy()))
    assert a.metrics.commits == b.metrics.commits > 0
    assert a.events.n_dispatched == b.events.n_dispatched
    for ra, rb in zip(a.replicas, b.replicas):
        assert np.array_equal(ra.store.versions, rb.store.versions)
        assert np.array_equal(ra.store.values, rb.store.values)


# ---------------------------------------------------------------------------
# Smoke grid: every CI cell is green, including handoff="pipelined"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(SMOKE_CELLS)),
                         ids=[f"{n}-{a.get('lease_mode', 'pct')}-"
                              f"{a.get('handoff', '')}".rstrip("-")
                              for n, a, _ in SMOKE_CELLS])
def test_smoke_cell_green(i):
    name, args, cfg = SMOKE_CELLS[i]
    res = explore_scenario(name, cfg, dict(args, **CPU))
    assert res.ok, f"{name} {args}: {res.violation.violation}"
    if cfg.strategy == "exhaustive":
        # the cell is sized so POR+dedup exploration COMPLETES in budget
        assert not res.stats.truncated
        assert res.stats.schedules > 1      # it genuinely explored
    # and the reference's grid explores the same schedules
    j_name, j_args, j_cfg = JX.SMOKE_CELLS[i]
    assert (name, args, dataclasses.asdict(cfg)) == \
        (j_name, j_args, dataclasses.asdict(j_cfg))
    ref = JX.explore_scenario(name, j_cfg, args)
    assert dataclasses.asdict(res.stats) == dataclasses.asdict(ref.stats)


def test_pipelined_handoff_cell_present_and_explored():
    """Promotion gate for handoff="pipelined": its schedule space (not just
    the default schedule) is model-checked clean — see ROADMAP."""
    cells = [(n, a) for n, a, _ in SMOKE_CELLS
             if a.get("handoff") == "pipelined"]
    assert len(cells) >= 2       # sequential + batched control planes


def test_por_reduction_at_least_2x_on_smoke_cell():
    name, args, cfg = SMOKE_CELLS[0]
    args = dict(args, **CPU)
    reduced = explore_scenario(name, cfg, args)
    assert reduced.ok and not reduced.stats.truncated
    naive_stats = ExploreStats()
    naive_cfg = replace(cfg, por=False, dedup=False, minimize=False)
    _explore_exhaustive(lambda pol: _smoke_build(name, args, pol),
                        naive_cfg, naive_stats)
    ratio = naive_stats.runs / max(1, reduced.stats.runs)
    assert ratio >= 2.0, (f"POR+dedup reduction {ratio:.2f}x "
                          f"({naive_stats.runs} naive vs "
                          f"{reduced.stats.runs} reduced)")


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

def test_cli_list_and_scenario_run(capsys):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "smoke-bank" in out and "mutant-stale-piggyback" in out

    assert main(["--scenario", "mutant-double-grant", "--device", "cpu",
                 "--max-schedules", "50"]) == 1
    out = capsys.readouterr().out
    assert "VIOLATION [single-owner]" in out


def test_cli_scenario_writes_replayable_trace(tmp_path):
    rc = main(["--scenario", "mutant-no-born-blocked", "--window-ms", "0.6",
               "--max-schedules", "400", "--out", str(tmp_path),
               "--device", "cpu"])
    assert rc == 1
    path = tmp_path / "counterexample-mutant-no-born-blocked.json"
    assert path.exists()
    assert main(["replay", str(path), "--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# The port against the reference, scenario by scenario
# ---------------------------------------------------------------------------

def test_registry_equals_the_references():
    from repro.analysis.scenarios import MUTANT_INVARIANTS as J_INV
    from repro.analysis.scenarios import SCENARIOS as J_SCENARIOS
    from repro_torch.analysis.scenarios import MUTANT_INVARIANTS

    assert sorted(SCENARIOS) == sorted(J_SCENARIOS)
    assert MUTANT_INVARIANTS == J_INV
    assert len(SCENARIOS) == 14 and len(MUTANT_INVARIANTS) == 12


def _summary(res):
    tr = res.minimized
    return dict(
        ok=res.ok, stats=dataclasses.asdict(res.stats),
        invariant=None if res.ok else res.violation.violation[0],
        minimized=None if tr is None else (tr.violation[0],
                                           tr.deviations()))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_explores_to_the_references_result(name):
    """Outcome, invariant, every ExploreStats field and the minimized
    counterexample's deviations, for exhaustive exploration at the
    mutant suite's window (the smoke cells at a bounded budget)."""
    cfg = ExploreConfig(strategy="exhaustive", window_ms=0.6,
                        max_schedules=400 if name.startswith("mutant")
                        else 60)
    got = explore_scenario(name, cfg, dict(CPU))
    want = JX.explore_scenario(
        name, JX.ExploreConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)}))
    assert _summary(got) == _summary(want)


def test_kernel_cell_explores_the_numpy_cells_schedules():
    """KERNEL_CELL (jax_min 1: every drain through the drain route, every
    settle through the device ops, their twins on the CPU) is violation-free
    and explores exactly the schedules of its numpy-path twin in
    SMOKE_CELLS — the verdicts are the same, so is the schedule space."""
    name, args, cfg = KERNEL_CELL
    twin = next(c for n, a, c in SMOKE_CELLS
                if n == name and a == {k: v for k, v in args.items()
                                       if k != "jax_min"})
    assert cfg == twin
    res = explore_scenario(name, cfg, dict(args, **CPU))
    assert res.ok and not res.stats.truncated
    ref = JX.explore_scenario(name, twin, {k: v for k, v in args.items()
                                           if k != "jax_min"})
    assert dataclasses.asdict(res.stats) == dataclasses.asdict(ref.stats)


def test_run_smoke_records_every_cell():
    rec = []
    assert run_smoke(max_schedules=30, quiet=True, device="cpu",
                     record=rec) == 0
    assert [r[0] for r in rec] == [n for n, _, _ in SMOKE_CELLS]
    assert all(r[2].ok and r[3] > 0 for r in rec)
