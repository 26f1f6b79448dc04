"""The port's explorer re-finds every seeded protocol mutant with a
minimized, deterministically replayable counterexample — on the CPU, as
the reference does (``tests/test_explore_mutants.py``, case for case).

Ten mutants are single-schedule catchable; two — no-born-blocked and
stale-piggyback — are *schedule-dependent*: the default FIFO schedule
masks them and only exploring legal delivery reorderings exposes them.
Counterexample traces are the reference's JSON: one saved by either
package replays in the other with the same violation.
"""
import pytest

import repro.analysis.explore as JX
import repro.analysis.scenarios as JSC
from repro_torch.analysis.explore import (ExploreConfig, explore_scenario,
                                          main, replay_trace)
from repro_torch.analysis.scenarios import MUTANT_INVARIANTS, get_scenario
from repro_torch.analysis.trace import load_trace, save_trace

CFG = ExploreConfig(strategy="exhaustive", window_ms=0.6, max_schedules=400)
CPU = {"device": "cpu"}

SCHEDULE_ONLY = ("mutant-no-born-blocked", "mutant-stale-piggyback")


@pytest.mark.parametrize("name", sorted(MUTANT_INVARIANTS))
def test_explorer_finds_mutant_with_expected_invariant(name):
    res = explore_scenario(name, CFG, dict(CPU))
    assert not res.ok, f"{name}: explorer found no violation"
    inv, _detail = res.violation.violation
    assert inv == MUTANT_INVARIANTS[name]
    # minimization ran and preserved the invariant
    assert res.minimized is not None
    assert res.minimized.violation is not None
    assert res.minimized.violation[0] == MUTANT_INVARIANTS[name]


@pytest.mark.parametrize("name", sorted(MUTANT_INVARIANTS))
def test_minimized_counterexample_replays_deterministically(name):
    res = explore_scenario(name, CFG, dict(CPU))
    tr = res.minimized
    build = get_scenario(name)
    vio = replay_trace(lambda pol: build(dict(tr.args), pol), tr)
    assert vio is not None and vio[0] == MUTANT_INVARIANTS[name]


@pytest.mark.parametrize("name", SCHEDULE_ONLY)
def test_schedule_only_mutants_pass_the_default_schedule(name):
    """The acceptance property: a single-schedule sanitizer run CANNOT
    catch these — run 1 is exactly the default FIFO schedule and must be
    clean; only deeper exploration finds the interleaving."""
    res = explore_scenario(
        name, ExploreConfig(strategy="exhaustive", window_ms=0.6,
                            max_schedules=1, minimize=False), dict(CPU))
    assert res.ok, (f"{name} fired on the default schedule — it is not "
                    f"schedule-dependent: {res.violation.violation}")


@pytest.mark.parametrize("name", SCHEDULE_ONLY)
def test_schedule_only_mutants_minimize_to_one_deviation(name):
    """ddmin reduces the counterexample to the default schedule plus a
    single reordering — the one delivery swap that exposes the bug."""
    res = explore_scenario(name, CFG, dict(CPU))
    assert len(res.minimized.deviations()) == 1


@pytest.mark.parametrize("name", SCHEDULE_ONLY)
def test_clean_controls_explore_violation_free(name):
    """With the mutation disabled, the same scenario's full schedule space
    is clean — the counterexample indicts the mutant, not the harness."""
    res = explore_scenario(name, CFG, {"mutant": False, **CPU})
    assert res.ok
    assert not res.stats.truncated          # the whole space was covered
    assert res.stats.schedules >= 2         # and it genuinely branched


def test_cli_replay_reproduces_saved_counterexample(tmp_path):
    res = explore_scenario("mutant-no-born-blocked", CFG, dict(CPU))
    path = tmp_path / "counterexample.json"
    save_trace(path, res.minimized)
    # the artifact round-trips and the CLI confirms the same invariant
    tr = load_trace(path)
    assert tr.violation[0] == "quiescence"
    assert main(["replay", str(path), "--device", "cpu"]) == 0


@pytest.mark.parametrize("name", sorted(MUTANT_INVARIANTS))
def test_counterexamples_replay_across_the_two_packages(name, tmp_path):
    """A minimized counterexample saved by the reference replays in the
    port with the same violation, and one saved by the port in the
    reference; both minimize to the same deviations."""
    ref = JX.explore_scenario(
        name, JX.ExploreConfig(strategy="exhaustive", window_ms=0.6,
                               max_schedules=400))
    port = explore_scenario(name, CFG, dict(CPU))
    assert ref.minimized.deviations() == port.minimized.deviations()
    JX.save_trace(tmp_path / "ref.json", ref.minimized)
    save_trace(tmp_path / "port.json", port.minimized)

    tr = load_trace(tmp_path / "ref.json")
    build = get_scenario(name)
    vio = replay_trace(lambda pol: build(dict(tr.args, **CPU), pol), tr)
    assert vio is not None and vio[0] == MUTANT_INVARIANTS[name]

    jtr = JX.load_trace(tmp_path / "port.json")
    jbuild = JSC.get_scenario(name)
    vio = JX.replay_trace(lambda pol: jbuild(dict(jtr.args), pol), jtr)
    assert vio is not None and vio[0] == MUTANT_INVARIANTS[name]
