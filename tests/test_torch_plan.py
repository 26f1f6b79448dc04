"""repro_torch.plan held to repro.plan on the CPU.

The port's scorer (torch ops on the planner's device) equals the numpy
twin ``score_moves_np`` bit for bit and the reference's jit within its own
test's tolerance (rtol 1e-5 / atol 1e-7); its async form returns a
pending result; the copies of ``price_move_costs`` and ``score_moves_np``
are pinned to the reference's code.  Plans equal the reference's on the
same inputs, ``SimConfig.plan`` runs are byte-identical to ``repro.core``'s,
and the reference's planner tests (``tests/test_plan.py``) run against the
port.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro.plan as JP
import repro_torch.core as T
from repro.plan import score_moves as jscore_moves
from repro.dist.locality import price_session_dispatch as \
    jprice_session_dispatch
from repro_torch.core import BankWorkload, SimConfig, make_cluster
from repro_torch.dist.locality import price_session_dispatch
from repro_torch.plan import (AffinityTracker, PendingScores,
                              PlacementPlanner, PlanConfig,
                              SIM_PLAN_DEFAULTS, price_move_costs,
                              score_moves, score_moves_async,
                              score_moves_np)

REPO = Path(__file__).resolve().parents[1]


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# Scoring: the port == numpy twin (bitwise) ~ the reference's jit
# ---------------------------------------------------------------------------

def _rand_inputs(seed, c=24, n=6):
    rng = np.random.default_rng(seed)
    rates = rng.random((c, n)) * rng.choice([0.0, 0.02], (c, 1))
    owner = rng.integers(-1, n, c).astype(np.int32)
    fwd = rng.random(c) * 2e-3
    mv = rng.random(c) * 3e-3
    cpu = rng.random(n) * 1.2
    co = rng.random((c, c)) * 0.01
    return rates, owner, fwd, mv, cpu, co


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("co_gain", [0.0, 0.3])
def test_score_moves_jit_matches_numpy_twin(seed, co_gain):
    """The reference's test, on the port: bitwise against the numpy twin
    (which the reference holds only within 1e-5), and within the
    reference's tolerance of its jit."""
    rates, owner, fwd, mv, cpu, co = _rand_inputs(seed)
    kw = dict(horizon_ms=400.0, margin=2.5, min_frac=0.3, min_rate=1e-3,
              load_gain=0.05, co_gain=co_gain, co_rates=co, max_cpu=0.9)
    a = score_moves(rates, owner, fwd, mv, cpu, device="cpu", **kw)
    b = score_moves_np(rates, owner, fwd, mv, cpu, **kw)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    j = jscore_moves(rates, owner, fwd, mv, cpu, **kw)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(j))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], j[fin], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("c,n", [(1, 1), (7, 3), (300, 8), (64, 16),
                                 (33, 17), (20, 129), (9, 300)])
def test_score_moves_bitwise_across_shapes(c, n):
    """Row totals below 8, at 8..128 and above 128 columns (numpy's three
    summation regimes), float64 and float32 inputs, all knobs on."""
    rng = np.random.default_rng(c * 1000 + n)
    rates = rng.random((c, n)) * rng.choice([0.0, 0.05, 1e-39], (c, 1))
    owner = rng.integers(-1, n, c).astype(np.int32)
    args = (rates.astype(np.float32) if n % 2 else rates, owner,
            rng.random(c) * 2e-3, rng.random(c) * 3e-3, rng.random(n) * 1.2)
    for kw in (dict(horizon_ms=500.0, margin=3.0, min_frac=0.7,
                    min_rate=0.016, load_gain=0.02),
               dict(horizon_ms=200.0, margin=4.0, min_frac=0.0,
                    min_rate=0.0, co_gain=0.25,
                    co_rates=rng.random((c, c)) * 0.02,
                    overload_ctrl=False)):
        np.testing.assert_array_equal(
            _bits(score_moves(*args, device="cpu", **kw)),
            _bits(score_moves_np(*args, **kw)))


def test_score_moves_async_returns_a_pending_result():
    rates, owner, fwd, mv, cpu, co = _rand_inputs(3)
    kw = dict(horizon_ms=400.0, margin=2.5, min_frac=0.3, min_rate=1e-3)
    fut = score_moves_async(rates, owner, fwd, mv, cpu, device="cpu", **kw)
    assert isinstance(fut, PendingScores)
    want = score_moves_np(rates, owner, fwd, mv, cpu, **kw)
    np.testing.assert_array_equal(_bits(fut.wait()), _bits(want))
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            score_moves_async(rates, owner, fwd, mv, cpu, **kw)


def _code_of(path, name):
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if getattr(n, "name", None) == name)
    if ast.get_docstring(fn) is not None:
        fn.body = fn.body[1:]
    return ast.dump(fn)


@pytest.mark.parametrize("name", ["price_move_costs", "score_moves_np"])
def test_twins_are_pinned_copies(name):
    assert _code_of(REPO / "src/repro_torch/plan/score.py", name) == \
        _code_of(REPO / "src/repro/plan/score.py", name)


def test_score_masks_owner_unowned_overload_and_noise():
    rates = np.array([[0.01, 0.02], [0.0, 0.03], [0.01, 0.0],
                      [1e-9, 2e-9]])
    owner = np.array([0, -1, 0, 0], np.int32)
    fwd = np.full(4, 1e-3)
    mv = np.zeros(4)
    cpu = np.array([0.0, 0.95])
    s = score_moves(rates, owner, fwd, mv, cpu, horizon_ms=100.0,
                    min_rate=1e-6, max_cpu=0.9, device="cpu")
    assert np.isneginf(s[:, 0]).all()      # own column masked
    assert np.isneginf(s[1]).all()         # unowned class masked
    assert np.isneginf(s[:, 1]).all()      # overloaded target masked (3)
    s2 = score_moves(rates, owner, fwd, mv, np.zeros(2), horizon_ms=100.0,
                     min_rate=1e-6, max_cpu=0.9, device="cpu")
    assert np.isfinite(s2[0, 1])           # feasible target scores
    assert np.isneginf(s2[3, 1])           # sub-min_rate evidence masked


def test_price_move_costs_matches_price_session_dispatch():
    state = np.array([0.0, 5e5, 2.6e6, 1e9])
    work = np.full(4, 5120.0)
    for shards in (1, 4):
        f, m = price_move_costs(state, work, seq_shards=shards)
        jf, jm = JP.price_move_costs(state, work, seq_shards=shards)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(m, jm)
        for i in range(len(state)):
            ref = price_session_dispatch(work[i], 0.0, state[i],
                                         wire_bytes_per_token=1.0,
                                         seq_shards=shards)
            assert dataclasses.asdict(ref) == dataclasses.asdict(
                jprice_session_dispatch(work[i], 0.0, state[i],
                                        wire_bytes_per_token=1.0,
                                        seq_shards=shards))
            assert f[i] == pytest.approx(ref.migrate_work_s)
            assert m[i] == pytest.approx(ref.migrate_state_s)


@pytest.mark.parametrize("seed", range(6))
def test_plans_equal_reference(seed):
    """The same affinity counts and inputs give the reference's plan, move
    for move (scores included), over several epochs with committed moves
    and a mid-epoch mutation between begin and finish."""
    rng = np.random.default_rng(100 + seed)
    n, c = int(rng.integers(2, 9)), int(rng.integers(1, 60))
    cfg_kw = dict(top_k=int(rng.integers(1, 6)),
                  node_budget_bytes=float(rng.choice([5e5, 2e6, np.inf])),
                  margin=float(rng.random() * 2),
                  min_frac=float(rng.random() * 0.6),
                  min_events=float(rng.choice([0.0, 4.0])),
                  load_gain=float(rng.choice([0.0, 0.05])),
                  co_gain=float(rng.choice([0.0, 0.25])))
    tp = PlacementPlanner(n, c, PlanConfig(**cfg_kw), device="cpu")
    jp = JP.PlacementPlanner(n, c, JP.PlanConfig(**cfg_kw))
    # the moves exactly; their scores within the tolerance the reference
    # holds its own jit to its numpy twin (the port's scores are the
    # twin's, bit for bit: test_score_moves_jit_matches_numpy_twin)
    key = lambda pl: [(m.cc, m.src, m.dst, m.state_bytes) for m in pl.moves]
    score = lambda pl: [m.score for m in pl.moves]
    for epoch in range(4):
        for _ in range(int(rng.integers(5, 40))):
            t, node = float(epoch * 10 + rng.random()), int(rng.integers(n))
            ccs = tuple(int(x) for x in rng.integers(0, c, rng.integers(1, 3)))
            for p in (tp, jp):
                p.affinity.record_commit(t, node, ccs)
                if node % 2:
                    p.affinity.record_forward(t, node, ccs[:1])
        owner = rng.integers(-1, n, c).astype(np.int32)
        state = rng.random(c) * 2e6
        fwd, mv = price_move_costs(state, np.full(c, 5120.0))
        cpu = rng.random(n) * 1.2
        now = float(epoch * 10 + 10)
        pending = tp.begin(now, owner, state, fwd, mv, cpu)
        want = jp.plan(now, owner, state, fwd, mv, cpu)
        tp.affinity.record_touch(now, 0, tuple(range(c)))
        jp.affinity.record_touch(now, 0, tuple(range(c)))
        got = tp.finish(pending)
        assert key(got) == key(want)
        np.testing.assert_allclose(score(got), score(want), rtol=1e-5,
                                   atol=1e-7)
        assert (got.epoch, got.n_candidates) == (want.epoch,
                                                 want.n_candidates)
        tp.committed(got.moves[::2])
        jp.committed(want.moves[::2])


# ---------------------------------------------------------------------------
# SimConfig.plan: the simulator with the planner, against repro.core
# ---------------------------------------------------------------------------

def _plan_cluster(pkg, workload, plan, lease_mode="batched"):
    kw = dict(duration_ms=300.0, warmup_ms=30.0, seed=1, plan=plan,
              certify_jax_min=1, lease_mode=lease_mode)
    if pkg is T:
        kw["device"] = "cpu"
    if workload == "bank":
        cfg = pkg.SimConfig(n_classes=64, **kw)
        c = pkg.make_cluster("LILAC-TM-ST", pkg.BankWorkload(
            n_nodes=cfg.n_nodes, n_items=cfg.n_items, locality=0.6), cfg)
        c.events.schedule(120.0, lambda: c.gcs.fail(3))
    else:
        lay = pkg.TpccLayout(n_nodes=4)
        ccmap = pkg.TpccConflictMap(lay)
        cfg = pkg.SimConfig(n_items=lay.n_items, n_classes=ccmap.n_classes,
                            **kw)
        c = pkg.make_cluster("LILAC-TM-ST", pkg.TpccWorkload(lay), cfg,
                             ccmap=ccmap)
    return c, dataclasses.asdict(c.run())


@pytest.mark.parametrize("workload,lease_mode", [
    ("bank", "batched"), ("tpcc", "sequential")])
def test_sim_plan_byte_identical_to_reference(workload, lease_mode):
    """SIM_PLAN_DEFAULTS on Bank (a node failing at 120 ms: purge_node)
    and TPC-C: stores, commit times and every counter equal repro.core's,
    planner epochs and prefetches included."""
    jc, jm = _plan_cluster(J, workload, JP.SIM_PLAN_DEFAULTS, lease_mode)
    tc, tm = _plan_cluster(T, workload, SIM_PLAN_DEFAULTS, lease_mode)
    assert dataclasses.asdict(SIM_PLAN_DEFAULTS) == \
        dataclasses.asdict(JP.SIM_PLAN_DEFAULTS)
    assert tm == jm
    assert jm["plan_epochs"] > 0 and jm["plan_prefetches"] > 0
    for a, b in zip(jc.replicas, tc.replicas):
        assert a.store.values.tobytes() == b.store.values.tobytes()
        assert a.store.versions.tobytes() == b.store.versions.tobytes()
        assert a.lm.owner_view() == b.lm.owner_view()
    assert tc.planner.device.type == "cpu"
    assert tc.planner.planned_moves == jc.planner.planned_moves


# ---------------------------------------------------------------------------
# Plan invariants (property tests)
# ---------------------------------------------------------------------------

def _planner_with_counts(counts, cfg):
    n_nodes, n_classes = counts.shape
    p = PlacementPlanner(n_nodes, n_classes, cfg, device="cpu")
    p.affinity.node.counts[:] = counts
    return p


@pytest.mark.parametrize("seed", range(20))
def test_plan_respects_budgets_and_cpu_feasibility(seed):
    """A PlacementPlan NEVER targets a CPU-infeasible node, never exceeds
    top_k moves, never exceeds the per-node inbound byte budget, and never
    plans a no-op (dst == src)."""
    rng = np.random.default_rng(seed)
    n, c = int(rng.integers(2, 8)), int(rng.integers(1, 40))
    counts = rng.random((n, c)) * rng.choice([0.0, 30.0], (1, c))
    cfg = PlanConfig(
        top_k=int(rng.integers(1, 6)),
        node_budget_bytes=float(rng.choice([5e5, 2e6, np.inf])),
        margin=float(rng.random() * 2), min_frac=float(rng.random() * 0.6),
        min_events=float(rng.choice([0.0, 4.0])),
        load_gain=float(rng.choice([0.0, 0.05])))
    p = _planner_with_counts(counts, cfg)
    owner = rng.integers(-1, n, c).astype(np.int32)
    state = rng.random(c) * 2e6
    fwd, mv = price_move_costs(state, np.full(c, 5120.0))
    cpu = rng.random(n) * 1.2
    plan = p.plan(0.0, owner, state, fwd, mv, cpu)

    assert len(plan.moves) <= cfg.top_k
    spent = np.zeros(n)
    for m in plan.moves:
        assert cpu[m.dst] < cfg.max_cpu          # constraint (3)
        assert m.src == owner[m.cc] and m.dst != m.src
        spent[m.dst] += m.state_bytes
    assert (spent <= cfg.node_budget_bytes + 1e-9).all()


def test_plan_hysteresis_blocks_reversals():
    """A move that reverses one *executed* (reported via committed())
    within the last W epochs is rejected; after W epochs it is admitted
    again.  Unexecuted plans leave no phantom history."""
    n, c = 2, 1
    cfg = PlanConfig(top_k=4, hysteresis_epochs=3, margin=0.0, min_frac=0.0,
                     min_events=0.0, node_budget_bytes=np.inf)
    p = PlacementPlanner(n, c, cfg, device="cpu")
    state = np.zeros(c)
    fwd = np.full(c, 1e-3)
    mv = np.zeros(c)
    cpu = np.zeros(n)

    # epoch 1: class 0 is hot at node 1, owned by node 0 -> move 0 -> 1
    p.affinity.node.counts[:] = [[0.0], [50.0]]
    plan = p.plan(0.0, np.array([0]), state, fwd, mv, cpu)
    assert [(m.cc, m.src, m.dst) for m in plan.moves] == [(0, 0, 1)]
    p.committed(plan.moves)
    assert p.planned_moves == 1
    # flip the affinity: node 0 now dominates — the reversal (-> 0) must be
    # blocked for W epochs even though it scores best
    p.affinity.node.counts[:] = [[50.0], [0.0]]
    for _ in range(cfg.hysteresis_epochs - 1):
        plan = p.plan(0.0, np.array([1]), state, fwd, mv, cpu)
        assert not plan.moves
    plan = p.plan(0.0, np.array([1]), state, fwd, mv, cpu)
    assert [(m.cc, m.src, m.dst) for m in plan.moves] == [(0, 1, 0)]


def test_plan_unexecuted_moves_leave_no_phantom_hysteresis():
    """A planned move the executor skipped (dead node, stale ownership)
    must not block the class's real move as a 'reversal'."""
    cfg = PlanConfig(top_k=4, hysteresis_epochs=5, margin=0.0, min_frac=0.0,
                     min_events=0.0, node_budget_bytes=np.inf)
    p = PlacementPlanner(2, 1, cfg, device="cpu")
    p.affinity.node.counts[:] = [[0.0], [50.0]]
    args = (np.zeros(1), np.full(1, 1e-3), np.zeros(1), np.zeros(2))
    plan = p.plan(0.0, np.array([0]), *args)
    assert plan.moves                      # planned 0 -> 1, NOT committed
    assert p.planned_moves == 0
    p.affinity.node.counts[:] = [[50.0], [0.0]]
    plan = p.plan(0.0, np.array([1]), *args)
    assert [(m.cc, m.src, m.dst) for m in plan.moves] == [(0, 1, 0)]


def test_planner_idle_without_evidence():
    """min_events keeps the planner from acting on two-touch noise."""
    p = PlacementPlanner(4, 8, PlanConfig(min_events=6.0, min_frac=0.5),
                         device="cpu")
    p.affinity.record_touch(0.0, 2, (3,))
    p.affinity.record_touch(1.0, 2, (3,))
    owner = np.zeros(8, np.int32)
    state = np.zeros(8)
    fwd, mv = price_move_costs(state, np.full(8, 5120.0))
    plan = p.plan(2.0, owner, state, fwd, mv, np.zeros(4))
    assert not plan.moves and plan.n_candidates == 0


def test_async_plan_byte_identical_to_sync():
    """begin() epoch-stamps every input (affinity rates, owner, state
    bytes), so a plan finished after arbitrary mid-epoch mutation — new
    affinity events, the caller scribbling over its arrays — is
    byte-identical to the synchronous plan at the begin instant."""
    rng = np.random.default_rng(5)
    n, c = 4, 24
    counts = rng.random((n, c)) * 40.0
    cfg = PlanConfig(top_k=8, margin=0.0, min_frac=0.0, min_events=0.0,
                     node_budget_bytes=np.inf)
    p_sync = _planner_with_counts(counts, cfg)
    p_async = _planner_with_counts(counts.copy(), cfg)
    owner = rng.integers(0, n, c).astype(np.int32)
    state = rng.random(c) * 1e6
    fwd, mv = price_move_costs(state, np.full(c, 5120.0))
    cpu = rng.random(n) * 0.5
    want = p_sync.plan(0.0, owner, state, fwd, mv, cpu)
    assert want.moves                       # a vacuous identity proves nothing

    pending = p_async.begin(0.0, owner, state, fwd, mv, cpu)
    # mid-epoch: decode steps record fresh affinity, the caller reuses its
    # buffers — none of it may leak into the already-begun epoch
    p_async.affinity.record_touch(0.0, 1, tuple(range(c)))
    owner[:] = -1
    state[:] = 0.0
    got = p_async.finish(pending)
    key = lambda pl: [(m.cc, m.src, m.dst, m.state_bytes, m.score)
                      for m in pl.moves]
    assert key(got) == key(want)
    assert (got.epoch, got.n_candidates) == (want.epoch, want.n_candidates)


def test_async_plan_view_change_invalidates_purged_nodes():
    """purge_node between begin and finish bumps the membership view: the
    pending plan's moves naming the purged node (as src or dst) are
    dropped at harvest, moves between survivors land untouched."""
    n, c = 3, 2
    cfg = PlanConfig(top_k=4, margin=0.0, min_frac=0.0, min_events=0.0,
                     node_budget_bytes=np.inf)
    counts = np.zeros((n, c))
    counts[1, 0] = 50.0     # class 0 (owned by 0) is hot at node 1
    counts[2, 1] = 50.0     # class 1 (owned by 0) is hot at node 2
    p = _planner_with_counts(counts, cfg)
    owner = np.zeros(c, np.int32)
    state = np.zeros(c)
    fwd, mv = np.full(c, 1e-3), np.zeros(c)
    cpu = np.zeros(n)

    pending = p.begin(0.0, owner, state, fwd, mv, cpu)
    p.purge_node(1)                         # mid-epoch view change
    plan = p.finish(pending)
    assert [(m.cc, m.dst) for m in plan.moves] == [(1, 2)]

    # a purge BEFORE begin is part of the epoch's view — nothing to drop,
    # and the purged node's zeroed affinity no longer attracts anyway
    pending = p.begin(0.0, owner, state, fwd, mv, cpu)
    plan = p.finish(pending)
    assert [(m.cc, m.dst) for m in plan.moves] == [(1, 2)]


# ---------------------------------------------------------------------------
# Affinity tracker
# ---------------------------------------------------------------------------

def test_affinity_forward_weight_and_abort_damping():
    a = AffinityTracker(2, 4, tau_ms=100.0, forward_weight=2.0,
                        abort_weight=1.0)
    a.record_commit(0.0, 0, (1,))
    a.record_forward(0.0, 0, (1,))
    r = a.rates(0.0)
    assert r[1, 0] == pytest.approx(3.0 / 100.0)     # 1 + weighted 2
    a.record_abort(0.0, 0, (1,))
    assert a.rates(0.0)[1, 0] == pytest.approx(2.0 / 100.0)
    # damping clips at zero, never repulsive
    for _ in range(5):
        a.record_abort(0.0, 0, (1,))
    assert a.rates(0.0)[1, 0] == 0.0


def test_affinity_co_access_and_forget():
    a = AffinityTracker(2, 4, tau_ms=100.0, track_co=True)
    a.record_commit(0.0, 0, (1, 2))
    co = a.co_rates(0.0, 4)
    assert co[1, 2] > 0 and co[2, 1] > 0 and co[1, 1] == 0
    a.forget(1)
    co = a.co_rates(0.0, 4)
    assert co[1, 2] == 0 and co[2, 1] == 0
    assert a.rates(0.0)[1].sum() == 0


def test_shared_decayed_frequency_grows_and_zeroes():
    from repro_torch.core.stats import DecayedFrequency

    f = DecayedFrequency(2, 2, tau_ms=50.0, grow_cols=True)
    f.record(0.0, 1, (9,))                 # auto-grow past col 2
    assert f.n_cols == 16 and f.rates(0.0)[1, 9] > 0
    f.zero_col(9)
    assert f.rates(0.0)[1, 9] == 0.0
    fixed = DecayedFrequency(2, 2)
    with pytest.raises(IndexError):
        fixed.ensure_col(5)


# ---------------------------------------------------------------------------
# Simulator regression: the shifted high-locality workload
# ---------------------------------------------------------------------------

class RotatingBank(BankWorkload):
    """Bank whose node→partition affinity rotates mid-run (phase shift):
    after the shift every node's dominant partition is its neighbour's, so
    the reactive stack forwards its local transactions forever while the
    planner re-circulates the leases to the new dominant accessors."""

    rotation: int = 0

    def _choose_partition(self, node, rng):
        home = (node + self.rotation) % self.n_nodes
        if rng.random() < self.locality:
            return home
        others = [p for p in range(self.n_nodes) if p != home]
        return int(others[rng.integers(len(others))])


def _run_shifted(plan, seed=0):
    cfg = SimConfig(duration_ms=1000.0, warmup_ms=100.0, seed=seed,
                    n_classes=64, plan=plan, device="cpu")
    wl = RotatingBank(n_nodes=cfg.n_nodes, n_items=cfg.n_items, locality=0.9)
    c = make_cluster("LILAC-TM-ST", wl, cfg)
    marks = {}

    def shift():
        wl.rotation = 1
        marks["fw"] = c.metrics.forwards
        marks["commits"] = c.metrics.commits

    c.events.schedule(300.0, shift)
    m = c.run()
    return c, m, m.forwards - marks["fw"], m.commits - marks["commits"]


def test_sim_planner_preserves_safety_and_lowers_forwards():
    """Seeded planner run: STM safety invariants hold (money conserved, no
    commit of a conflicting pair — replicated stores stay byte-identical)
    and the post-shift forward count is strictly below the reactive run."""
    base_c, base_m, base_fw, base_commits = _run_shifted(None)
    plan_c, plan_m, plan_fw, plan_commits = _run_shifted(SIM_PLAN_DEFAULTS)

    for c in (base_c, plan_c):
        expect = c.cfg.n_items * c.cfg.init_value
        for r in c.replicas:
            assert r.store.total() == pytest.approx(expect, abs=1e-6)
        v0 = c.replicas[0].store.values
        ver0 = c.replicas[0].store.versions
        for r in c.replicas[1:]:
            np.testing.assert_array_equal(v0, r.store.values)
            np.testing.assert_array_equal(ver0, r.store.versions)

    assert plan_m.plan_prefetches > 0
    assert plan_fw < base_fw                       # strictly fewer forwards
    assert plan_commits >= base_commits            # and no throughput loss
    # the fix is structural, not marginal: post-shift forward *rate* halves
    assert plan_fw / max(1, plan_commits) < 0.5 * base_fw / max(1, base_commits)


def test_sim_prefetch_behind_active_owner_cannot_wedge_the_class():
    """Review regression: a prefetch whose LOR enqueues *behind* an active
    owner must not be drained to activeXacts=0 while queued — a dormant
    non-head LOR is unfreeable (the blocked-and-drained rule only fires at
    the head) and would wedge the class for every later request.  The
    drain now waits for the LOR to head its queues, so the interleaving
    owner-active → prefetch → third-party request → owner frees resolves
    with the third party owning the class."""
    from repro_torch.core.lease import LeaseRequest

    cfg = SimConfig(n_nodes=3, n_classes=8, device="cpu")
    wl = BankWorkload(n_nodes=3, n_items=cfg.n_items)
    c = make_cluster("FGL", wl, cfg)
    cc = 5

    def deliver(req):
        for node in range(3):
            c._on_opt(node, ("lease", req), req.proc)
        for node in range(3):
            c._on_to(node, ("lease", req), req.proc)

    # node 0 holds cc with an active (undrained) transaction
    deliver(LeaseRequest(req_id=1, proc=0, ccs=(cc,)))
    # planner prefetch for node 1 enqueues second — must NOT drain yet
    deliver(LeaseRequest(req_id=2, proc=1, ccs=(cc,), prefetch=True))
    pre_lor = c.replicas[1].lm.cq[cc][1]
    assert pre_lor.proc == 1 and pre_lor.activeXacts == 1
    # node 2 requests cc: blocks the prefetch LOR while it is still queued
    deliver(LeaseRequest(req_id=3, proc=2, ccs=(cc,)))
    assert pre_lor.blocked
    # owner 0 finishes its transaction and frees its LOR
    lor0 = c.replicas[0].lm.cq[cc][0]
    keys = [l.key() for l in c.replicas[0].lm.finished_xact([lor0])]
    assert keys, "owner's blocked+drained LOR must free"
    for node in range(3):
        c._on_urb(node, ("freed", keys), 0)
    c.events.run(until=100.0)              # flush the prefetch's own free
    # the class is NOT wedged: node 2's request reaches the head everywhere
    for r in c.replicas:
        assert r.lm.head_owner(cc) == 2, r.lm.cq[cc]


def test_sim_prefetch_is_piggybackable_and_freed_on_conflict():
    """A prefetched LOR sits unblocked with activeXacts drained, so local
    transactions piggyback on it; a conflicting remote request frees it by
    the ordinary blocked-and-drained rule (no wedging)."""
    from repro_torch.core.lease import FGLLeaseManager, LeaseRequest

    lms = [FGLLeaseManager(p, 4) for p in range(2)]
    pre = LeaseRequest(req_id=1, proc=0, ccs=(2,), prefetch=True)
    for lm in lms:
        lors = lm.on_to_deliver(pre)
        if lm.proc == 0:
            assert not lm.finished_xact(lors)      # head, unblocked: stays
    got = lms[0].try_piggyback(frozenset({2}))
    assert got is not None and got[0].req_id == 1  # reuse without a request
    assert not lms[0].finished_xact(got)
    # a remote conflicting request blocks it; drained -> freed immediately
    req = LeaseRequest(req_id=2, proc=1, ccs=(2,))
    to_free = lms[0].on_opt_deliver(req)
    assert [l.req_id for l in to_free] == [1]


# ---------------------------------------------------------------------------
# Serving engine integration
# ---------------------------------------------------------------------------

def _serve_engine(plan_cfg, kvb=1000.0, n_pods=2):
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve.engine import MultiPodEngine, SimBackend
    from repro_torch.serve.router import LocalityRouter

    cfg = get_smoke_config("mixtral-8x7b")
    router = LocalityRouter(n_pods, policy="short", arbitration="priced",
                            kv_bytes_per_token=kvb)
    planner = PlacementPlanner(n_pods, 16, plan_cfg, grow=True, device="cpu")
    eng = MultiPodEngine(n_pods, SimBackend(cfg), router, planner=planner,
                         device="cpu")
    return eng, router, planner


def test_engine_planner_rehomes_misplaced_session():
    """A session owned by the wrong pod but touched from its dominant
    origin is re-homed by a planned move (not by a reactive acquire), with
    the lease epoch bumped so stale forwards abort."""
    from repro_torch.serve.engine import Request

    cfg = PlanConfig(epoch_ms=0.5, top_k=4, node_budget_bytes=np.inf,
                     hysteresis_epochs=2, margin=0.5, min_frac=0.5,
                     min_events=3.0, horizon_ms=500.0)
    # heavy KV per token: the byte verdict keeps forwarding (never a
    # reactive acquire), so any re-home must come from the planner
    eng, router, planner = _serve_engine(cfg, kvb=10_000.0)
    eng.submit(Request(sid=5, origin=1, n_tokens=2))   # misplaced at pod 1
    eng.run_step()
    epoch0 = router.lease_epoch[5]
    for _ in range(12):                                # dominant origin: pod 0
        eng.submit(Request(sid=5, origin=0, n_tokens=1))
        eng.run_step()
    assert router.owner[5] == 0                        # planner re-homed it
    assert router.metrics.planned_moves >= 1
    assert eng.metrics.plan_moves + eng.metrics.plan_prefetches >= 1
    assert router.lease_epoch[5] > epoch0              # epoch bumped
    assert router.metrics.acquires == 0                # no reactive acquire
    eng.drain()
    assert not any(eng.queues)


def test_engine_planner_prefetch_counts_zero_byte_moves():
    """A cacheless session (length 0) moves as a pure lease prefetch: no
    wire bytes, counted separately from KV re-homes."""
    cfg = PlanConfig(epoch_ms=0.5, top_k=4, node_budget_bytes=np.inf,
                     hysteresis_epochs=2, margin=0.0, min_frac=0.5,
                     min_events=2.0, horizon_ms=500.0)
    eng, router, planner = _serve_engine(cfg)
    # a session known to the ledger but with no cache yet, whose touch
    # affinity (fed out-of-band, e.g. piggybacked metrics) points at pod 0
    router.owner[7] = 1
    router.lease_epoch[7] = 1
    eng.session_home[7] = 1
    for t in range(6):
        planner.affinity.record_touch(float(t), 0, (7,))
    wire0 = eng.metrics.wire_bytes
    for _ in range(4):
        eng.run_step()                     # idle steps advance the clock
    assert router.owner[7] == 0
    assert eng.metrics.plan_prefetches >= 1
    assert eng.metrics.plan_moves == 0
    assert eng.metrics.plan_bytes == 0.0
    assert eng.metrics.wire_bytes == wire0             # nothing on the wire


def test_router_planned_mode_keeps_byte_verdict_under_overload():
    """With a planner attached the router never panic-acquires: the byte
    verdict stands even when the owner violates constraint (3)."""
    from repro_torch.serve.router import LocalityRouter

    r = LocalityRouter(4, policy="short", arbitration="priced",
                       kv_bytes_per_token=1e6)
    r.planned = True
    r.route(0, 9, 0)                       # pod 0 owns sid 9
    r.observe_cpu(np.array([1.0, 0.0, 0.0, 0.0]))
    d = r.route(2, 9, 50)                  # heavy KV, owner overloaded
    assert d.action == "forward" and d.target == 0
    # un-planned router flips to acquire on the same inputs
    r2 = LocalityRouter(4, policy="short", arbitration="priced",
                        kv_bytes_per_token=1e6)
    r2.route(0, 9, 0)
    r2.observe_cpu(np.array([1.0, 0.0, 0.0, 0.0]))
    assert r2.route(2, 9, 50).action == "acquire"
