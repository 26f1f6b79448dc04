"""repro_torch.analysis.sanitizer on the CPU: pass cases, byte-identity,
and the port held to repro.analysis.

The reference's ``tests/test_sanitizer.py`` case for case against the
port's managers, cluster and certifier (``device="cpu"``); the seeded
sanitized simulations are also byte-identical to the reference's sanitized
runs with equal ``counters()``.  Then the port's own forms: the pinned
copies, ``check_write_locks`` with the drain's ``ClassLocks``, the
fingerprint's tensor canonicalisation, and the analysis package importing
nothing of ``repro`` or JAX at any depth.
"""
import ast
import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis.sanitizer as JS
import repro.core as J
import repro_torch.core as T
from repro_torch.analysis import fingerprint
from repro_torch.analysis.sanitizer import (LeaseSanitizer, SanitizerError,
                                            check_write_locks)
from repro_torch.core.lease import FGLLeaseManager, LeaseRequest
from repro_torch.core.lease_batched import ShardedLeaseManager
from repro_torch.core.stm import ClassLocks
from repro_torch.serve.certifier import StepCertifier

REPO = Path(__file__).resolve().parents[1]


def _req(req_id, proc, ccs):
    return LeaseRequest(req_id=req_id, proc=proc, ccs=tuple(sorted(ccs)))


def _keys(lors):
    return [l.key() for l in lors]


def _sharded(p, n_classes, **kw):
    return ShardedLeaseManager(p, n_classes, device="cpu", **kw)


def _wrapped_sets(n_procs, n_classes, **kw):
    """(oracle replicas, batched replicas), every manager sanitized."""
    return ([LeaseSanitizer(FGLLeaseManager(p, n_classes))
             for p in range(n_procs)],
            [LeaseSanitizer(_sharded(p, n_classes, **kw))
             for p in range(n_procs)])


# ---------------------------------------------------------------------------
# Clean histories pass — and the proxy is transparent
# ---------------------------------------------------------------------------

def test_scripted_history_clean_on_both_managers():
    (a,), (b,) = _wrapped_sets(1, 8, n_shards=2)
    for lm in (a, b):
        lors = lm.on_to_deliver(_req(1, 0, (1, 2)))
        assert [l.cc for l in lors] == [1, 2]       # proxy returns verbatim
        assert lm.is_enabled(lors)                  # unknown attr forwards
        assert lm.on_opt_deliver(_req(2, 1, (2,))) == []
        freed = lm.finished_xact(lors)
        assert _keys(freed) == [(1, 0, (2,))]
        lm.on_ur_deliver_freed(_keys(freed))
        lm.on_to_deliver(_req(2, 1, (2,)))
        assert lm.try_piggyback(frozenset({1})) is not None
        lm.verify_full()
        c = lm.counters()
        assert c["created"] == 3 and c["freed"] == 1 and c["live"] == 2
    assert a.owner_view() == b.owner_view()


def _drive_replicated(mgr_sets, reqs_rounds, purge_at=None):
    """Protocol-ordered replay (opt -> freed -> TO -> finish -> freed)
    through replicated manager sets; returns each set's observable trace."""
    traces = []
    for mgrs in mgr_sets:
        waiters = [[] for _ in mgrs]
        trace = {"freed": [], "finished": 0}

        def deliver(frees_by_node, mgrs=mgrs, trace=trace):
            keys = [k for fr in frees_by_node for k in _keys(fr)]
            trace["freed"].extend(keys)
            for m in mgrs:
                m.on_ur_deliver_freed(keys)

        for rnd, reqs in enumerate(reqs_rounds):
            if purge_at == rnd:
                for m in mgrs:
                    m.purge_proc(1)
                waiters[1] = []
            deliver([sum((m.on_opt_deliver(r) for r in reqs), [])
                     for m in mgrs])
            for p, m in enumerate(mgrs):
                for r in reqs:
                    lors = m.on_to_deliver(r)
                    if r.proc == p and lors:
                        waiters[p].append(lors)
            fin = []
            for p, m in enumerate(mgrs):
                done = [g for g in waiters[p] if m.is_enabled(g)]
                waiters[p] = [g for g in waiters[p] if not m.is_enabled(g)]
                trace["finished"] += len(done)
                fin.append(sum((m.finished_xact(g) for g in done), []))
            deliver(fin)
        trace["owners"] = [m.owner_view() for m in mgrs]
        traces.append(trace)
    return traces


def _rounds(rng, n_rounds=6, per_round=12, n_procs=3, n_classes=10):
    rounds, rid = [], 0
    for _ in range(n_rounds):
        reqs = []
        for _ in range(per_round):
            rid += 1
            ccs = rng.choice(n_classes, size=int(rng.integers(1, 3)),
                             replace=False)
            reqs.append(_req(rid, rid % n_procs, tuple(int(c) for c in ccs)))
        rounds.append(reqs)
    return rounds


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_random_histories_clean_and_trace_identical(seed):
    """Random replicated histories (with a mid-run view change) raise no
    violation on either sanitized manager, leave full reconciliation clean,
    and produce byte-identical traces to the unsanitized managers — and
    the port's sanitizers count what the reference's count."""
    rng = np.random.default_rng(seed)
    rounds = _rounds(rng)
    plain = ([FGLLeaseManager(p, 10) for p in range(3)],
             [_sharded(p, 10, n_shards=2, jax_min=1) for p in range(3)])
    wrapped = _wrapped_sets(3, 10, n_shards=2, jax_min=1)
    t_plain = _drive_replicated(plain, rounds, purge_at=3)
    t_wrapped = _drive_replicated(wrapped, rounds, purge_at=3)
    assert t_wrapped == t_plain                     # pure observer
    assert t_wrapped[0] == t_wrapped[1]             # managers in lockstep
    for mgrs in wrapped:
        for m in mgrs:
            m.verify_full()
            assert m.counters()["checks"] > 0       # it actually looked
    ref = ([JS.LeaseSanitizer(J.FGLLeaseManager(p, 10)) for p in range(3)],)
    _drive_replicated(ref, rounds, purge_at=3)
    assert [m.counters() for m in ref[0]] == \
        [m.counters() for m in wrapped[0]]


def test_hypothesis_histories_clean():
    """Property-based version of the above: arbitrary consistently-ordered
    histories keep both sanitized managers violation-free and in lockstep."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(st.integers(0, 2 ** 31 - 1), st.integers(2, 4),
           st.booleans())
    def run(seed, n_procs, view_change):
        rng = np.random.default_rng(seed)
        rounds = _rounds(rng, n_rounds=4, per_round=8, n_procs=n_procs,
                         n_classes=6)
        oracle = [LeaseSanitizer(FGLLeaseManager(p, 6))
                  for p in range(n_procs)]
        batched = [LeaseSanitizer(_sharded(p, 6, n_shards=2, jax_min=1))
                   for p in range(n_procs)]
        ta, tb = _drive_replicated(
            [oracle, batched], rounds, purge_at=2 if view_change else None)
        assert ta == tb
        for m in oracle + batched:
            m.verify_full()

    run()


# ---------------------------------------------------------------------------
# Full-simulation byte-identity: sanitize on == sanitize off == reference
# ---------------------------------------------------------------------------

def _cfg(pkg, sanitize, **kw):
    if pkg is T:
        kw["device"] = "cpu"
    return pkg.SimConfig(sanitize=sanitize, **kw)


def _state(c):
    return [(r.store.values.tobytes(), r.store.versions.tobytes())
            for r in c.replicas]


@pytest.mark.parametrize("lease_mode", ["sequential", "batched"])
def test_sim_sanitize_on_is_byte_identical(lease_mode):
    def run(pkg, sanitize):
        cfg = _cfg(pkg, sanitize, duration_ms=300.0, warmup_ms=50.0, seed=3,
                   lease_mode=lease_mode)
        wl = pkg.BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items,
                              locality=0.7)
        c = pkg.make_cluster("LILAC-TM-ST", wl, cfg)
        m = c.run()
        return c, m

    c_off, m_off = run(T, False)
    c_on, m_on = run(T, True)
    assert m_on.commits == m_off.commits
    assert m_on.commit_times == m_off.commit_times
    assert m_on.aborts == m_off.aborts
    for r_on, r_off in zip(c_on.replicas, c_off.replicas):
        np.testing.assert_array_equal(r_on.store.values, r_off.store.values)
        np.testing.assert_array_equal(r_on.store.versions,
                                      r_off.store.versions)
        assert r_on.lm.owner_view() == r_off.lm.owner_view()
    # the sanitized run actually checked something
    assert sum(r.lm.counters()["checks"] for r in c_on.replicas) > 0
    # and it is the reference's sanitized run, check for check
    c_ref, m_ref = run(J, True)
    assert dataclasses.asdict(m_on) == dataclasses.asdict(m_ref)
    assert _state(c_on) == _state(c_ref)
    assert [r.lm.counters() for r in c_on.replicas] == \
        [r.lm.counters() for r in c_ref.replicas]


def test_sim_sanitize_with_planner_and_failure():
    """Planner prefetches (prefetch-head rule) and a node failure
    (purge_proc conservation) both run clean under the sanitizer, as in
    the reference, counter for counter."""
    import repro.plan as JP
    import repro_torch.plan as TP

    out = []
    for pkg, plan_mod in ((T, TP), (J, JP)):
        plan = plan_mod.PlanConfig(epoch_ms=50.0, top_k=4, margin=0.0,
                                   min_frac=0.0, min_events=2.0,
                                   hysteresis_epochs=2)
        cfg = _cfg(pkg, True, duration_ms=500.0, warmup_ms=50.0, seed=5,
                   n_classes=32, plan=plan)
        wl = pkg.BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items,
                              locality=0.6)
        c = pkg.make_cluster("LILAC-TM-ST", wl, cfg)
        c.events.schedule(250.0, lambda c=c: c.gcs.fail(c.cfg.n_nodes - 1))
        m = c.run()
        assert m.commits > 0
        out.append((dataclasses.asdict(m), _state(c),
                    [r.lm.counters() for r in c.replicas]))
    assert out[0] == out[1]
    assert out[0][2][-1]["purged"] > 0 or out[0][2][0]["purged"] > 0


def test_sim_sanitized_alc_equals_reference():
    """The proxy around the ALC lease manager (MG-ALC): the sanitized run
    equals the reference's, counters included."""
    out = []
    for pkg in (T, J):
        cfg = _cfg(pkg, True, duration_ms=150.0, warmup_ms=20.0, seed=4)
        c = pkg.make_cluster("MG-ALC", pkg.BankWorkload(
            n_nodes=cfg.n_nodes, n_items=cfg.n_items, locality=0.6), cfg)
        m = c.run()
        out.append((dataclasses.asdict(m), _state(c),
                    [r.lm.counters() for r in c.replicas]))
    assert type(c.replicas[0].lm.inner).__name__ == "ALCLeaseManager"
    assert out[0] == out[1] and out[0][0]["commits"] > 0


@pytest.mark.parametrize("certify_jax_min", [1, 1 << 30])
def test_sim_sanitized_checks_every_drain_route(monkeypatch, certify_jax_min):
    """The drain route (``certify_jax_min=1``: every batch through
    ``validate_batch(class_locks=)``, the twin on the CPU) and the numpy
    route both hand ``check_write_locks`` the ``ClassLocks`` that decided,
    and the sanitized TPC-C run equals the reference's, counters included."""
    import repro_torch.analysis.sanitizer as TS

    seen = {"calls": 0, "slots": 0, "views": 0}
    plain = TS.check_write_locks

    def counting(node, owners, item_cc, locks, txns, verdicts):
        seen["calls"] += 1
        seen["views"] += isinstance(locks, ClassLocks)
        n = plain(node, owners, item_cc, locks, txns, verdicts)
        seen["slots"] += n
        return n

    monkeypatch.setattr(TS, "check_write_locks", counting)
    out = []
    for pkg in (T, J):
        lay = pkg.TpccLayout(n_nodes=4)
        ccmap = pkg.TpccConflictMap(lay)
        cfg = _cfg(pkg, True, n_items=lay.n_items, n_classes=ccmap.n_classes,
                   duration_ms=60.0, warmup_ms=10.0, seed=2,
                   lease_mode="batched", certify_jax_min=certify_jax_min)
        c = pkg.make_cluster("LILAC-TM-ST", pkg.TpccWorkload(lay), cfg,
                             ccmap=ccmap)
        m = c.run()
        out.append((dataclasses.asdict(m), _state(c),
                    [r.lm.counters() for r in c.replicas]))
    assert out[0] == out[1]
    assert seen["calls"] == seen["views"] == out[0][0]["cert_batches"] > 0
    assert seen["slots"] > 0


# ---------------------------------------------------------------------------
# Certifier sanitize mode and the write-lock checker (pass cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_min", [8, 1])
def test_certifier_sanitize_clean_run(jax_min):
    owner = {}
    c = StepCertifier(2, sanitize=True, owner_of=lambda s: owner.get(s, -1),
                      jax_min=jax_min, device="cpu")

    class R:
        def __init__(self, sid):
            self.sid = sid

    owner[4] = 0
    c.bump(4, 1)
    c.enqueue(0, R(4), 1)
    passed, aborted, _ = c.drain(0)
    assert len(passed) == 1 and not aborted
    # ownership moves with a fresh bump: the stale forward aborts cleanly
    c.enqueue(0, R(4), 1)
    owner[4] = 1
    c.bump(4, 2)
    passed, aborted, _ = c.drain(0)
    assert not passed and len(aborted) == 1


class _T:
    def __init__(self, txid, writes):
        self.txid = txid
        self.write_set = {w: 1.0 for w in writes}


def test_check_write_locks_clean():
    owners = np.array([0, 1, -1], np.int32)
    item_cc = np.array([0, 0, 1, 2], np.int32)
    locks = np.array([0, 0, 1, 0], np.int32)   # cc=1 leased to proc 1

    n = check_write_locks(0, owners, item_cc, locks,
                          [_T(1, [0, 3]), _T(2, [2])], [True, False])
    assert n == 2
    assert check_write_locks(0, owners, None, None, [], []) == 0


def test_check_write_locks_takes_the_drains_class_view():
    """The drain's input form: a clean view passes and counts the same
    slots as the per-item form; owners are compared to the lease layer's,
    and the pass side is recomputed on the host from ``item_cc``."""
    owners = np.array([0, 1, -1], np.int32)
    item_cc = np.array([0, 0, 1, 2], np.int32)
    view = ClassLocks(torch.from_numpy(item_cc), owners.copy(), 0)
    txns = [_T(1, [0, 3]), _T(2, [2])]
    assert check_write_locks(0, owners, item_cc, view, txns,
                             [True, False]) == 2
    with pytest.raises(SanitizerError) as e:
        check_write_locks(0, owners, item_cc, view, txns, [True, True])
    assert e.value.invariant == "write-locks" and "txn 2" in e.value.detail
    with pytest.raises(SanitizerError) as e:
        check_write_locks(0, owners, item_cc, view._replace(node=1), [], [])
    assert e.value.invariant == "write-locks" and "node 1" in e.value.detail
    stale = view._replace(owners=np.array([0, 0, -1], np.int32))
    with pytest.raises(SanitizerError) as e:
        check_write_locks(0, owners, item_cc, stale, [], [])
    assert e.value.invariant == "write-locks" and "class 1" in e.value.detail
    short = view._replace(owners=owners[:2].copy())
    with pytest.raises(SanitizerError, match="2 class owners"):
        check_write_locks(0, owners, item_cc, short, [], [])


def test_sanitizer_error_carries_invariant():
    err = SanitizerError("single-owner", "details here")
    assert isinstance(err, AssertionError)
    assert err.invariant == "single-owner"
    assert "single-owner" in str(err)


# ---------------------------------------------------------------------------
# Pinned copies, the fingerprint, and no reference import at any depth
# ---------------------------------------------------------------------------

def _code(path):
    """A module's source after its docstring."""
    tree = ast.parse(path.read_text())
    first = tree.body[0]
    assert isinstance(first, ast.Expr) and isinstance(first.value,
                                                      ast.Constant)
    return "\n".join(path.read_text().splitlines()[first.end_lineno:])


def test_analysis_init_and_trace_are_pinned_copies():
    ref, port = REPO / "src/repro/analysis", REPO / "src/repro_torch/analysis"
    assert _code(port / "__init__.py") == _code(ref / "__init__.py")
    want = (ref / "trace.py").read_text().replace(
        "``repro-explore replay", "``repro-torch-explore replay")
    assert (port / "trace.py").read_text() == want


@pytest.mark.parametrize("name", ["SanitizerError", "LeaseSanitizer"])
def test_sanitizer_classes_are_pinned_copies(name):
    """The same code (docstrings included; comments may differ)."""
    import repro_torch.analysis.sanitizer as TS

    def code(mod):
        return ast.dump(ast.parse(inspect.getsource(getattr(mod, name))))

    assert code(TS) == code(JS)


def test_fingerprint_blob_identifies_objects_not_addresses():
    """A default-repr object (the planner's AffinityTracker) is identified
    by a serial, stable while it lives: a later object at a freed one's
    address hashes differently, and one object hashes the same twice."""
    class Opaque:
        pass

    seen = set()
    for _ in range(50):
        o = Opaque()
        key = fingerprint.digest(fingerprint._blob({"tracker": o}))
        assert key == fingerprint.digest(fingerprint._blob({"tracker": o}))
        assert key not in seen and "0x" not in repr(fingerprint._blob(o))
        seen.add(key)
        del o                        # its address is free for the next one


def test_fingerprint_blob_sees_a_tensors_middle():
    """repr elides a large tensor's middle: the port hashes its bytes."""
    a = torch.arange(2000, dtype=torch.int32)
    b = a.clone()
    b[1000] = -7
    assert repr(a) == repr(b)
    assert fingerprint.digest(fingerprint._blob(a)) != \
        fingerprint.digest(fingerprint._blob(b))
    assert fingerprint.digest(fingerprint._blob({"t": a})) != \
        fingerprint.digest(fingerprint._blob({"t": b}))
    assert fingerprint._blob(a.to(torch.bfloat16))[0] == "tensor"
    assert fingerprint._blob(torch.device("cpu")) == ("device", "cpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [*(REPO / "src/repro_torch/analysis").glob("*.py"),
     *(REPO / "tools").glob("*.py"), REPO / "chip_smoke.py"]),
    ids=lambda p: p.name)
def test_no_reference_or_jax_import_at_any_depth(path):
    """Function bodies included: a ``from repro...`` left inside a function
    would quietly run the reference."""
    bad = [m for m in _imports(ast.parse(path.read_text()))
           if m.split(".")[0] in ("repro", "jax", "jaxlib")]
    assert not bad, f"{path.name} imports {bad}"


PORT = REPO / "src/repro_torch"


@pytest.mark.parametrize("path", sorted(
    p for p in PORT.rglob("*.py") if p.parent.name != "analysis"),
    ids=lambda p: str(p.relative_to(PORT)))
def test_port_module_imports_no_reference_at_any_depth(path):
    """The rest of the port the same way, the model stack (``models/moe``,
    MLA in ``models/attention``), ``serve/kvcache``, ``RealBackend`` and
    ``obs/cli`` among it."""
    bad = [m for m in _imports(ast.parse(path.read_text()))
           if m.split(".")[0] in ("repro", "jax", "jaxlib")]
    assert not bad, f"{path.relative_to(PORT)} imports {bad}"


def test_explorer_smoke_grid_loads_nothing_of_the_reference():
    """The explorer's CPU smoke grid, run in a fresh interpreter, leaves no
    repro, jax or jaxlib module behind."""
    code = f"""
import sys
sys.path.insert(0, {str(REPO / 'src')!r})
from repro_torch.analysis import explore
rc = explore.main(["--smoke", "--device", "cpu", "--max-schedules", "40"])
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
assert not bad, bad
assert 'repro_torch.core.cluster' in sys.modules
print('rc', rc)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "rc 0" in out.stdout
