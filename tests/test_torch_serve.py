"""repro_torch.serve held to repro.serve on the CPU.

``benchmarks/serve_locality.py::run_point`` (imported by path, as
``benchmarks/planner.py`` imports it) against the port's
``repro_torch.launch.serve.run_point`` (the one the card runs): every GRID pair
x {0.0, 0.5, 0.9} at the ``--smoke`` sizes, one cell at the full 8 pods /
256 sessions / 80 steps and two with the planner on, key for key with
``EngineMetrics.as_dict()`` (``plan_block_s``, wall time, only checked
present) and the router's metrics.  ``launch.serve.main`` against the
reference's entry point; every config field and ``active_param_count`` of the
ten architectures.  Then the reference's serving tests
(``tests/test_serve.py``' router and ``SimBackend`` engine tests, the
serving certifier tests of ``tests/test_certify.py``, the eviction tests
of ``tests/test_lease_batched.py`` and the engine tests of
``tests/test_obs.py``) run against the port, on the CPU.
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.serve.engine as JE
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.dist.locality import (price_moe_dispatch,
                                       price_session_dispatch)
from repro_torch.launch.serve import run_point
from repro_torch.serve.certifier import StepCertifier
from repro_torch.serve.engine import (MultiPodEngine, RealBackend, Request,
                                      SimBackend)
from repro_torch.serve.router import LocalityRouter

REPO = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


sys.path.insert(0, str(REPO / "benchmarks"))
serve_locality = _load("serve_locality", REPO / "benchmarks/serve_locality.py")
SMOKE = dict(n_pods=2, n_sessions=8, steps=10)       # serve_locality --smoke


def _reference_point(monkeypatch, *args, plan_async=True, **kw):
    """``run_point`` of the reference, its engine captured for the
    key-for-key comparison (and built with ``plan_async``)."""
    engines = []

    class Capture(JE.MultiPodEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, plan_async=plan_async, **k)
            engines.append(self)

    monkeypatch.setattr(serve_locality, "MultiPodEngine", Capture)
    point = serve_locality.run_point(*args, **kw)
    eng, = engines
    m = eng.metrics.as_dict()
    block = m.pop("plan_block_s")
    return dict(point=point, metrics=m,
                router=dataclasses.asdict(eng.router.metrics),
                plan_block_s=block)


def _assert_same(port, ref):
    assert port["point"] == ref["point"]
    assert port["metrics"] == ref["metrics"]
    assert port["router"] == ref["router"]
    assert port["plan_block_s"] >= 0.0 and ref["plan_block_s"] >= 0.0


@pytest.mark.parametrize("locality", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("policy,arbitration", serve_locality.GRID)
def test_run_point_equals_reference(monkeypatch, policy, arbitration,
                                    locality):
    ref = _reference_point(monkeypatch, "mixtral-8x7b", policy, locality,
                           arbitration=arbitration, **SMOKE)
    port = run_point("mixtral-8x7b", policy, locality,
                     arbitration=arbitration, device="cpu", **SMOKE)
    _assert_same(port, ref)
    assert ref["metrics"]["tokens"] > 0


def test_run_point_full_size_equals_reference(monkeypatch):
    """serve_locality's defaults (8 pods, 256 sessions, 80 steps); every
    certification batch through the drain route changes nothing."""
    ref = _reference_point(monkeypatch, "mixtral-8x7b", "short", 0.5,
                           arbitration="priced", seed=1)
    for jax_min in (8, 1):
        port = run_point("mixtral-8x7b", "short", 0.5, arbitration="priced",
                         seed=1, device="cpu", jax_min=jax_min)
        _assert_same(port, ref)
    assert ref["metrics"]["cert_batches"] > 0
    assert ref["metrics"]["forwards"] > 0


@pytest.mark.parametrize("locality,sizes", [
    (0.9, dict(n_pods=8, n_sessions=96, steps=160)),    # planner.py's sweep
    (0.7, dict(n_pods=2, n_sessions=8, steps=20)),      # planner.py --smoke
])
def test_run_point_with_planner_equals_reference(monkeypatch, locality,
                                                 sizes):
    """Asynchronous epochs (run_point's engine) and synchronous ones, each
    against the reference's engine in the same mode.  The two modes
    differ from each other in the reference too: an async epoch's moves
    land at the next step's start, one step after a sync epoch's."""
    for plan_async in (True, False):
        ref = _reference_point(monkeypatch, "mixtral-8x7b", "short",
                               locality, arbitration="priced",
                               plan_epoch_ms=5.0, plan_async=plan_async,
                               **sizes)
        port = run_point(
            "mixtral-8x7b", "short", locality, arbitration="priced",
            plan_epoch_ms=5.0, device="cpu", plan_async=plan_async, **sizes)
        _assert_same(port, ref)
        assert ref["metrics"]["plan_epochs"] > 0
        if sizes["n_pods"] == 8:
            assert ref["point"]["plan_moves"] > 0


def _drop_block(m):
    m = dict(m)
    assert m.pop("plan_block_s") >= 0.0
    return m


@pytest.mark.parametrize("argv", [
    ["--arch", "mixtral-8x7b", "--preset", "full"],
    ["--arch", "glm4-9b", "--pods", "4", "--locality", "0.3",
     "--seq-axis", "4", "--policy", "long", "--arbitration", "hybrid"],
    ["--arch", "deepseek-v2-236b", "--preset", "full", "--pods", "8",
     "--requests", "512"],
    ["--arch", "mixtral-8x7b", "--preset", "full", "--pods", "8",
     "--sessions", "96", "--requests", "1500", "--plan-epoch-ms", "5"],
])
def test_serve_main_equals_reference(argv, capsys):
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main as tmain

    want = jmain(argv + ["--backend", "sim"])
    got = tmain(argv + ["--device", "cpu"])
    assert _drop_block(got) == _drop_block(want)
    assert got["tokens"] > 0
    out = capsys.readouterr().out
    assert "a priced TPU pod, not this device" in out


def test_serve_trace_equals_reference(tmp_path):
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main as tmain

    argv = ["--arch", "mixtral-8x7b", "--preset", "full", "--pods", "4",
            "--requests", "256", "--plan-epoch-ms", "2"]
    jmain(argv + ["--backend", "sim", "--trace", str(tmp_path / "j.json")])
    tmain(argv + ["--device", "cpu", "--trace", str(tmp_path / "t.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == want
    names = {e["name"] for e in got["traceEvents"] if e["ph"] != "M"}
    assert {"certify", "decode", "plan-epoch"} <= names


def test_unported_serving_paths_raise():
    with pytest.raises(NotImplementedError, match="item 8"):
        RealBackend(None, None, None, 2, 4, 32)
    from repro_torch.launch.serve import main as tmain

    with pytest.raises(NotImplementedError, match="item 8"):
        tmain(["--backend", "real", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 7"):
        StepCertifier(2, sanitize=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        MultiPodEngine(2, SimBackend(get_smoke_config("glm4-9b")),
                       LocalityRouter(2), sanitize=True, device="cpu")
    with pytest.raises(ValueError, match="auto"):
        StepCertifier(2, backend="jax", device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    """Every field of the ten registered configs (published and smoke)
    equals the reference's, and so do the parameter counts SimBackend
    prices with."""
    for tget, jget in ((get_config, jget_config),
                       (get_smoke_config, jget_smoke)):
        tcfg, jcfg = tget(arch), jget(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
        assert SimBackend(tcfg).weight_bytes == \
            JE.SimBackend(jcfg).weight_bytes
    if jget_config(arch).moe is not None:
        cfg = get_config(arch)
        assert cfg.active_param_count() < cfg.param_count()


def test_certifier_store_growth_matches_numpy_loop(monkeypatch):
    """The epoch store grows (64 -> 2048 sessions) while stamps are
    pending: every packed drain (``jax_min=1``) gives the numpy loop's
    verdicts, and the device table ends equal to the host epochs."""
    import repro_torch.serve.certifier as certifier_mod

    rng = np.random.default_rng(4)
    packed = StepCertifier(2, jax_min=1, device="cpu")
    loop = StepCertifier(2, jax_min=10**9, device="cpu")
    sizes, drains = [], []
    plain = certifier_mod.validate_batch

    def counting(store, txns, *args, **kw):
        drains.append(len(txns))
        return plain(store, txns, *args, **kw)

    monkeypatch.setattr(certifier_mod, "validate_batch", counting)
    for step in range(40):
        hi = 64 << min(5, step // 6)
        for _ in range(int(rng.integers(1, 12))):
            sid = int(rng.integers(0, hi))
            e = int(rng.integers(1, 6))
            for c in (packed, loop):
                c.bump(sid, e)
        for _ in range(int(rng.integers(0, 7))):
            sid = int(rng.integers(0, hi))
            e = int(rng.integers(0, 6))
            for c in (packed, loop):
                c.enqueue(step % 2, Request(sid=sid, origin=0), e)
        got, want = packed.drain(step % 2), loop.drain(step % 2)
        assert [r.sid for r in got[0]] == [r.sid for r in want[0]]
        assert [r.sid for r in got[1]] == [r.sid for r in want[1]]
        if packed.store.staging is not None:
            sizes.append(packed.store.staging.counts)
    assert packed.store.n_items == 2048
    assert len(drains) == packed.metrics.batches > 0
    assert max(n for n, _ in sizes) > 0
    np.testing.assert_array_equal(packed.store.device_versions().numpy(),
                                  packed.store.versions.astype(np.int32))
    np.testing.assert_array_equal(packed.store.versions, loop.store.versions)


# -- tests/test_serve.py: router and SimBackend engine, on the port --------

def test_router_lease_stickiness_and_reuse():
    r = LocalityRouter(4, policy="short")
    d1 = r.route(origin=1, sid=7, session_len=10)
    assert d1.action == "local" and d1.target == 1
    # repeated requests from the owner are local (lease reuse)
    for _ in range(5):
        assert r.route(1, 7, 10).action == "local"
    assert r.metrics.lease_reuse_rate > 0.8


def test_router_forwards_to_owner():
    r = LocalityRouter(4, policy="short")
    r.route(0, 9, 0)                      # pod 0 becomes owner
    d = r.route(2, 9, 50)                 # long session: work migrates
    assert d.action == "forward" and d.target == 0


def test_router_overload_redirects():
    r = LocalityRouter(4, policy="short")
    r.route(0, 9, 0)
    r.observe_cpu(np.array([1.0, 0.0, 0.0, 0.0]))   # owner overloaded
    d = r.route(2, 9, 4)
    assert d.target != 0                  # constraint (3) excluded the owner


def test_engine_locality_improves_throughput():
    big = get_config("mixtral-8x7b")
    out = {}
    for P in (0.1, 0.9):
        router = LocalityRouter(4, policy="short",
                                kv_bytes_per_token=2048.0 * 32)
        eng = MultiPodEngine(4, SimBackend(big), router, device="cpu")
        rng = np.random.default_rng(0)
        for _ in range(40):
            for _ in range(8):
                sid = int(rng.integers(64))
                origin = sid % 4 if rng.random() < P else int(rng.integers(4))
                eng.submit(Request(sid=sid, origin=origin, n_tokens=4))
            eng.run_step()
        eng.drain()
        out[P] = eng.metrics.as_dict()["tokens_per_s"]
    assert out[0.9] > 1.1 * out[0.1]


def test_price_session_dispatch_prefers_forward_for_long_sessions():
    short = price_session_dispatch(4096, 1024, kv_state_bytes=2_000)
    long_ = price_session_dispatch(4096, 1024, kv_state_bytes=50_000_000)
    assert long_.prefer_migration          # ship the request, not 50MB of KV
    assert long_.migrate_state_s > long_.migrate_work_s
    assert not short.prefer_migration


def test_price_moe_dispatch_prefers_token_a2a_at_scale():
    c = price_moe_dispatch(tokens_per_device=4096, d_model=4096, top_k=2,
                           n_experts=8, d_expert=14336, ep_degree=8)
    assert c.prefer_dispatch               # a2a of tokens beats expert a-g


def _crossover_len(r: LocalityRouter, handoff: float = 512.0) -> int:
    """session_len where forwarded work bytes == migrated state bytes."""
    work = r.request_bytes + r.response_bytes
    return int((work - handoff) / r.kv_bytes_per_token)


def test_router_priced_flips_at_byte_crossover():
    """The priced verdict alone picks the action: acquire below the byte
    crossover (KV lighter than the work description), forward above it."""
    for delta, want in ((0, "acquire"), (1, "forward")):
        r = LocalityRouter(4, policy="short", arbitration="priced",
                           kv_bytes_per_token=1.0)
        r.route(0, 5, 0)                   # pod 0 owns session 5
        d = r.route(2, 5, _crossover_len(r) + delta)
        assert d.action == want, (delta, d)
        assert d.target == (0 if want == "forward" else 2)
    # steps arbitration ignores the byte model: same inputs, always forward
    for delta in (0, 1):
        r = LocalityRouter(4, policy="short", arbitration="steps",
                           kv_bytes_per_token=1.0)
        r.route(0, 5, 0)
        assert r.route(2, 5, _crossover_len(r) + delta).action == "forward"


def test_router_hybrid_byte_model_breaks_disagreement():
    r = LocalityRouter(4, policy="short", arbitration="hybrid",
                       kv_bytes_per_token=1.0)
    r.route(0, 5, 0)
    d = r.route(2, 5, 1)                   # 1-byte KV state
    assert d.action == "acquire" and d.target == 2
    assert r.metrics.flips == 1


def test_route_decision_wire_s_set_on_every_branch():
    from repro_torch.dist.locality import DCN_RTT_S

    r = LocalityRouter(4, policy="short", arbitration="priced",
                       kv_bytes_per_token=1.0)
    assert r.route(0, 5, 0).wire_s == 0.0              # local
    fwd = r.route(2, 5, 10**6)                         # forward to owner
    assert fwd.action == "forward" and fwd.wire_s > DCN_RTT_S
    acq = r.route(2, 6, 0)                             # new session, local
    assert acq.wire_s == 0.0
    acq = r.route(1, 5, 10)                            # tiny KV: acquire
    assert acq.action == "acquire" and acq.wire_s > DCN_RTT_S
    assert fwd.wire_s != acq.wire_s


def test_engine_session_len_advances_once_per_sid_per_step():
    big = get_smoke_config("mixtral-8x7b")
    eng = MultiPodEngine(
        2, SimBackend(big), LocalityRouter(2, policy="short"), device="cpu")
    eng.submit(Request(sid=3, origin=0, n_tokens=2))
    eng.submit(Request(sid=3, origin=0, n_tokens=2))
    eng.run_step()
    assert eng.session_len[3] == 1
    assert eng.backend.lengths[(0, 3)] == 1
    eng.drain()
    assert eng.session_len[3] == eng.backend.lengths[(0, 3)] == 2


def test_engine_charges_priced_wire_time():
    from repro_torch.dist.locality import DCN_RTT_S

    big = get_smoke_config("mixtral-8x7b")
    eng = MultiPodEngine(
        2, SimBackend(big),
        LocalityRouter(2, policy="short", kv_bytes_per_token=10_000.0),
        device="cpu")
    eng.submit(Request(sid=0, origin=0, n_tokens=1))   # pod 0 owns sid 0
    eng.run_step()
    base = eng.metrics.sim_time_s
    dec = eng.submit(Request(sid=0, origin=1, n_tokens=1))
    assert dec.action == "forward" and dec.wire_s >= DCN_RTT_S
    eng.run_step()
    assert eng.metrics.sim_time_s - base >= DCN_RTT_S


def test_engine_acquire_rehomes_queued_requests():
    big = get_smoke_config("mixtral-8x7b")
    eng = MultiPodEngine(
        2, SimBackend(big),
        LocalityRouter(2, policy="short", kv_bytes_per_token=1.0),
        device="cpu")
    eng.submit(Request(sid=4, origin=0, n_tokens=3))   # pod 0 owns, queues it
    dec = eng.submit(Request(sid=4, origin=1, n_tokens=3))
    assert dec.action == "acquire" and dec.target == 1  # tiny KV: state moves
    assert [r.sid for r in eng.queues[0]] == []
    assert [r.sid for r in eng.queues[1]] == [4, 4]
    eng.drain()                                        # both requests finish
    assert eng.metrics.tokens > 0 and not any(eng.queues)


def test_router_seq_shards_flips_near_crossover():
    for shards, want in ((1, "forward"), (8, "acquire")):
        r = LocalityRouter(4, policy="short", arbitration="priced",
                           kv_bytes_per_token=1.0, seq_shards=shards)
        r.route(0, 5, 0)                   # pod 0 owns session 5
        ln = 4 * int(r.request_bytes + r.response_bytes)
        d = r.route(2, 5, ln)
        assert d.action == want, (shards, d)


def test_router_freq_decays_with_clock():
    from repro_torch.core.stats import DecayedFrequency

    r = LocalityRouter(2, policy="long", freq_tau_ms=100.0)
    assert isinstance(r.freq, DecayedFrequency) and r.freq.grow_cols
    for _ in range(8):
        r.route(0, 7, 4)
    hot = r.freq.rates(r._now)[0, 7]
    r.tick(1000.0)                          # 10 tau of idle time
    cold = r.freq.rates(r._now)[0, 7]
    assert cold < 1e-3 * hot
    r.evict(7)
    assert r.freq.rates(r._now)[0, 7] == 0.0


def test_engine_async_plan_epoch_kicks_then_harvests():
    from repro_torch.plan import PlacementPlanner

    big = get_smoke_config("mixtral-8x7b")

    def run(plan_async):
        router = LocalityRouter(2, policy="short",
                                kv_bytes_per_token=10_000.0)
        planner = PlacementPlanner.for_serving(2, 8, device="cpu")
        eng = MultiPodEngine(2, SimBackend(big), router, planner=planner,
                             plan_async=plan_async, device="cpu")
        eng.submit(Request(sid=5, origin=0, n_tokens=1))
        eng.run_step()                       # pod 0 takes first-touch ownership
        saw_pending = False
        for _ in range(40):                  # ...but pod 1 sends all traffic
            eng.submit(Request(sid=5, origin=1, n_tokens=1))
            eng.run_step()
            saw_pending |= eng._pending_plan is not None
        eng.drain()
        return eng, saw_pending

    eng_async, saw_pending = run(True)
    assert saw_pending                       # a kicked epoch outlived its step
    assert eng_async.metrics.plan_epochs > 0
    assert eng_async.planner.planned_moves >= 1
    assert eng_async.router.owner[5] == 1    # re-homed to the hot pod
    assert eng_async.metrics.as_dict()["plan_block_s"] > 0.0

    eng_sync, saw_pending_sync = run(False)
    assert not saw_pending_sync              # sync epochs never leave a pending
    assert eng_sync.router.owner[5] == 1     # same steady state


# -- tests/test_certify.py: the serving certifier, on the port -------------

def _engine(n_pods=2, **router_kw):
    cfg = get_smoke_config("mixtral-8x7b")
    router = LocalityRouter(n_pods, policy="short",
                            kv_bytes_per_token=router_kw.pop("kvb", 1e9),
                            **router_kw)
    certifier = StepCertifier(n_pods, jax_min=1, device="cpu")
    return MultiPodEngine(n_pods, SimBackend(cfg), router, certifier)


def test_engine_certifies_forwarded_batch_in_one_dispatch():
    eng = _engine()
    eng.submit(Request(sid=1, origin=0, n_tokens=1))   # pod 0 owns sid 1
    eng.submit(Request(sid=2, origin=0, n_tokens=1))   # pod 0 owns sid 2
    eng.run_step()
    base_batches = eng.certifier.metrics.batches
    d1 = eng.submit(Request(sid=1, origin=1, n_tokens=1))
    d2 = eng.submit(Request(sid=2, origin=1, n_tokens=1))
    assert d1.action == d2.action == "forward"
    cm = eng.certifier.metrics
    t0, clock0 = cm.time_s, float(eng._pod_clock[0])
    eng.run_step()
    assert cm.batches == base_batches + 1              # ONE dispatch
    assert cm.max_batch >= 2 and cm.aborts == 0
    assert cm.certified >= 2
    assert cm.time_s > t0
    assert float(eng._pod_clock[0]) - clock0 >= eng.certifier.certify_time_s(2)
    assert eng.metrics.as_dict()["certified"] == cm.certified
    # the batch went through the drain route: one packed drain, no writes
    n_dirty, b = eng.certifier.store.staging.counts
    assert b == 8 and eng.certifier.store.staging.views.write_items.size == 0


def test_certify_time_scales_with_batch_not_per_request():
    c = StepCertifier(1, device="cpu")
    one, many = c.certify_time_s(1), c.certify_time_s(64)
    assert many < 64 * one                  # amortized, not a constant each
    assert many > one                       # but it does scale with rows


def test_stale_epoch_forward_aborts_and_reroutes():
    eng = _engine(kvb=1.0)                  # featherweight KV: acquires win
    eng.submit(Request(sid=5, origin=0, n_tokens=1))   # pod 0 owns sid 5
    eng.run_step()
    eng.router.owner[5] = 0
    d = eng.router.route(1, 5, 10**9)       # huge KV -> forward verdict
    assert d.action == "forward"
    req = Request(sid=5, origin=1, n_tokens=1)
    eng.certifier.enqueue(0, req, d.epoch)
    acq = eng.submit(Request(sid=5, origin=1, n_tokens=1))
    assert acq.action == "acquire"          # bumps the lease epoch
    aborts0 = eng.certifier.metrics.aborts
    eng.drain()
    assert eng.certifier.metrics.aborts == aborts0 + 1
    assert not eng.certifier.has_pending()
    assert req.n_tokens == 0                # re-routed and decoded


def test_router_epoch_bumps_on_every_ownership_move():
    r = LocalityRouter(2, policy="short", arbitration="priced",
                       kv_bytes_per_token=1.0)
    d0 = r.route(0, 9, 0)
    assert d0.epoch == 1                    # placement is a transition
    assert r.route(0, 9, 5).epoch == 1      # local reuse
    acq = r.route(1, 9, 5)                  # tiny KV: state moves
    assert acq.action == "acquire" and acq.epoch == 2
    fwd = r.route(0, 9, 10**9)              # heavy KV: work moves
    assert fwd.action == "forward" and fwd.epoch == 2


def test_evicted_session_replacement_invalidates_stale_forwards():
    eng = _engine()
    eng.submit(Request(sid=7, origin=0, n_tokens=1))   # pod 0 owns sid 7
    eng.run_step()
    d = eng.router.route(1, 7, 10**9)       # forward verdict, epoch 1
    assert d.action == "forward"
    stale = Request(sid=7, origin=1, n_tokens=1)
    eng.certifier.enqueue(0, stale, d.epoch)
    eng.router.evict(7)
    eng.backend.drop(0, 7)
    aborts0 = eng.certifier.metrics.aborts
    d2 = eng.submit(Request(sid=7, origin=1, n_tokens=1))  # re-placement
    assert d2.epoch > d.epoch
    eng.drain()
    assert eng.certifier.metrics.aborts == aborts0 + 1


# -- tests/test_lease_batched.py: eviction, on the port ---------------------

def test_router_evict_tombstones_and_recycles():
    r = LocalityRouter(2, policy="short")
    cert = StepCertifier(2, jax_min=1, device="cpu")
    dec = r.route(0, 5, 0)               # first placement
    cert.bump(5, dec.epoch)
    stale_epoch = dec.epoch
    tomb = r.evict(5)
    cert.purge(5)
    cert.bump(5, tomb)
    assert tomb > stale_epoch
    assert 5 not in r.lease_epoch        # live dict holds live sessions only
    cert.enqueue(0, Request(sid=5, origin=1), stale_epoch)
    passed, aborted, _ = cert.drain(0)
    assert passed == [] and len(aborted) == 1
    dec2 = r.route(1, 5, 0)
    assert dec2.epoch > tomb >= stale_epoch


def test_router_compacts_stat_columns_after_mass_eviction():
    r = LocalityRouter(2, policy="short")
    for sid in range(1500):
        r.route(sid % 2, sid, 0)
    assert r.freq.n_cols >= 2048
    for sid in range(1, 1500):
        r.evict(sid)
    assert max(r.owner) == 0
    assert r.freq.n_cols <= 512          # shrunk back toward the floor
    assert r.owner[0] in (0, 1)


def test_engine_evict_session_retires_everywhere():
    cfg = get_smoke_config("glm4-9b")
    eng = MultiPodEngine(2, SimBackend(cfg), LocalityRouter(2, policy="short"),
                         device="cpu")
    eng.submit(Request(sid=7, origin=0, n_tokens=4))
    eng.run_step()
    eng.submit(Request(sid=7, origin=1, n_tokens=4))   # forward or acquire
    assert 7 in eng.session_home
    old_epoch = eng.router.lease_epoch[7]
    eng.evict_session(7)
    assert 7 not in eng.session_home and 7 not in eng.session_len
    assert all(all(r.sid != 7 for r in q) for q in eng.queues)
    assert not eng.certifier.has_pending()
    assert 7 not in eng.router.owner
    dec = eng.submit(Request(sid=7, origin=1, n_tokens=2))
    assert dec.epoch > old_epoch
    eng.drain()


# -- tests/test_obs.py: per-pod metrics and tracing, on the port -----------

def _engine_run(trace, pods=2, sessions=8, steps=8, seed=0):
    cfg = get_config("mixtral-8x7b")
    kv = 2.0 * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers \
        if cfg.n_kv_heads else 4096.0 * cfg.n_layers
    router = LocalityRouter(pods, policy="short", arbitration="priced",
                            kv_bytes_per_token=kv)
    eng = MultiPodEngine(pods, SimBackend(cfg), router, trace=trace,
                         device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        for _ in range(2 * pods):
            sid = int(rng.integers(sessions))
            origin = sid % pods if rng.random() < 0.5 \
                else int(rng.integers(pods))
            eng.submit(Request(sid=sid, origin=origin, n_tokens=4))
        eng.run_step()
    eng.drain()
    return eng


def test_engine_per_pod_breakdown_sums_to_fleet():
    eng = _engine_run(trace=False)
    m = eng.metrics.as_dict()
    per_pod = m["per_pod"]
    assert set(per_pod) == {0, 1}
    assert sum(p["forwards"] for p in per_pod.values()) == m["forwards"]
    assert sum(p["local"] for p in per_pod.values()) == m["local"]
    assert sum(p["wire_GB"] for p in per_pod.values()) == \
        pytest.approx(m["wire_GB"])
    assert m["token_lat_p50_s"] <= m["token_lat_p90_s"] \
        <= m["token_lat_p99_s"]
    for p in per_pod.values():
        assert {"token_lat_p50_s", "token_lat_p99_s"} <= set(p)
    fleet = eng.metrics.token_latency()
    assert sum(eng.metrics.token_latency(p).count for p in per_pod) \
        == fleet.count


def test_engine_tracing_does_not_perturb_metrics():
    off = _engine_run(trace=False).metrics.as_dict()
    eng_on = _engine_run(trace=True)
    assert eng_on.trace is not None and len(eng_on.trace) > 0
    assert off == eng_on.metrics.as_dict()
    names = {e["name"] for e in eng_on.trace.to_events() if e["ph"] != "M"}
    assert {"wire", "certify", "decode"} <= names


def test_engine_trace_flag_forms():
    from repro_torch.obs.trace import TraceRecorder

    assert _engine_run(trace=None, steps=1).trace is None
    assert _engine_run(trace=False, steps=1).trace is None
    rec = TraceRecorder()
    assert _engine_run(trace=rec, steps=1).trace is rec


def test_router_and_affinity_are_pinned_copies():
    """The router and the planner's affinity tracker are the reference's
    modules with package-relative imports and the port's names in their
    docs."""
    import re

    for rel in ("serve/router.py", "plan/affinity.py"):
        ref = (REPO / "src/repro" / rel).read_text()
        ref = re.sub(r"^from repro\.(\S+) import", r"from ..\1 import", ref,
                     flags=re.M)
        ref = re.sub(r"(`|\(|# )repro\.", r"\1repro_torch.", ref)
        assert (REPO / "src/repro_torch" / rel).read_text() == ref
