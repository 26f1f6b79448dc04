"""repro_torch.dist.locality: a pinned copy of repro.dist.locality.

The copy's code equals the reference's (its docstring only adds that the
constants price a simulated TPU pod), the port's pricing equals the
reference's on a grid, and the reference's eight pricing tests
(``tests/test_dist_locality.py``) run here against the port.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import repro.dist.locality as J
import repro_torch.dist.locality as T
from repro_torch.dist.locality import (DCN_BW, MoEDispatchCost,
                                       SessionDispatchCost,
                                       price_moe_dispatch,
                                       price_session_dispatch)

REPO = Path(__file__).resolve().parents[1]


def _split_docstring(path):
    tree = ast.parse(path.read_text())
    doc = ast.get_docstring(tree, clean=False)
    tree.body = tree.body[1:]
    return doc, ast.dump(tree)


def test_locality_is_a_pinned_copy():
    ref_doc, ref_code = _split_docstring(REPO / "src/repro/dist/locality.py")
    port_doc, port_code = _split_docstring(
        REPO / "src/repro_torch/dist/locality.py")
    assert port_code == ref_code
    assert port_doc.startswith(ref_doc)
    assert "simulated TPU pod" in port_doc and "not measurements of the H100" \
        in " ".join(port_doc.split())


def test_pricing_equals_reference_on_a_grid():
    rng = np.random.default_rng(0)
    for _ in range(200):
        args = (float(rng.integers(0, 8192)), float(rng.integers(0, 4096)),
                float(rng.choice([0.0, 1e3, 1e6, 1e9]) * rng.random()))
        kw = dict(seq_shards=float(rng.choice([1, 2, 4, 8, 2.5])),
                  dcn_bw=float(rng.choice([T.DCN_BW, 1e9])))
        assert dataclasses.asdict(T.price_session_dispatch(*args, **kw)) \
            == dataclasses.asdict(J.price_session_dispatch(*args, **kw))
        moe = dict(tokens_per_device=int(rng.integers(1, 1 << 16)),
                   d_model=4096, top_k=2, n_experts=8, d_expert=14336,
                   ep_degree=int(rng.choice([1, 2, 8])),
                   tp_degree=int(rng.choice([1, 2])))
        assert dataclasses.asdict(T.price_moe_dispatch(**moe)) \
            == dataclasses.asdict(J.price_moe_dispatch(**moe))
    assert dataclasses.asdict(T.ROUTER_DEFAULTS) == \
        dataclasses.asdict(J.ROUTER_DEFAULTS)


# -- the reference's tests (tests/test_dist_locality.py), on the port ------

def test_session_crossover_as_kv_grows():
    """prefer_migration flips from False to True exactly once in kv bytes."""
    verdicts = [
        price_session_dispatch(4096, 1024, kv_state_bytes=kv).prefer_migration
        for kv in (0, 1_000, 5_000, 10_000, 100_000, 10_000_000, 1e9)
    ]
    assert verdicts[0] is False            # empty session: fetch the (no) state
    assert verdicts[-1] is True            # 1GB of KV: ship the request
    flips = sum(a != b for a, b in zip(verdicts, verdicts[1:]))
    assert flips == 1


def test_session_crossover_point_is_the_work_bytes():
    c = price_session_dispatch(4096, 1024, kv_state_bytes=0.0,
                               handoff_bytes=0.0)
    # at kv == work_bytes the two plans cost the same; just above, migrate
    at = price_session_dispatch(4096, 1024, kv_state_bytes=c.work_bytes,
                                handoff_bytes=0.0)
    above = price_session_dispatch(4096, 1024,
                                   kv_state_bytes=c.work_bytes * 1.01,
                                   handoff_bytes=0.0)
    assert at.migrate_work_s == pytest.approx(at.migrate_state_s)
    assert above.prefer_migration


def test_session_costs_monotone_in_bandwidth():
    slow = price_session_dispatch(4096, 1024, kv_state_bytes=1e6,
                                  dcn_bw=DCN_BW / 4)
    fast = price_session_dispatch(4096, 1024, kv_state_bytes=1e6,
                                  dcn_bw=DCN_BW * 4)
    assert slow.migrate_state_s > fast.migrate_state_s
    assert slow.migrate_work_s > fast.migrate_work_s
    # the verdict is a byte comparison: bandwidth scales both plans equally
    assert slow.prefer_migration == fast.prefer_migration


def test_session_wire_bytes_tracks_chosen_plan():
    c = price_session_dispatch(4096, 1024, kv_state_bytes=50_000_000)
    assert isinstance(c, SessionDispatchCost)
    assert c.prefer_migration and c.wire_bytes == c.work_bytes
    c2 = price_session_dispatch(4096, 1024, kv_state_bytes=100.0)
    assert not c2.prefer_migration and c2.wire_bytes == c2.state_bytes


def test_session_seq_shards_cuts_per_hop_state_time():
    """A seq-sharded column moves as parallel shard hops: the state plan's
    serialization shrinks by 1/seq_shards while total wire bytes stay put."""
    whole = price_session_dispatch(4096, 1024, kv_state_bytes=64_000_000,
                                   handoff_bytes=0.0)
    split = price_session_dispatch(4096, 1024, kv_state_bytes=64_000_000,
                                   handoff_bytes=0.0, seq_shards=16)
    assert split.state_bytes == whole.state_bytes          # total unchanged
    assert split.state_hop_bytes == pytest.approx(whole.state_bytes / 16)
    assert split.migrate_state_s < whole.migrate_state_s
    # work plan is untouched by the state layout
    assert split.migrate_work_s == whole.migrate_work_s


def test_session_seq_shards_can_flip_the_verdict():
    """Near the crossover, the cheaper per-hop state move flips the verdict
    from forward-the-work to acquire-the-state."""
    kv = price_session_dispatch(4096, 1024, kv_state_bytes=0.0,
                                handoff_bytes=0.0).work_bytes * 4
    whole = price_session_dispatch(4096, 1024, kv_state_bytes=kv,
                                   handoff_bytes=0.0)
    split = price_session_dispatch(4096, 1024, kv_state_bytes=kv,
                                   handoff_bytes=0.0, seq_shards=8)
    assert whole.prefer_migration             # 4x the work bytes: forward
    assert not split.prefer_migration         # /8 per hop: acquire wins


def test_moe_dispatch_flips_with_ep_degree():
    """Wide EP favors token a2a; a single device needs no wire at all."""
    kw = dict(tokens_per_device=4096, d_model=4096, top_k=2,
              n_experts=8, d_expert=14336)
    c1 = price_moe_dispatch(ep_degree=1, **kw)
    c8 = price_moe_dispatch(ep_degree=8, **kw)
    assert isinstance(c8, MoEDispatchCost)
    assert c1.dispatch_bytes == 0.0 and not c1.prefer_dispatch
    assert c8.prefer_dispatch
    assert c8.dispatch_s < c8.allgather_s


def test_moe_dispatch_flips_with_batch():
    """Weight traffic is batch-independent: tiny batches flip to all-gather."""
    kw = dict(d_model=4096, top_k=2, n_experts=8, d_expert=14336, ep_degree=8)
    small = price_moe_dispatch(tokens_per_device=1, **kw)
    big = price_moe_dispatch(tokens_per_device=1 << 20, **kw)
    assert small.prefer_dispatch            # 1 token beats 8 experts' weights
    assert big.dispatch_bytes > big.allgather_bytes and not big.prefer_dispatch
