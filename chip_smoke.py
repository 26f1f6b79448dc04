#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env    — card name, card count, ``nvidia-smi`` name and power limit.
            No card: exit 1 before anything else.
2. build  — one ``nvcc`` per kernel, all started at once, builds
            ``lease_validate``, ``flash_attention`` and ``ssd_scan`` from
            ``src/repro_torch/kernels/csrc``; wall seconds, and each
            kernel's nvcc seconds and ptxas report (registers, shared
            memory, spills).
3. kernel — the kernel against its plain PyTorch version, bitwise, at the
            simulator's shapes (1,140,088 items, B in {8, 16}, R = 32,
            W = 16, plus a lock-free W = 1 case) and at a wide shape
            (B = 1024, R = 256, W = 64, 2^20 items).  ``ms`` is the time
            per call as a caller sees it (CUDA events around many calls,
            host launch cost included), ``graph_ms`` the device time per
            call (many calls replayed from one CUDA graph); the bound is
            the bytes at 3.35 TB/s; ``launches`` counts the kernel calls
            the case made (check, timing and graph capture).
   kernel_drain — the ``drain`` variant (one launch: flush the dirty
            pairs, class-owner write check, certify) against
            ``ref.lease_drain_ref``, bitwise on ok and on the flushed table,
            at the main path's shapes (TPC-C's 1,140,088 items and class
            map, B in {8, 16}, R = 32, W = 16, B x W dirty items); per-call
            wall (launch + wait), device time by CUDA-graph replay, the
            plain version and the bound.  Then a
            whole drain as the cluster calls it (``validate_batch``),
            per-drain host wall for four routes in
            turns: ``per_item``, the route before the drain variant
            (per-item locks on the card, flush, ``gather``, ``.cpu()``),
            ``drain``, the floor and the CPU twin.
            After phase 5 (a profiler session may leave hooks behind),
            ``kernel_drain_ops``: device operations per drain under
            ``torch.profiler`` for the two card routes.
4. main   — the Lilac-TM commit path: LILAC-TM-ST on TPC-C at the TPC-C
            specification's cardinalities (8 warehouses, 1,140,088 items,
            version tables on the card), 300 ms of simulated time.  Every
            batched drain must have launched ``drain`` once (and ``gather``
            never); the same run on the CPU must give byte-identical
            replica stores and identical metrics.  ``validate_s`` is the
            wall inside ``validate_batch``; ``drain_plans`` counts the
            drains by the launch plan their (B, n_dirty) takes, beside the
            largest B and n_dirty of the run.
5. forced — Bank at SimConfig defaults with every drain through the kernel
            and every lease settle through the device ops, a node failure
            at 120 ms; cuda against cpu, byte-identical; the same drain
            checks.
6. kernel_flash — the flash kernel against ``ref.sdpa_ref`` on the card,
            each case printing the variant that ran (``prefill_tc``,
            ``decode_split`` or ``simt``, which the launcher picks from the
            dtype and shapes): glm4-9b prefill (B = 4, S = 2048, Hq = 32,
            Hkv = 2, D = 128, causal, bf16), glm4-9b decode (Sq = 1
            against a 2080-slot ring, per-row valid lengths, unwritten tail
            at 2^30; timed over 8 distinct caches, 68 MB, in rotation so L2
            is cold as it is for the model's 40 layers, and over one cache,
            ``*_warm``), the reference's test grid (tests/test_kernels.py)
            and the variants' edges (a ragged last tile, no causal mask, a
            window, 64 decode rows, one valid key, f32 decode at D 64); f32
            within 2e-5, bf16 within atol 1e-3 + rtol 1.6e-2 (two bf16
            ulps: every variant computes in fp32 and rounds the output
            once, prefill_tc with P.V on bf16 hi + lo parts of P).  Per
            case: ``ms`` (CUDA events), ``graph_ms`` (CUDA-graph replay),
            ``plain_ms``, ``bound_ms``/``bound_by`` (FLOPs of the visible
            pairs at 989 TFLOP/s bf16 or 67 TFLOP/s fp32; bytes of q, the
            output and the keys some row sees, at 3.35 TB/s) and
            ``library_ms``: ``scaled_dot_product_attention`` with
            ``enable_gqa=True`` at the same shape, a yardstick the port
            never calls (null for softcap, which it cannot compute).
7. kernel_ssd — the SSD kernel against ``ref.ssd_ref``, each case
            printing the variant that ran (``tc`` or ``simt``, which the
            launcher picks from the dtype and shapes): mamba2-780m's
            prefill shape (B = 4, S = 2048, H = 48, P = 64, N = 128,
            chunk = 256, bf16, nonzero h0), the reference's grid and an
            odd head count (H = 5, P = 32, chunk 32) in f32 and bf16
            (``simt``), and tc's edges in bf16 (H 5, no h0, a ragged S,
            chunks 64 and 128, N 64, B x H below 132); y within 2e-5 of
            max|y| (1e-2 in bf16), the state at atol 2e-3 / rtol 1e-4; the
            same fields, ``library_ms`` null (no PyTorch call computes the
            scan), and for ``tc`` ``floor_ms``, the least time of this
            design's own traffic and tensor work.  Then tc's two kernels
            one at a time at mamba2-780m's shape against ``ref.ssd_states``
            and ``ref.ssd_outputs`` (``kernel_ssd_phases``).
8. glm4   — glm4-9b at full width and depth (40 layers, d_model 4096,
            bf16 weights from a seeded ``torch.Generator``): prefill 4 x
            2048 tokens, move the cache into a 2080-slot ring, 16
            ``decode_step``s with ``[B]`` positions; once with
            ``use_kernel="auto"`` (counts reset just before, flash launches
            must be 40 + 16 x 40: prefill_tc 40, decode_split 640, simt 0) and once with ``"ref"`` on the card, each
            after an untimed warm-up run at the same shapes.
            Logits agree within 6% of the largest logit; the share of
            greedy tokens that agree, wall seconds, tokens per second and
            peak memory are printed, and a ``torch.profiler`` trace of one
            more prefill and one more decode step with the kernels gives
            device busy time and the largest device ops.
9. mamba2 — the same for mamba2-780m (48 layers, d_model 1536); ssd
            launches must be 48 (one per layer, at prefill), all ``tc``.
10. held  — both models at full width and 2 layers, 64-token prompt and 4
            decode steps, on ``cuda`` and on ``cpu`` through the port, the
            same bf16 weights: logits within 6e-2 (atol and rtol, the CPU
            tests' bf16 tolerance against the reference).  The CPU port is
            what the tests hold to JAX, so this ties the card to it.

11. serve — the serving path of ``benchmarks/serve_locality.py``
            through the port's ``repro_torch.launch.serve.run_point`` (its
            recipe; the card's machine has no JAX) at its defaults:
            mixtral-8x7b's KV sizes, 8 pods, 256 sessions, 80 steps,
            every GRID (policy,
            arbitration) pair x localities {0.0, 0.5, 0.9} x seeds 0-2, on
            cuda and on cpu, identical (run_point's keys,
            ``EngineMetrics.as_dict()`` without the wall-clock
            ``plan_block_s``, the router's metrics).  Once at the
            certifier's default (batches below 8 settle on the host) and
            once with ``StepCertifier(jax_min=1)``: every certification
            batch through ``validate_batch``'s drain route, each a
            ``drain`` launch (W = 0, no class view), ``gather`` never;
            drains by launch plan, largest B and n_dirty.  Then the drain
            kernel at the serving shape against its twin
            (``kernel_drain`` lines ``serve_B*``).  ``tokens_per_s`` here
            is SimBackend's priced TPU pod, not the card's speed.
12. serve_plan — ``benchmarks/planner.py``'s sweep with the planner on
            (96 sessions, 160 steps, SERVE_PLAN_DEFAULTS, localities {0.0,
            0.7, 0.9}, seeds 0-2), async and sync plan epochs, cuda
            identical to cpu in each mode; planned moves at 0.9.  Then
            ``launch.serve.main`` with the planner on, cuda against cpu.
13. plan_score — the scorer at 2^17 classes x 16 nodes on the card,
            bitwise equal to ``score_moves_np``; sync, kick and harvest ms
            around host work as ``overlap_cell`` times them; the bound.
14. sim_plan — phase 4's TPC-C run with ``SimConfig.plan``
            (SIM_PLAN_DEFAULTS) on cuda and cpu: byte-identical, planner
            epochs and prefetches issued, every drain through ``drain``.

The last three lines are the ``nvidia-smi`` line, the kernels record (one
entry per lease_validate, flash and SSD variant; ``lease_validate.drain``
counts its launches on every path that reaches it, by path in
``launches_by_path``), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 SXM non-tensor-core fp32 rate
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
VALID_POS_LIMIT = 2 ** 29      # kv positions at or above it are padding
MODEL_TOL = 0.06               # auto vs ref logits, share of max |logit|
# flash kernel against ref.sdpa_ref: f32 at the reference's 2e-5; bf16 at
# two bf16 ulps (2^-6 of the value) plus 1e-3.  Both sides compute in fp32
# from the same bf16 inputs and round the output once: decode_split and
# simt keep fp32 throughout, prefill_tc runs P.V on P's bf16 hi + lo parts
# (~16 bits of P; a single bf16 P misses this limit in early causal rows)
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 1.6e-2)}
HELD_TOL = 6e-2                # cuda vs cpu logits, atol and rtol

# TPC-C Standard Specification rev. 5.11, clause 1.2 / 4.3.3.1
TPCC_SPEC = dict(n_customers=30000, n_stock=100000, n_catalog=100000)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 100, replays: int = 20) -> float:
    """Device time per call: ``launches`` calls captured in one CUDA graph
    and replayed, so the host's launch cost drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


# -- phase 3: kernel against its plain version -------------------------------

def make_inputs(rng: np.random.Generator, n: int, b: int, r: int, w: int,
                *, lock_frac: float = 0.05, stale_frac: float = 0.02,
                empty_rows: int = 1, lock_free: bool = False):
    """Certification inputs shaped like a drain: -1-padded rows of varying
    length, a few all-padded rows, ~2% stale reads and ~5% locked items."""
    store = rng.integers(0, 1 << 20, n).astype(np.int32)
    locks = (rng.random(n) < lock_frac).astype(np.int32)
    items = rng.integers(0, n, (b, r)).astype(np.int32)
    lens = rng.integers(1, r + 1, b)
    lens[:empty_rows] = 0
    items[np.arange(r)[None, :] >= lens[:, None]] = -1
    vers = store[np.maximum(items, 0)]
    stale = rng.random((b, r)) < stale_frac
    vers = np.where(stale, vers + 1, vers).astype(np.int32)
    if lock_free:
        witems = np.full((b, 1), -1, np.int32)
    else:
        witems = rng.integers(0, n, (b, w)).astype(np.int32)
        wlens = rng.integers(1, w + 1, b)
        wlens[:empty_rows] = 0
        witems[np.arange(w)[None, :] >= wlens[:, None]] = -1
    return store, items, vers, locks, witems


def bound_ms(items: np.ndarray, witems: np.ndarray) -> tuple:
    """Least time for the work: each row input read once, each distinct
    gathered table entry once, the output once; compares at the scalar
    rate.  Returns (ms, "bytes" | "operations")."""
    b = items.shape[0]
    distinct = np.unique(items[items >= 0]).size \
        + np.unique(witems[witems >= 0]).size
    n_bytes = 4 * (2 * items.size + witems.size) + 4 * distinct + b
    n_ops = int((items >= 0).sum() + (witems >= 0).sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_case(name: str, rng, n, b, r, w, iters: int, **kw) -> dict:
    import torch

    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import ref
    from repro_torch.kernels.lease_validate import lease_validate

    launches_before = lv.launches
    host = make_inputs(rng, n, b, r, w, **kw)
    store, items, vers, locks, witems = (torch.from_numpy(a).cuda()
                                         for a in host)
    ok = lease_validate(store, items, vers, locks, witems)
    torch.cuda.synchronize()
    locks_bool = locks > 0
    want = ref.lease_validate_ref(store, items, vers, locks_bool, witems)
    err = int((ok.to(torch.int32) - want.to(torch.int32)).abs().max())
    check(torch.equal(ok, want), f"{name}: kernel disagrees with "
          f"ref.lease_validate_ref ({int((ok != want).sum())} rows)")
    kernel = lambda: lease_validate(store, items, vers, locks, witems)
    plain = lambda: ref.lease_validate_ref(store, items, vers, locks_bool,
                                           witems)
    bms, by = bound_ms(host[1], host[4])
    out = dict(case=name, n_items=n, B=b, R=r, W=int(witems.shape[1]),
               passing=int(ok.sum()), max_abs_err=err,
               ms=time_ms(kernel, iters), plain_ms=time_ms(plain, iters),
               graph_ms=graph_ms(kernel), plain_graph_ms=graph_ms(plain),
               bound_ms=bms, bound_by=by,
               launches=lv.launches - launches_before)
    emit("kernel", **out)
    return out


# -- phase 3b: the drain variant, and a certification drain's routes --------

def tpcc_item_classes() -> tuple:
    """TPC-C's item -> class map at the specification's cardinalities, as
    the cluster builds it: (item_cc int32 [1,140,088], n_classes)."""
    import repro_torch.core as T

    lay = T.TpccLayout(n_nodes=4, **TPCC_SPEC)
    ccmap = T.TpccConflictMap(lay)
    item_cc = np.fromiter((ccmap.of_item(i) for i in range(lay.n_items)),
                          np.int32, count=lay.n_items)
    return item_cc, ccmap.n_classes


def drain_inputs(rng, n, b, r, w, n_classes, n_dirty) -> dict:
    """One drain shaped like the main path's: make_inputs' rows, n_dirty
    written items (repeats allowed) some of which the rows read, each at
    its new version or the one before the flush, and class owners split
    between unowned, this node (1) and another."""
    table, items, vers, _, witems = make_inputs(rng, n, b, r, w)
    dirty = rng.integers(0, n, n_dirty).astype(np.int32)
    versions = table.copy()
    versions[dirty] = rng.integers(1 << 20, 1 << 21, n_dirty)
    hit = (items >= 0) & (rng.random(items.shape) < 0.1)
    items[hit] = dirty[rng.integers(0, n_dirty, int(hit.sum()))]
    slot = np.maximum(items, 0)
    fresh = rng.random(items.shape) < 0.8
    vers = np.where(hit, np.where(fresh, versions[slot], table[slot]),
                    vers).astype(np.int32)
    owners = rng.choice(np.array([-1, 1, 2], np.int32), n_classes,
                        p=[0.5, 0.45, 0.05])
    return dict(table=table, dirty_idx=dirty, dirty_ver=versions[dirty],
                owners=owners, node=1, read_items=items,
                read_versions=vers, write_items=witems)


def stage(staging, case: dict) -> None:
    b, r = case["read_items"].shape
    v = staging.begin(case["dirty_idx"].size, b, r,
                      case["write_items"].shape[1], case["owners"].size,
                      case["node"])
    for name in ("dirty_idx", "dirty_ver", "owners", "read_items",
                 "read_versions", "write_items"):
        getattr(v, name)[:] = case[name]


def drain_bound_ms(case: dict) -> tuple:
    """Least time for a drain's work: each input read once (dirty pairs,
    owners, rows), each distinct table entry and item class gathered once,
    each distinct dirty item written once, ok written once; one compare a
    slot at the scalar rate.  Returns (ms, "bytes" | "operations")."""
    items, witems = case["read_items"], case["write_items"]
    n_bytes = (8 * case["dirty_idx"].size + 4 * case["owners"].size
               + 4 * (2 * items.size + witems.size)
               + 4 * np.unique(items[items >= 0]).size
               + 4 * np.unique(witems[witems >= 0]).size
               + 4 * np.unique(case["dirty_idx"]).size + items.shape[0])
    n_ops = int((items >= 0).sum() + (witems >= 0).sum()
                + case["dirty_idx"].size)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wall_us(fn, iters: int, warmup: int = 50) -> float:
    """Mean host wall per call of ``fn``, which waits for its own work."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def drain_case(name: str, rng, n, b, r, w, item_cc, n_classes,
               n_dirty) -> dict:
    """The drain kernel against ``ref.lease_drain_ref`` on the card,
    bitwise on ok and on the flushed table; then the per-call wall (launch
    + wait), the device time (CUDA-graph replay without the wait), the
    plain version and the bound."""
    import torch

    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    case = drain_inputs(rng, n, b, r, w, n_classes, n_dirty)
    cc = torch.from_numpy(item_cc).to(dev)
    staging = lv.DrainStaging(dev)
    stage(staging, case)
    on = {k: torch.from_numpy(case[k]).to(dev) for k in (
        "dirty_idx", "dirty_ver", "owners", "read_items", "read_versions",
        "write_items")}
    want_table = torch.from_numpy(case["table"]).to(dev)
    want = ref.lease_drain_ref(
        want_table, on["dirty_idx"], on["dirty_ver"], cc, on["owners"],
        case["node"], on["read_items"], on["read_versions"],
        on["write_items"]).cpu().numpy()
    table = torch.from_numpy(case["table"]).to(dev)
    got = lv.lease_drain(table, staging, cc).copy()
    err = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    check(np.array_equal(got, want), f"{name}: drain disagrees with "
          f"ref.lease_drain_ref on ok ({int((got != want).sum())} rows)")
    check(torch.equal(table, want_table), f"{name}: drain flushed another "
          f"table than ref.lease_drain_ref")
    # the same drain again and again: re-flushing equal pairs is idempotent
    kernel = lambda: lv.lease_drain(table, staging, cc)
    plain = lambda: ref.lease_drain_ref(
        want_table, on["dirty_idx"], on["dirty_ver"], cc, on["owners"],
        case["node"], on["read_items"], on["read_versions"],
        on["write_items"])
    bms, by = drain_bound_ms(case)
    before = lv.launches
    out = dict(case=name, n_items=n, B=b, R=r, W=w, n_classes=n_classes,
               n_dirty=n_dirty, passing=int(want.sum()), max_abs_err=err,
               ms=wall_us(kernel, 2000) / 1e3,
               graph_ms=graph_ms(lambda: lv.lease_drain(
                   table, staging, cc, wait=False)),
               plain_ms=time_ms(plain, 500),
               plain_graph_ms=graph_ms(plain), bound_ms=bms, bound_by=by,
               library_ms=None, calls=lv.launches - before)
    emit("kernel_drain", **out)
    return out


def device_ops_per_call(fn, calls: int = 20) -> dict:
    """Device operations (kernels, copies, fills) per call of ``fn`` under
    ``torch.profiler``, by name, and their device time per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return dict(ops_per_call=sum(c for _, c, _ in rows) / calls,
                device_us_per_call=sum(t for _, _, t in rows) / calls,
                ops={k[:70]: c / calls for k, c, _ in rows})


def drain_routes(rng, item_cc, n_classes, b: int, drains: int, *,
                 profile: bool = False) -> dict:
    """Per-drain host wall of a whole certification drain as the cluster
    calls it, at the main path's shapes (TPC-C's items and class map, B
    transactions of up to 32 reads and 16 writes, the previous drain's
    writes pending), for four routes on the same drains in turns:

    - ``per_item``: the route before the drain variant: per-item locks
      derived on the card from the class owners (``Cluster._write_locks``
      as it was, int64 item -> class), then ``validate_batch(locks=...)``
      (``device_versions`` flush, pageable copies, ``gather``, ``.cpu()``);
    - ``drain``: ``validate_batch(class_locks=...)``, one launch and wait;
    - ``floor``: an empty kernel through the same ctypes launch and wait;
    - ``cpu``: ``validate_batch(class_locks=...)`` on a CPU store (the twin).

    With ``profile``, instead: the device operations per drain of the two
    card routes under ``torch.profiler`` (run after the cluster phases: a
    profiler session may leave its tracing hooks behind).
    """
    import torch

    from repro_torch.core import stm
    from repro_torch.kernels import lease_validate as lv

    dev = torch.device("cuda")
    n = item_cc.size
    stores = {k: stm.VersionedStore(n, device=d)
              for k, d in (("per_item", "cuda"), ("drain", "cuda"),
                           ("cpu", "cpu"))}
    cc64 = torch.from_numpy(item_cc.astype(np.int64)).to(dev)
    cc32 = torch.from_numpy(item_cc).to(dev)
    cc_cpu = torch.from_numpy(item_cc)
    node = 1
    owners = rng.choice(np.array([-1, 1, 2], np.int32), n_classes,
                        p=[0.5, 0.45, 0.05])

    def txns_for(store):
        out = []
        for k in range(b):
            t = stm.Transaction(txid=k + 1, origin=0)
            for item in rng.integers(0, n, int(rng.integers(1, 33))):
                t.log_read(int(item), int(store.versions[item]))
            for item in rng.integers(0, n, int(rng.integers(1, 17))):
                t.write_set[int(item)] = 1.0
            out.append(t)
        return out

    def per_item(store, txns):
        owners_dev = torch.from_numpy(owners).to(dev)
        owner = owners_dev[cc64]
        locks = ((owner >= 0) & (owner != node)).to(torch.int32)
        return stm.validate_batch(store, txns, locks=locks)

    routes = {
        "per_item": per_item,
        "drain": lambda store, txns: stm.validate_batch(
            store, txns, class_locks=stm.ClassLocks(cc32, owners, node)),
        "cpu": lambda store, txns: stm.validate_batch(
            store, txns, class_locks=stm.ClassLocks(cc_cpu, owners, node)),
    }
    if profile:
        out = {}
        for k in ("per_item", "drain"):
            def one(k=k):
                txns = txns_for(stores[k])
                stores[k].apply_batch([t.write_set for t in txns],
                                      [len(txns)] * len(txns))
                routes[k](stores[k], txns)
            out[k] = device_ops_per_call(one)
        emit("kernel_drain_ops", B=b, **out)
        return out
    walls = {k: [] for k in ("per_item", "drain", "floor", "cpu")}
    version = 1
    for i in range(drains):
        # the same transactions and the same pending writes for each route
        txns = txns_for(stores["drain"])
        writes = [t.write_set for t in txns]
        version += 1
        for store in stores.values():
            store.apply_batch(writes, [version] * len(writes))
        verdicts = []
        for k in ("per_item", "drain", "floor", "cpu"):
            t0 = time.perf_counter()
            if k == "floor":
                lv.empty_drain(dev)
            else:
                verdicts.append(routes[k](stores[k], txns))
            walls[k].append((time.perf_counter() - t0) * 1e6)
        check(all(np.array_equal(verdicts[0], v) for v in verdicts),
              f"drain routes disagree at B={b}, drain {i}")
    for k, store in stores.items():
        check(np.array_equal(store.device_versions().cpu().numpy(),
                             store.versions.astype(np.int32)),
              f"{k} route's device table differs from its host versions")
    warm = 20
    out = dict(B=b, drains=drains - warm, **{
        f"{k}_us": float(np.mean(v[warm:])) for k, v in walls.items()},
        **{f"{k}_median_us": float(np.median(v[warm:]))
           for k, v in walls.items()})
    emit("kernel_drain", routes=True, **out)
    return out


def kernel_drain_phase() -> tuple:
    """The drain at the main path's shapes: bitwise against its twin and
    timed (``drain_case``), then the four routes per drain.  Returns the
    cases and TPC-C's class map (for ``drain_routes(profile=True)``)."""
    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    item_cc, n_classes = tpcc_item_classes()
    n = item_cc.size
    emit("kernel_drain", tpcc_map_s=time.perf_counter() - t0, n_items=n,
         n_classes=n_classes)
    cases = [drain_case(f"main_B{b}", rng, n, b, 32, 16, item_cc, n_classes,
                        b * 16) for b in (8, 16)]
    for b in (8, 16):
        drain_routes(rng, item_cc, n_classes, b, 320)
    return cases, item_cc, n_classes


# -- phases 4-5: the simulator on cuda and on cpu ----------------------------

class DrainStats:
    """The batched drains one path makes through ``module.validate_batch``
    while the ``with`` block runs: transactions and drains, the wall inside
    the calls, the drains by launch plan (``variant()``'s, from the packed
    (B, n_dirty); the wrapper raises if the launcher took another) and the
    largest B and n_dirty."""

    def __init__(self, module) -> None:
        self.module = module
        self.txns = self.drains = 0
        self.validate_s = 0.0
        self.plans = {"one_cta": 0, "cluster": 0, "two_launches": 0}
        self.largest = {"B": 0, "n_dirty": 0}

    def __enter__(self):
        from repro_torch.kernels import lease_validate as lv

        plain = self.plain = self.module.validate_batch

        def counting(store, txns, *args, **kw):
            self.txns += len(txns)
            self.drains += 1
            t = time.perf_counter()
            try:
                ok = plain(store, txns, *args, **kw)
            finally:
                self.validate_s += time.perf_counter() - t
            n_dirty, b = store.staging.counts
            _, ctas, kernels = lv.variant(b, n_dirty, per_item_locks=False)
            self.plans["one_cta" if ctas == 1 else "cluster" if kernels == 1
                       else "two_launches"] += 1
            self.largest.update(B=max(self.largest["B"], b),
                                n_dirty=max(self.largest["n_dirty"], n_dirty))
            return ok

        self.module.validate_batch = counting
        return self

    def __exit__(self, *exc) -> None:
        self.module.validate_batch = self.plain


def reset_launches() -> None:
    """Every kernel count to 0: just before a path is driven."""
    from repro_torch.kernels import lease_validate as lv

    lv.launches = 0
    lv.variant_launches.update(gather=0, drain=0)


def lease_launches() -> dict:
    from repro_torch.kernels import lease_validate as lv

    return dict(lv.variant_launches, all=lv.launches)


def run_cluster(workload: str, device: str, cfg_kw: dict, fail_at=None):
    import torch

    import repro_torch.core as T
    import repro_torch.core.cluster as cluster_mod

    if workload == "tpcc":
        lay = T.TpccLayout(n_nodes=4, **TPCC_SPEC)
        ccmap = T.TpccConflictMap(lay)
        cfg = T.SimConfig(n_items=lay.n_items, n_classes=ccmap.n_classes,
                          device=device, **cfg_kw)
        wl = T.TpccWorkload(lay)
    else:
        ccmap = None
        cfg = T.SimConfig(device=device, **cfg_kw)
        wl = T.BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items)
    t0 = time.perf_counter()
    c = T.make_cluster("LILAC-TM-ST", wl, cfg, ccmap=ccmap)
    if fail_at is not None:
        c.events.schedule(fail_at, lambda: c.gcs.fail(3))
    t1 = time.perf_counter()
    reset_launches()                    # just before the path
    with DrainStats(cluster_mod) as stats:
        m = c.run()
        if device == "cuda":
            torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = lease_launches()
    for r in c.replicas:
        mirror = r.store.device_versions().cpu().numpy()
        check(np.array_equal(mirror, r.store.versions.astype(np.int32)),
              f"{workload}/{device}: device version table of replica "
              f"{r.node} differs from its host versions")
    state = [(r.store.values.tobytes(), r.store.versions.tobytes())
             for r in c.replicas]
    return dict(metrics=dataclasses.asdict(m), state=state,
                kernel_txns=stats.txns, kernel_drains=stats.drains,
                validate_s=stats.validate_s, launches=launches,
                drain_plans=stats.plans, largest=stats.largest,
                build_s=t1 - t0, run_s=t2 - t1, n_items=cfg.n_items)


def compare_runs(phase: str, on_card: dict, on_cpu: dict) -> None:
    check(on_card["state"] == on_cpu["state"],
          f"{phase}: replica stores differ between cuda and cpu")
    check(on_card["metrics"] == on_cpu["metrics"],
          f"{phase}: metrics differ between cuda and cpu")


def summary(run: dict) -> dict:
    m = run["metrics"]
    return dict(n_items=run["n_items"], commits=m["commits"],
                aborts=m["aborts"], forwards=m["forwards"],
                cert_batches=m["cert_batches"],
                kernel_launches=run["launches"]["all"],
                variant_launches={k: v for k, v in run["launches"].items()
                                  if k != "all"},
                kernel_drains=run["kernel_drains"],
                kernel_txns=run["kernel_txns"], drain_plans=run["drain_plans"],
                largest_B=run["largest"]["B"],
                largest_n_dirty=run["largest"]["n_dirty"],
                build_s=run["build_s"], run_s=run["run_s"],
                validate_s=run["validate_s"])


def check_drains(phase: str, run: dict) -> None:
    """Every batched drain of the card run launched ``drain``, once."""
    n = run["launches"]
    check(n["drain"] > 0, f"{phase} path never launched lease_validate")
    check(n["drain"] == run["kernel_drains"] == n["all"],
          f"{phase}: {n['drain']} drain launches for "
          f"{run['kernel_drains']} batched drains ({n['all']} in all)")
    check(n["gather"] == 0, f"{phase}: gather launched {n['gather']} times")
    check(sum(run["drain_plans"].values()) == run["kernel_drains"],
          f"{phase}: drain plans {run['drain_plans']} do not add up to "
          f"{run['kernel_drains']} drains")


# -- phases 6-7: the model kernels against their plain versions --------------

def timings(fn, budget_ms: float = 300.0) -> tuple:
    """(ms per call by CUDA events, device ms per call by CUDA-graph
    replay, calls), the call count sized to the budget from one timed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) * 1e3
    n = int(min(200, max(3, budget_ms / max(one, 1e-3))))
    return time_ms(fn, n, warmup=2), graph_ms(fn, launches=n, replays=3), n


def op_bound(flops: float, n_bytes: float, flops_per_s: float) -> tuple:
    """Least time for the work: (ms, "operations" | "bytes")."""
    t_ops = flops / flops_per_s * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_case(name: str, b, sq, skv, hq, hkv, dk, dv, *, causal=True,
               window=None, cap=0.0, dtype="bfloat16", decode=False,
               valid0=None, copies=1, seed=0) -> dict:
    """One shape through ``ops.attention`` on the card, held to
    ``ref.sdpa_ref``.  ``copies`` > 1 times the calls over that many
    distinct q/k/v sets in rotation, so L2 (50 MB) is cold as it is for a
    model's layers; the first set is also timed alone (``*_warm``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = getattr(torch, dtype)
    sets = [tuple(torch.randn(shape, generator=gen, device=dev).to(td)
                  for shape in ((b, sq, hq, dk), (b, skv, hkv, dk),
                                (b, skv, hkv, dv)))
            for _ in range(copies)]
    q, k, v = sets[0]
    kp = torch.arange(skv, dtype=torch.int32, device=dev).expand(b, skv)
    if decode:   # per-row valid lengths; the ring's unwritten tail at 2^30
        valid = torch.randint(skv // 2, skv + 1, (b,), generator=gen,
                              device=dev)
        if valid0 is not None:
            valid[0] = valid0
        qp = (valid - 1).to(torch.int32)[:, None].contiguous()
        kp = torch.where(kp < valid[:, None], kp, torch.full_like(kp, 2 ** 30))
    else:
        qp = torch.arange(skv - sq, skv, dtype=torch.int32,
                          device=dev).expand(b, sq).contiguous()
    kp = kp.contiguous()
    kw = dict(q_positions=qp, kv_positions=kp, causal=causal,
              sliding_window=window, logit_softcap=cap)
    variant = fa.variant(td, sq, hq, hkv, dk, dv)
    before, by_variant = fa.launches, dict(fa.variant_launches)
    out = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    by_variant[variant] += 1
    check(fa.launches == before + 1 and fa.variant_launches == by_variant,
          f"{name}: flash kernel variant {variant} did not launch")
    want = ref.sdpa_ref(q, k, v, **kw)
    err = float((out.float() - want.float()).abs().max())
    atol, rtol = FLASH_TOL[dtype]
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    check(torch.allclose(out.float(), want.float(), atol=atol, rtol=rtol),
          f"{name}: flash kernel disagrees with ref.sdpa_ref "
          f"(max abs err {err}, atol {atol}, rtol {rtol})")

    def rotating(fn):
        turn = iter(range(1 << 62))
        return lambda: fn(*sets[next(turn) % copies])

    kernel = lambda q, k, v: ops.attention(q, k, v, **kw)
    plain = lambda q, k, v: ref.sdpa_ref(q, k, v, **kw)
    ms, g_ms, n = timings(rotating(kernel))
    plain_ms, plain_g_ms, _ = timings(rotating(plain))
    visible = ref.attn_mask(qp, kp, causal, window) \
        & (kp < VALID_POS_LIMIT)[:, None, :]
    pairs = int(visible.sum()) * hq
    # bytes this data needs: q and out, and each key some row sees, once
    seen_keys = int(visible.any(dim=1).sum())
    n_bytes = (q.numel() + out.numel() + seen_keys * hkv * (dk + dv)) \
        * q.element_size() + 4 * (qp.numel() + kp.numel())
    bms, by = op_bound(2.0 * pairs * (dk + dv), n_bytes,
                       BF16_FLOPS_PER_S if dtype == "bfloat16"
                       else SCALAR_OPS_PER_S)
    lib_ms = None
    if cap == 0.0:               # SDPA has no softcap
        if causal and window is None and not decode and sq == skv:
            lib = lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=dk ** -0.5, enable_gqa=True)
        else:
            amask = ref.attn_mask(qp, kp, causal, window)[:, None] \
                & (kp < VALID_POS_LIMIT)[:, None, None, :]
            lib = lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=amask, scale=dk ** -0.5, enable_gqa=True)
        lib_ms = time_ms(rotating(lib), n, warmup=2)
    warm = {}
    if copies > 1:
        warm = dict(ms_warm=time_ms(lambda: kernel(q, k, v), n, warmup=2),
                    graph_ms_warm=graph_ms(lambda: kernel(q, k, v),
                                           launches=n, replays=3))
    out = dict(case=name, variant=variant, B=b, Sq=sq, Skv=skv, Hq=hq,
               Hkv=hkv, Dk=dk, Dv=dv, causal=causal, window=window,
               softcap=cap, dtype=dtype, copies=copies,
               visible_pairs=pairs, max_abs_err=err,
               max_abs_want=float(want.float().abs().max()), atol=atol,
               rtol=rtol, ms=ms, graph_ms=g_ms, **warm, plain_ms=plain_ms,
               plain_graph_ms=plain_g_ms, bound_ms=bms, bound_by=by,
               library_ms=lib_ms, wall_s=time.perf_counter() - t_start)
    emit("kernel_flash", **out)
    return out


def kernel_flash_phase() -> list:
    cases = [
        flash_case("glm4_prefill", 4, 2048, 2048, 32, 2, 128, 128),
        # 8 caches of 8.5 MB in rotation: L2 cold, as for 40 layers
        flash_case("glm4_decode", 4, 1, 2080, 32, 2, 128, 128, decode=True,
                   copies=8),
    ]
    grid = [   # the reference's test grid (tests/test_kernels.py)
        (2, 128, 128, 4, 2, 32, 32, True, None, 0.0, "float32"),
        (1, 100, 100, 4, 4, 16, 16, True, None, 0.0, "float32"),
        (2, 128, 128, 4, 2, 32, 32, True, 40, 0.0, "float32"),
        (2, 64, 192, 4, 2, 32, 32, True, None, 0.0, "float32"),
        (2, 128, 128, 4, 4, 32, 32, False, None, 0.0, "float32"),
        (2, 128, 128, 8, 2, 64, 64, True, None, 30.0, "bfloat16"),
        (1, 256, 256, 2, 2, 192, 128, True, None, 0.0, "float32"),
        (1, 72, 72, 2, 1, 24, 24, True, 16, 0.0, "float32"),
    ]
    for i, (b, sq, skv, hq, hkv, dk, dv, causal, window, cap,
            dtype) in enumerate(grid):
        cases.append(flash_case(f"grid{i}", b, sq, skv, hq, hkv, dk, dv,
                                causal=causal, window=window, cap=cap,
                                dtype=dtype, seed=i + 1))
    # the edges of the variants (tests/test_torch_cuda.py FLASH_GRID)
    cases += [
        flash_case("tc_ragged", 1, 200, 200, 4, 2, 128, 128, seed=20),
        flash_case("tc_noncausal", 1, 256, 256, 4, 2, 128, 128,
                   causal=False, seed=21),
        flash_case("tc_window", 1, 256, 256, 4, 2, 128, 128, window=64,
                   seed=22),
        flash_case("split_64_rows", 2, 4, 2080, 32, 2, 128, 128, seed=23),
        flash_case("split_one_key", 4, 1, 2080, 32, 2, 128, 128,
                   decode=True, valid0=1, seed=24),
        flash_case("split_f32_d64_window", 2, 1, 1000, 8, 1, 64, 64,
                   window=128, dtype="float32", decode=True, seed=25),
    ]
    return cases


def ssd_inputs(b, s, h, p, n, dtype, seed, with_h0=True) -> tuple:
    """x, dt (softplus'd), a, B, C and h0 (or None) on the card, seeded;
    x, B and C in ``dtype``."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = getattr(torch, dtype)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = (rnd(b, s, h, p) * 0.5).to(td)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    a = -torch.exp(rnd(h) * 0.3)
    bm = (rnd(b, s, 1, n) * 0.4).to(td)
    cm = (rnd(b, s, 1, n) * 0.4).to(td)
    h0 = rnd(b, h, p, n) * 0.1 if with_h0 else None
    return x, dt, a, bm, cm, h0


def ssd_case(name: str, b, s, h, p, n, chunk, *, dtype="float32",
             with_h0=True, seed=0) -> dict:
    """One shape through ``ops.ssd`` on the card (S padded to a multiple
    of the chunk there), held to ``ref.ssd_ref`` on the padded inputs."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ss

    t_start = time.perf_counter()
    td = getattr(torch, dtype)
    x, dt, a, bm, cm, h0 = ssd_inputs(b, s, h, p, n, dtype, seed, with_h0)
    variant = ss.variant(td, p, n, chunk)
    before, by_variant = ss.launches, dict(ss.variant_launches)
    y, f = ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    by_variant[variant] += 1
    check(ss.launches == before + 1 and ss.variant_launches == by_variant,
          f"{name}: SSD kernel variant {variant} did not launch")
    pad = (-s) % chunk
    y_r, f_r = ref.ssd_ref(*(ref.pad_seq(t, pad) for t in (x, dt)), a,
                           *(ref.pad_seq(t, pad) for t in (bm, cm)),
                           chunk=chunk, h0=h0)
    y_r = y_r[:, :s]
    check(bool(torch.isfinite(y).all() and torch.isfinite(f).all()),
          f"{name}: non-finite output")
    err_y = float((y.float() - y_r).abs().max())
    rel = 1e-2 if dtype == "bfloat16" else 2e-5   # bf16 y: one rounding
    check(err_y / (float(y_r.abs().max()) + 1e-9) < rel,
          f"{name}: SSD kernel y disagrees with ref.ssd_ref "
          f"(max abs err {err_y})")
    check(torch.allclose(f, f_r, atol=2e-3, rtol=1e-4),
          f"{name}: SSD kernel final state disagrees with ref.ssd_ref")
    err = max(err_y, float((f - f_r).abs().max()))
    ms, g_ms, _ = timings(lambda: ops.ssd(x, dt, a, bm, cm, chunk=chunk,
                                          h0=h0))
    plain_ms, plain_g_ms, _ = timings(
        lambda: ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0, plain=True))
    sp = s + pad
    nc, tri = sp // chunk, chunk * (chunk + 1) / 2
    per_head = 2 * tri * p + 4 * chunk * p * n + 3 * tri
    flops = b * nc * (2 * tri * n + h * per_head)   # C.B^T once per chunk
    el = x.element_size()
    n_bytes = (2 * x.numel() + bm.numel() + cm.numel()) * el \
        + 4 * (dt.numel() + a.numel() + (2 if with_h0 else 1) * b * h * p * n)
    bms, by = op_bound(flops, n_bytes, BF16_FLOPS_PER_S
                       if dtype == "bfloat16" else SCALAR_OPS_PER_S)
    floor = {}
    if variant == "tc":
        # this design's own work: ssd_state reads x and B and writes the
        # entering states and dacum / dt; ssd_chunk_scan reads them with
        # x, B and C again; the state product runs twice (x hi + lo), and
        # C.B^T is formed per 64 x 64 tile up to the diagonal
        strips = chunk // 64
        tiles = strips * (strips + 1) // 2
        n_hg = -(-h // 8)
        tc_flops = b * nc * (h * (2 * 2 * chunk * p * n + 2 * chunk * p * n
                                  + tiles * 2 * 64 * 64 * p)
                             + n_hg * tiles * 2 * 64 * 64 * n)
        states = b * nc * h * p * n * 2 + b * nc * h * 2 * chunk * 4
        tc_bytes = n_bytes + (x.numel() + bm.numel()) * el + 2 * states
        fms, fby = op_bound(tc_flops, tc_bytes, BF16_FLOPS_PER_S)
        floor = dict(floor_ms=fms, floor_by=fby)
    out = dict(case=name, variant=variant, B=b, S=s, H=h, P=p, N=n,
               chunk=chunk, dtype=dtype, h0=with_h0, max_abs_err=err,
               max_abs_err_y=err_y, max_abs_y=float(y_r.abs().max()), ms=ms,
               graph_ms=g_ms, plain_ms=plain_ms, plain_graph_ms=plain_g_ms,
               bound_ms=bms, bound_by=by, **floor, library_ms=None,
               wall_s=time.perf_counter() - t_start)
    emit("kernel_ssd", **out)
    return out


def ssd_phase_case(b=4, s=2048, h=48, n=128, chunk=256, seed=0) -> None:
    """tc's two kernels one at a time against their plain phases: the
    entering states within one bf16 rounding (rtol 2^-8) over the final
    state's atol 2e-3, the final state at atol 2e-3 / rtol 1e-4, y from
    the kernel's states within 1e-2 of max|y|."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss

    x, dt, a, bm, cm, h0 = ssd_inputs(b, s, h, 64, n, "bfloat16", seed)
    states, meta, final = ss.tc_states(x, dt, a, bm, chunk=chunk, h0=h0)
    y = ss.tc_outputs(x, bm, cm, states, meta, chunk=chunk)
    torch.cuda.synchronize()
    prev, final_r = ref.ssd_states(x, dt, a, bm, chunk, h0=h0)
    y_r = ref.ssd_outputs(x, dt, a, bm, cm, chunk, states.float())
    err_states = float((states.float() - prev).abs().max())
    err_final = float((final - final_r).abs().max())
    err_y = float((y.float() - y_r).abs().max()) / float(y_r.abs().max())
    check(torch.allclose(states.float(), prev, atol=2e-3, rtol=2 ** -8),
          f"ssd_state: entering states differ from ref.ssd_states "
          f"({err_states})")
    check(torch.allclose(final, final_r, atol=2e-3, rtol=1e-4),
          f"ssd_state: final state differs from ref.ssd_states ({err_final})")
    check(err_y < 1e-2, f"ssd_chunk_scan: y differs from ref.ssd_outputs "
          f"({err_y} of max|y|)")
    emit("kernel_ssd_phases", B=b, S=s, H=h, N=n, chunk=chunk,
         max_abs_err_states=err_states, max_abs_err_final=err_final,
         rel_err_y=err_y,
         state_graph_ms=graph_ms(lambda: ss.tc_states(
             x, dt, a, bm, chunk=chunk, h0=h0), launches=20, replays=3),
         chunk_scan_graph_ms=graph_ms(lambda: ss.tc_outputs(
             x, bm, cm, states, meta, chunk=chunk), launches=20, replays=3))


def kernel_ssd_phase() -> list:
    cases = [ssd_case("mamba2_prefill", 4, 2048, 48, 64, 128, 256,
                      dtype="bfloat16")]
    grid = [   # the reference's test grid (tests/test_kernels.py)
        (2, 256, 8, 16, 32, 64), (1, 128, 16, 64, 128, 32),
        (2, 512, 48, 64, 128, 256), (1, 64, 4, 32, 16, 64),
    ]
    for i, (b, s, h, p, n, chunk) in enumerate(grid):
        cases.append(ssd_case(f"grid{i}", b, s, h, p, n, chunk, seed=i + 1))
    for dtype in ("float32", "bfloat16"):   # odd H: one head per block
        cases.append(ssd_case(f"odd_heads_{dtype}", 1, 128, 5, 32, 64, 32,
                              dtype=dtype, seed=9))
    # the edges of tc (tests/test_torch_cuda.py SSD_GRID)
    bf = dict(dtype="bfloat16")
    cases += [
        ssd_case("tc_h5", 1, 512, 5, 64, 128, 256, seed=20, **bf),
        ssd_case("tc_no_h0", 2, 512, 8, 64, 128, 256, with_h0=False,
                 seed=21, **bf),
        ssd_case("tc_ragged", 1, 300, 4, 64, 128, 128, seed=22, **bf),
        ssd_case("tc_chunk64", 2, 256, 6, 64, 128, 64, seed=23, **bf),
        ssd_case("tc_chunk128", 1, 512, 6, 64, 128, 128, seed=24, **bf),
        ssd_case("tc_n64", 2, 512, 4, 64, 64, 256, seed=25, **bf),
        ssd_case("tc_b1", 1, 2048, 48, 64, 128, 256, seed=26, **bf),
    ]
    ssd_phase_case()
    return cases


def kernel_record(name: str, source: str, replaces: str, launches: int,
                  cases: list) -> dict:
    """One entry of the kernels line: the first case's times, the largest
    error over ``cases``."""
    head = cases[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "graph_ms": head["graph_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"]}


def flash_records(cases: list, launches: dict) -> list:
    """One entry per flash variant, timed at its main-path case (glm4-9b
    prefill, glm4-9b decode; simt, which the main path does not reach, at
    the reference grid's first case)."""
    heads = {"prefill_tc": "glm4_prefill", "decode_split": "glm4_decode",
             "simt": "grid0"}
    out = []
    for variant, head in heads.items():
        mine = [c for c in cases if c["variant"] == variant]
        first = [c for c in mine if c["case"] == head]
        check(len(first) == 1, f"flash case {head} did not run {variant}")
        out.append(kernel_record(
            f"flash_attention.{variant}",
            f"src/repro_torch/kernels/csrc/flash_{variant}.cuh",
            "src/repro/kernels/flash_attention.py:90", launches[variant],
            first + [c for c in mine if c["case"] != head]))
    return out


def ssd_records(cases: list, launches: dict) -> list:
    """One entry per SSD variant, timed at its case on the main path
    (mamba2-780m prefill; simt, which the main path does not reach, at
    the reference grid's first case, f32)."""
    heads = {"tc": "mamba2_prefill", "simt": "grid0"}
    out = []
    for variant, head in heads.items():
        mine = [c for c in cases if c["variant"] == variant]
        first = [c for c in mine if c["case"] == head]
        check(len(first) == 1, f"ssd case {head} did not run {variant}")
        out.append(kernel_record(
            f"ssd_scan.{variant}",
            f"src/repro_torch/kernels/csrc/ssd_{variant}.cuh",
            "src/repro/kernels/ssd_scan.py:76", launches[f"ssd_{variant}"],
            first + [c for c in mine if c["case"] != head]))
    return out


# -- phases 8-10: the model stack ----------------------------------------------

def into_ring(ring, prompt_cache):
    """Copy each prompt cache leaf into the leading slice of the ring's."""
    for r, c in zip(ring, prompt_cache):
        for mixer, leaves in r.items():
            for leaf, buf in leaves.items():
                src = c[mixer][leaf]
                buf[tuple(slice(0, d) for d in src.shape)] = src
    return ring


def generate(cfg, ctx, params, prompt, step_tokens, ring_len: int) -> dict:
    """Prefill, move the cache into rings, one decode_step per row of
    ``step_tokens`` with ``[B]`` positions; logits and wall seconds."""
    import torch

    from repro_torch.models import decoder

    dev = prompt.device
    b, s = prompt.shape
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, caches = decoder.prefill(cfg, ctx, params, {"tokens": prompt})
    sync()
    t1 = time.perf_counter()
    ring = into_ring(decoder.init_cache(cfg, b, ring_len,
                                        cfg.compute_dtype(), dev), caches)
    del caches
    sync()
    t2 = time.perf_counter()
    out = [logits]
    for i, tok in enumerate(step_tokens):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        logits, ring = decoder.decode_step(cfg, ctx, params, ring, tok, pos)
        out.append(logits)
    sync()
    t3 = time.perf_counter()
    return dict(logits=out, ring=ring, prefill_s=t1 - t0, decode_s=t3 - t2)


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms (inflated by
    the profiler's host work), device busy ms (the sum of the device ops'
    times; null when the trace holds none), the largest device ops, and
    the device ms of this repo's kernels (names in the ``flash``,
    ``ssd`` and ``lease`` namespaces or files), whatever their rank."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) if rows else None
    ours = [dict(name=n[:90], ms=ms, calls=c) for n, ms, c in rows
            if any(k in n for k in ("flash::", "ssd::", "lease"))]
    return dict(wall_ms=wall, device_busy_ms=busy,
                top=[dict(name=n[:90], ms=ms, calls=c)
                     for n, ms, c in rows[:5]], repo_kernels=ours)


def compare_logits(a: list, b: list) -> dict:
    """Largest difference, its share of the largest reference logit, and
    the share of greedy (argmax) tokens that agree."""
    import torch

    diff = max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(a, b))
    top = max(float(y.float().abs().max()) for y in b)
    agree = torch.cat([(x.float().cpu().argmax(-1)
                        == y.float().cpu().argmax(-1)).float()
                       for x, y in zip(a, b)])
    return dict(max_abs_diff=diff, max_abs_logit=top, rel_diff=diff / top,
                greedy_agree=float(agree.mean()))


def model_phase(phase: str, arch: str, *, batch: int = 4, prompt: int = 2048,
                steps: int = 16, ring: int = 2080, seed: int = 0) -> dict:
    """Full width and depth: "auto" (the kernels) then "ref" on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import common, decoder

    t_start = time.perf_counter()
    cfg = get_config(arch)
    dev = torch.device("cuda")
    params = common.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev, cfg.compute_dtype())
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    step_toks = torch.randint(0, cfg.vocab_size, (steps, batch),
                              generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_start
    kinds = common.layer_plan(cfg).kinds
    n_attn = sum(k.mixer in ("attn", "attn_local") for k in kinds)
    n_mamba = sum(k.mixer == "mamba" for k in kinds)
    runs, path_counts = {}, None
    for use in ("auto", "ref"):
        ctx = decoder.RunCtx(dev, use_kernel=use)
        # untimed, at the same shapes: the allocator's growth, cuBLAS's first
        # calls and the kernel's module load stay out of the timed run
        generate(cfg, ctx, params, toks, step_toks[:2], ring)
        torch.cuda.reset_peak_memory_stats()
        fa.launches = ss.launches = lv.launches = 0    # just before the path
        fa.variant_launches.update(dict.fromkeys(fa.VARIANTS, 0))
        ss.variant_launches.update(dict.fromkeys(ss.VARIANTS, 0))
        run = generate(cfg, ctx, params, toks, step_toks, ring)
        # the SSD variants' keys carry a prefix: flash has a simt too
        counts = dict(flash=fa.launches, ssd=ss.launches, lease=lv.launches,
                      **fa.variant_launches,
                      **{f"ssd_{k}": v for k, v in ss.variant_launches.items()})
        want = (dict(flash=n_attn * (1 + steps), ssd=n_mamba, lease=0,
                     prefill_tc=n_attn, decode_split=n_attn * steps, simt=0,
                     ssd_tc=n_mamba, ssd_simt=0)
                if use == "auto" else
                dict(flash=0, ssd=0, lease=0, prefill_tc=0, decode_split=0,
                     simt=0, ssd_tc=0, ssd_simt=0))
        check(counts == want, f"{phase}/{use}: kernel launches {counts}, "
              f"expected {want}")
        for lg in run["logits"]:
            check(bool(torch.isfinite(lg).all()),
                  f"{phase}/{use}: non-finite logits")
            check(tuple(lg.shape) == (batch, cfg.vocab_size),
                  f"{phase}/{use}: logits shape {tuple(lg.shape)}")
        if use == "auto":   # where the time goes, after the counts are read
            path_counts = counts
            nxt = torch.full((batch,), prompt + steps, dtype=torch.int32,
                             device=dev)
            emit(phase, profile="prefill", **device_profile(
                lambda: decoder.prefill(cfg, ctx, params, {"tokens": toks})))
            emit(phase, profile="decode_step", **device_profile(
                lambda: decoder.decode_step(cfg, ctx, params, run["ring"],
                                            step_toks[0], nxt)))
        del run["ring"]
        runs[use] = run
        emit(phase, use_kernel=use, arch=arch, n_layers=cfg.n_layers,
             d_model=cfg.d_model, params=cfg.param_count(), batch=batch,
             prompt=prompt, steps=steps, ring=ring, launches=counts,
             prefill_s=run["prefill_s"], decode_s=run["decode_s"],
             prefill_tok_s=batch * prompt / run["prefill_s"],
             decode_tok_s=batch * steps / run["decode_s"],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    agree = compare_logits(runs["auto"]["logits"], runs["ref"]["logits"])
    emit(phase, compare="auto_vs_ref", tol_rel=MODEL_TOL, init_s=init_s,
         wall_s=time.perf_counter() - t_start, **agree)
    check(agree["rel_diff"] <= MODEL_TOL,
          f"{phase}: kernel and plain logits differ by {agree['rel_diff']} "
          f"of the largest logit (limit {MODEL_TOL})")
    del params, runs
    torch.cuda.empty_cache()
    return path_counts


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def held_phase(*, batch: int = 2, prompt: int = 64, steps: int = 4,
               seed: int = 3) -> None:
    """Full width, 2 layers: the port on cuda against the port on cpu."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import common, decoder

    for arch in ("glm4-9b", "mamba2-780m"):
        t_start = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        dev = torch.device("cuda")
        on_card = common.init_params(cfg, torch.Generator(
            device=dev).manual_seed(seed), dev, cfg.compute_dtype())
        on_cpu = to_cpu(on_card)
        gen = torch.Generator().manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                             generator=gen)
        step_toks = torch.randint(0, cfg.vocab_size, (steps, batch),
                                  generator=gen)
        fa.launches = ss.launches = 0
        card = generate(cfg, decoder.RunCtx(dev), on_card, toks.to(dev),
                        step_toks.to(dev), prompt + 8)
        launched = fa.launches + ss.launches
        check(launched > 0, f"held/{arch}: no kernel launched on the card")
        host = generate(cfg, decoder.RunCtx("cpu"), on_cpu, toks, step_toks,
                        prompt + 8)
        agree = compare_logits(card["logits"], host["logits"])
        for x, y in zip(card["logits"], host["logits"]):
            check(torch.allclose(x.float().cpu(), y.float(), atol=HELD_TOL,
                                 rtol=HELD_TOL),
                  f"held/{arch}: cuda and cpu logits differ "
                  f"({agree['max_abs_diff']})")
        emit("held", arch=arch, n_layers=2, d_model=cfg.d_model,
             batch=batch, prompt=prompt, steps=steps, launches=launched,
             tol=HELD_TOL, cuda_s=card["prefill_s"] + card["decode_s"],
             cpu_s=host["prefill_s"] + host["decode_s"],
             wall_s=time.perf_counter() - t_start, **agree)
        del on_card, on_cpu
        torch.cuda.empty_cache()


# -- phases 11-14: serving, the placement planner --------------------------

# benchmarks/serve_locality.py's (policy, arbitration) grid and localities
SERVE_GRID = [("local", "steps"), ("short", "steps"), ("short", "priced"),
              ("short", "hybrid"), ("long", "steps"), ("long", "priced"),
              ("long", "hybrid")]
SERVE_LOCALITIES = (0.0, 0.5, 0.9)
PLAN_LOCALITIES = (0.0, 0.7, 0.9)      # benchmarks/planner.py's
SEEDS = (0, 1, 2)
SERVE_CELLS = [(policy, arb, loc, seed) for policy, arb in SERVE_GRID
               for loc in SERVE_LOCALITIES for seed in SEEDS]


def same_result(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in ("point", "metrics", "router"))


def serve_runs(device: str, jax_min: int) -> tuple:
    """Every serve cell on ``device``, drains counted; (results, stats,
    lease launches, wall s)."""
    import torch

    import repro_torch.serve.certifier as certifier_mod
    from repro_torch.launch.serve import run_point

    t0 = time.perf_counter()
    reset_launches()                    # just before the path
    with DrainStats(certifier_mod) as stats:
        out = [run_point("mixtral-8x7b", policy, loc, seed=seed,
                         arbitration=arb, device=device, jax_min=jax_min)
               for policy, arb, loc, seed in SERVE_CELLS]
        if device == "cuda":
            torch.cuda.synchronize()
    return out, stats, lease_launches(), time.perf_counter() - t0


def serve_phase() -> dict:
    """The serving path at serve_locality's defaults (mixtral-8x7b KV
    sizes, 8 pods, 256 sessions, 80 steps): every GRID pair x locality x
    seed on cuda and on cpu, identical; then the same with every
    certification batch packed (``jax_min=1``), where each batch must
    launch ``drain`` once and ``gather`` never.  Returns the card's drain
    launches of the ``jax_min=1`` runs."""
    launched = {}
    for jax_min in (8, 1):
        card, stats, launches, card_s = serve_runs("cuda", jax_min)
        host, _, _, cpu_s = serve_runs("cpu", jax_min)
        for i, (a, b) in enumerate(zip(card, host)):
            check(same_result(a, b), f"serve (jax_min {jax_min}): run {i} "
                  f"differs between cuda and cpu")
        batches = sum(r["metrics"]["cert_batches"] for r in card)
        check(launches["drain"] == stats.drains == launches["all"],
              f"serve: {launches['drain']} drain launches for "
              f"{stats.drains} packed batches")
        check(launches["gather"] == 0,
              f"serve: gather launched {launches['gather']} times")
        if jax_min == 1:
            check(stats.drains == batches > 0,
                  f"serve: {stats.drains} packed batches for {batches} "
                  f"certification batches")
        launched[jax_min] = launches["drain"]
        by_loc = {loc: [r["point"] for r, cell in zip(card, SERVE_CELLS)
                        if cell[2] == loc] for loc in SERVE_LOCALITIES}
        emit("serve", jax_min=jax_min, runs=len(card), cert_batches=batches,
             certified=sum(r["metrics"]["certified"] for r in card),
             cert_aborts=sum(r["metrics"]["cert_aborts"] for r in card),
             cert_max_batch=max(r["metrics"]["cert_max_batch"] for r in card),
             kernel_drains=stats.drains, kernel_txns=stats.txns,
             variant_launches={k: v for k, v in launches.items()
                               if k != "all"},
             drain_plans=stats.plans, largest_B=stats.largest["B"],
             largest_n_dirty=stats.largest["n_dirty"],
             validate_s=stats.validate_s, cuda_s=card_s, cpu_s=cpu_s,
             # simulated: a priced TPU pod, not the card's speed
             sim_tokens_per_s_mean={str(loc): float(np.mean(
                 [p["tokens_per_s"] for p in pts]))
                 for loc, pts in by_loc.items()},
             wire_GB_mean={str(loc): float(np.mean(
                 [p["wire_GB"] for p in pts])) for loc, pts in by_loc.items()})
    return launched


def serve_plan_phase() -> None:
    """benchmarks/planner.py's sweep with the planner on (8 pods, 96
    sessions, 160 steps, SERVE_PLAN_DEFAULTS, ROUTER_DEFAULTS), with
    asynchronous plan epochs (the engine's default, scored on a side
    stream on the card) and synchronous ones: cuda identical to cpu in
    each mode; plan_moves > 0 at locality 0.9.  The two modes differ from
    each other by design (an async epoch's moves land one step later), as
    in the reference; the cells where they do are printed."""
    from repro_torch.dist.locality import ROUTER_DEFAULTS
    from repro_torch.launch.serve import run_point
    from repro_torch.plan import SERVE_PLAN_DEFAULTS

    cells = [(loc, seed) for loc in PLAN_LOCALITIES for seed in SEEDS]
    runs, wall = {}, {}
    for mode, plan_async in (("async", True), ("sync", False)):
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[f"{device}_{mode}"] = [run_point(
                "mixtral-8x7b", ROUTER_DEFAULTS.policy, loc, n_sessions=96,
                steps=160, seed=seed,
                arbitration=ROUTER_DEFAULTS.arbitration,
                plan_epoch_ms=SERVE_PLAN_DEFAULTS.epoch_ms, device=device,
                plan_async=plan_async) for loc, seed in cells]
            wall[f"{device}_{mode}"] = time.perf_counter() - t0
        for i, (a, b) in enumerate(zip(runs[f"cuda_{mode}"],
                                       runs[f"cpu_{mode}"])):
            check(same_result(a, b), f"serve_plan ({mode}): run {i} differs "
                  f"between cuda and cpu")
        hi = [r["point"]["plan_moves"] for r, (loc, _) in
              zip(runs[f"cuda_{mode}"], cells) if loc == 0.9]
        check(sum(hi) > 0, f"serve_plan ({mode}): no planned move at "
              f"locality 0.9")
    # the serving entry point itself, planner on: cuda against cpu
    from repro_torch.launch.serve import main as serve_main

    argv = ["--arch", "mixtral-8x7b", "--preset", "full", "--pods", "8",
            "--sessions", "96", "--requests", "2000", "--plan-epoch-ms", "5"]
    with contextlib.redirect_stdout(io.StringIO()):   # its report lines
        launched = [serve_main(argv + ["--device", d])
                    for d in ("cuda", "cpu")]
    for m in launched:
        check(m.pop("plan_block_s") >= 0.0, "launch.serve: plan_block_s < 0")
    check(launched[0] == launched[1],
          "launch.serve: the cuda run differs from the cpu run")
    emit("serve_plan", runs=len(cells),
         launch_serve={k: launched[0][k] for k in (
             "tokens", "forwards", "transfers", "plan_epochs", "plan_moves")},
         plan_epochs=sum(r["metrics"]["plan_epochs"]
                         for r in runs["cuda_async"]),
         points={f"{loc}/{seed}": r["point"] for r, (loc, seed) in
                 zip(runs["cuda_async"], cells)},
         async_differs_from_sync=[
             f"{loc}/{seed}" for a, b, (loc, seed) in
             zip(runs["cuda_async"], runs["cuda_sync"], cells)
             if not same_result(a, b)],
         plan_block_s={k: sum(r["plan_block_s"] for r in v)
                       for k, v in runs.items()},
         wall_s=wall)


def plan_score_phase(reps: int = 20) -> dict:
    """The scorer at the planner bench's overlap shape (2^17 classes x 16
    nodes) on the card: bitwise equal to ``score_moves_np`` (the overlap
    cell's knobs, and a looser dominance share so that many scores are
    finite); then, as ``benchmarks/planner.py::overlap_cell`` times it,
    sync ms (dispatch + wait), kick ms and harvest ms around host work
    standing in for decode steps, the CPU's torch and numpy times, and the
    bound: the inputs' and the output's bytes at 3.35 TB/s."""
    from repro_torch.plan.score import (score_moves, score_moves_async,
                                        score_moves_np)

    n_classes, n_nodes = 1 << 17, 16
    rng = np.random.default_rng(0)
    rates = (rng.random((n_classes, n_nodes)) * 0.05).astype(np.float32)
    owner = rng.integers(0, n_nodes, n_classes).astype(np.int32)
    fwd_cost = np.full(n_classes, 2e-4, np.float32)
    move_cost = np.full(n_classes, 1e-3, np.float32)
    cpu = (rng.random(n_nodes) * 0.5).astype(np.float64)
    args = (rates, owner, fwd_cost, move_cost, cpu)
    kw = dict(horizon_ms=500.0, margin=3.0, min_frac=0.7, min_rate=0.016,
              load_gain=0.02)
    finite = {}
    for label, knobs in (("overlap", kw), ("loose", dict(kw, min_frac=0.07,
                                                         min_rate=0.0))):
        want = score_moves_np(*args, **knobs)
        got = score_moves(*args, device="cuda", **knobs)
        check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
              f"plan_score/{label}: {int((got.view(np.uint32) != want.view(np.uint32)).sum())} "
              f"scores differ from score_moves_np in their bits")
        finite[label] = int(np.isfinite(want).sum())
    decode = [np.ones(1 << 20) for _ in range(2)]

    def decode_steps(n: int = 12) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            decode[0] = decode[0] + decode[1]
        return time.perf_counter() - t0

    t = dict(sync=0.0, kick=0.0, harvest=0.0, decode=0.0, cpu_torch=0.0,
             numpy=0.0)
    for _ in range(reps):
        t0 = time.perf_counter()
        score_moves(*args, device="cuda", **kw)
        t["sync"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        fut = score_moves_async(*args, device="cuda", **kw)
        t["kick"] += time.perf_counter() - t0
        t["decode"] += decode_steps()
        t0 = time.perf_counter()
        fut.wait()
        t["harvest"] += time.perf_counter() - t0
    for _ in range(max(3, reps // 4)):
        t0 = time.perf_counter()
        score_moves(*args, device="cpu", **kw)
        t["cpu_torch"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        score_moves_np(*args, **kw)
        t["numpy"] += time.perf_counter() - t0
    ms = {f"{k}_ms": v * 1e3 / (reps if k in ("sync", "kick", "harvest",
                                               "decode") else max(3, reps // 4))
          for k, v in t.items()}
    n_bytes = 4 * (2 * rates.size + 3 * n_classes + n_nodes)
    out = dict(n_classes=n_classes, n_nodes=n_nodes, reps=reps,
               finite=finite, **ms,
               off_path_frac=1.0 - (ms["kick_ms"] + ms["harvest_ms"])
               / max(ms["sync_ms"], 1e-9),
               bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    emit("plan_score", **out)
    return out


def sim_plan_phase(main_cfg: dict) -> dict:
    """The main TPC-C run with the planner on (``SIM_PLAN_DEFAULTS``), on
    cuda and on cpu: byte-identical stores and metrics, planner epochs and
    prefetches issued, every drain through ``drain``."""
    from repro_torch.plan import SIM_PLAN_DEFAULTS

    cfg = dict(main_cfg, plan=SIM_PLAN_DEFAULTS)
    card = run_cluster("tpcc", "cuda", cfg)
    m = card["metrics"]
    emit("sim_plan", device="cuda", plan_epochs=m["plan_epochs"],
         plan_prefetches=m["plan_prefetches"], **summary(card))
    check_drains("sim_plan", card)
    check(m["plan_epochs"] > 0 and m["plan_prefetches"] > 0,
          f"sim_plan: {m['plan_epochs']} epochs, {m['plan_prefetches']} "
          f"prefetches")
    host = run_cluster("tpcc", "cpu", cfg)
    emit("sim_plan", device="cpu", **summary(host))
    compare_runs("sim_plan", card, host)
    return card


def serve_drain_case(rng, n: int, b: int, n_dirty: int) -> dict:
    """The drain kernel at the serving certifier's shape: B forwards (the
    row count bucketed as ``pack_drain`` does) each reading one session
    (R bucketed to 8), W = 0 and no class view, an n-entry epoch table
    and n_dirty pending epoch stamps; bitwise against
    ``ref.lease_drain_ref`` on ok and on the flushed table, timed like
    ``drain_case``."""
    import torch

    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bp, r = max(8, 1 << (b - 1).bit_length()), 8
    table = rng.integers(0, 1000, n).astype(np.int32)
    dirty = rng.choice(n, n_dirty, replace=False).astype(np.int32)
    dirty_ver = (table[dirty] + 1).astype(np.int32)
    items = np.full((bp, r), -1, np.int32)
    items[:b, 0] = rng.choice(np.concatenate([dirty, rng.integers(0, n, b)]),
                              b)
    flushed = table.copy()
    flushed[dirty] = dirty_ver
    vers = np.zeros((bp, r), np.int32)
    vers[:b, 0] = np.where(rng.random(b) < 0.8, flushed[items[:b, 0]],
                           table[items[:b, 0]])
    staging = lv.DrainStaging(dev)
    v = staging.begin(n_dirty, bp, r, 0, 0, 0)
    v.dirty_idx[:] = dirty
    v.dirty_ver[:] = dirty_ver
    v.read_items[:] = items
    v.read_versions[:] = vers
    on = {k: torch.from_numpy(a).to(dev) for k, a in (
        ("dirty_idx", dirty), ("dirty_ver", dirty_ver), ("items", items),
        ("vers", vers))}
    want_table = torch.from_numpy(table).to(dev)
    plain = lambda: ref.lease_drain_ref(
        want_table, on["dirty_idx"], on["dirty_ver"], None, None, 0,
        on["items"], on["vers"], None)
    want = plain().cpu().numpy()
    dev_table = torch.from_numpy(table).to(dev)
    before = lv.launches
    got = lv.lease_drain(dev_table, staging, None).copy()
    check(np.array_equal(got, want), f"serve drain B{b}: ok disagrees with "
          f"ref.lease_drain_ref ({int((got != want).sum())} rows)")
    check(torch.equal(dev_table, want_table),
          f"serve drain B{b}: flushed another table than the twin")
    kernel = lambda: lv.lease_drain(dev_table, staging, None)
    n_bytes = 8 * n_dirty + 8 * bp * r + 4 * b + 4 * n_dirty + bp
    out = dict(case=f"serve_B{b}", n_items=n, B=bp, R=r, W=0, n_classes=0,
               n_dirty=n_dirty, passing=int(want[:b].sum()),
               max_abs_err=int(np.abs(got.astype(np.int32)
                                      - want.astype(np.int32)).max()),
               ms=wall_us(kernel, 2000) / 1e3,
               graph_ms=graph_ms(lambda: lv.lease_drain(
                   dev_table, staging, None, wait=False)),
               plain_ms=time_ms(plain, 500), plain_graph_ms=graph_ms(plain),
               bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None, calls=lv.launches - before)
    emit("kernel_drain", **out)
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    # 1. env
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    emit("env", device=name, count=count, nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: one nvcc per kernel, all at once
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import nvcc
    from repro_torch.kernels import ssd_scan as ss

    t0 = time.perf_counter()
    nvcc.build_all([lv.LIB, fa.LIB, ss.LIB])
    emit("build", wall_s=time.perf_counter() - t0, **lv.LIB.info,
         flash_attention=fa.LIB.info, ssd_scan=ss.LIB.info)

    # 3. kernel vs plain version
    rng = np.random.default_rng(0)
    n_main = 1_140_088
    main_cases = [kernel_case(f"main_B{b}", rng, n_main, b, 32, 16, 2000)
                  for b in (8, 16)]
    kernel_case("main_B16_lockfree", rng, n_main, 16, 32, 1, 2000,
                lock_free=True)
    kernel_case("wide", rng, 1 << 20, 1024, 256, 64, 200)

    # 3b. the drain against its twin, and a drain's routes timed
    drain_cases, item_cc, n_classes = kernel_drain_phase()

    # 4. main path: TPC-C at spec cardinalities, cuda then cpu
    main_cfg = dict(threads_per_node=16, certify_window_ms=0.5,
                    duration_ms=300.0, warmup_ms=45.0, seed=0)
    card = run_cluster("tpcc", "cuda", main_cfg)
    main_launches = card["launches"]
    emit("main", device="cuda", **summary(card))
    check_drains("main", card)
    host = run_cluster("tpcc", "cpu", main_cfg)
    emit("main", device="cpu", **summary(host))
    compare_runs("main", card, host)
    check(card["kernel_txns"] == host["kernel_txns"],
          "main: batched certification volume differs between cuda and cpu")

    # 5. forced path: every drain and settle on the device
    forced_cfg = dict(certify_jax_min=1, lease_jax_min=1,
                      cert_slot_mode="per_txn")
    card = run_cluster("bank", "cuda", forced_cfg, fail_at=120.0)
    emit("forced", device="cuda", **summary(card))
    check_drains("forced", card)
    host = run_cluster("bank", "cpu", forced_cfg, fail_at=120.0)
    emit("forced", device="cpu", **summary(host))
    compare_runs("forced", card, host)

    # 5b. device operations per drain of the two card routes, profiled
    for b in (8, 16):
        drain_routes(np.random.default_rng(4), item_cc, n_classes, b, 0,
                     profile=True)

    # 6-7. the model kernels against their plain versions
    t0 = time.perf_counter()
    flash_cases = kernel_flash_phase()
    emit("kernel_flash_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    ssd_cases = kernel_ssd_phase()
    emit("kernel_ssd_done", wall_s=time.perf_counter() - t0)

    # 8-9. the model stack at full width and depth
    glm4 = model_phase("glm4", "glm4-9b")
    mamba2 = model_phase("mamba2", "mamba2-780m")

    # 10. the card against the CPU port
    held_phase()

    # 11-14. serving on SimBackend and the placement planner
    t0 = time.perf_counter()
    serve_launches = serve_phase()
    emit("serve_done", wall_s=time.perf_counter() - t0)
    rng = np.random.default_rng(5)
    serve_cases = [serve_drain_case(rng, 256, b, d)
                   for b, d in ((4, 16), (6, 160))]
    t0 = time.perf_counter()
    serve_plan_phase()
    emit("serve_plan_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    plan_score_phase()
    emit("plan_score_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    sim_plan = sim_plan_phase(main_cfg)
    emit("sim_plan_done", wall_s=time.perf_counter() - t0)
    drain_paths = {"main": main_launches["drain"],
                   "serve_jax_min_1": serve_launches[1],
                   "serve_jax_min_8": serve_launches[8],
                   "sim_plan": sim_plan["launches"]["drain"]}

    lease = "src/repro_torch/kernels/csrc/lease_validate.cu"
    lease_tpu = "src/repro/kernels/lease_validate.py:70"
    print(smi_line, flush=True)
    print(json.dumps({"kernels": [
        # main_cases[1]: B = 16, R = 32, W = 16; drain_cases[1] the same
        kernel_record("lease_validate.gather", lease, lease_tpu,
                      main_launches["gather"],
                      [dict(main_cases[1], library_ms=None), *main_cases]),
        dict(kernel_record("lease_validate.drain", lease, lease_tpu,
                           sum(drain_paths.values()),
                           [drain_cases[1], *drain_cases, *serve_cases]),
             launches_by_path=drain_paths),
        *flash_records(flash_cases, glm4), *ssd_records(ssd_cases, mamba2),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
