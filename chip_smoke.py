#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env    — card name, card count, ``nvidia-smi`` name and power limit.
            No card: exit 1 before anything else.
2. build  — ``nvcc`` builds the ``lease_validate`` kernel from
            ``src/repro_torch/kernels/csrc``; wall seconds and the ptxas
            report (registers, shared memory, spills).
3. kernel — the kernel against its plain PyTorch version, bitwise, at the
            simulator's shapes (1,140,088 items, B in {8, 16}, R = 32,
            W = 16, plus a lock-free W = 1 case) and at a wide shape
            (B = 1024, R = 256, W = 64, 2^20 items).  ``ms`` is the time
            per call as a caller sees it (CUDA events around many calls,
            host launch cost included), ``graph_ms`` the device time per
            call (many calls replayed from one CUDA graph); the bound is
            the bytes at 3.35 TB/s; ``launches`` counts the kernel calls
            the case made (check, timing and graph capture).
4. main   — the Lilac-TM commit path: LILAC-TM-ST on TPC-C at the TPC-C
            specification's cardinalities (8 warehouses, 1,140,088 items,
            version tables on the card), 300 ms of simulated time.  The
            kernel must have launched; the same run on the CPU must give
            byte-identical replica stores and identical metrics.
5. forced — Bank at SimConfig defaults with every drain through the kernel
            and every lease settle through the device ops, a node failure
            at 120 ms; cuda against cpu, byte-identical.

The last three lines are the ``nvidia-smi`` line, the kernels record, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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


# -- phases 4-5: the simulator on cuda and on cpu ----------------------------

def run_cluster(workload: str, device: str, cfg_kw: dict, fail_at=None):
    import torch

    import repro_torch.core as T
    import repro_torch.core.cluster as cluster_mod

    certified = [0]
    plain_validate_batch = cluster_mod.validate_batch

    def counting_validate_batch(store, txns, locks=None):
        certified[0] += len(txns)
        return plain_validate_batch(store, txns, locks=locks)

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
    cluster_mod.validate_batch = counting_validate_batch
    try:
        m = c.run()
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        cluster_mod.validate_batch = plain_validate_batch
    t2 = time.perf_counter()
    for r in c.replicas:
        mirror = r.store.device_versions().cpu().numpy()
        check(np.array_equal(mirror, r.store.versions.astype(np.int32)),
              f"{workload}/{device}: device version table of replica "
              f"{r.node} differs from its host versions")
    state = [(r.store.values.tobytes(), r.store.versions.tobytes())
             for r in c.replicas]
    return dict(metrics=dataclasses.asdict(m), state=state,
                kernel_txns=certified[0], build_s=t1 - t0, run_s=t2 - t1,
                n_items=cfg.n_items)


def compare_runs(phase: str, on_card: dict, on_cpu: dict) -> None:
    check(on_card["state"] == on_cpu["state"],
          f"{phase}: replica stores differ between cuda and cpu")
    check(on_card["metrics"] == on_cpu["metrics"],
          f"{phase}: metrics differ between cuda and cpu")


def summary(run: dict, launches: int) -> dict:
    m = run["metrics"]
    return dict(n_items=run["n_items"], commits=m["commits"],
                aborts=m["aborts"], forwards=m["forwards"],
                cert_batches=m["cert_batches"],
                kernel_launches=launches, kernel_txns=run["kernel_txns"],
                build_s=run["build_s"], run_s=run["run_s"])


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

    # 2. build
    from repro_torch.kernels import lease_validate as lv

    t0 = time.perf_counter()
    lv.build()
    emit("build", wall_s=time.perf_counter() - t0, **lv.build_info)

    # 3. kernel vs plain version
    rng = np.random.default_rng(0)
    n_main = 1_140_088
    main_cases = [kernel_case(f"main_B{b}", rng, n_main, b, 32, 16, 2000)
                  for b in (8, 16)]
    kernel_case("main_B16_lockfree", rng, n_main, 16, 32, 1, 2000,
                lock_free=True)
    kernel_case("wide", rng, 1 << 20, 1024, 256, 64, 200)

    # 4. main path: TPC-C at spec cardinalities, cuda then cpu
    main_cfg = dict(threads_per_node=16, certify_window_ms=0.5,
                    duration_ms=300.0, warmup_ms=45.0, seed=0)
    lv.launches = 0
    card = run_cluster("tpcc", "cuda", main_cfg)
    main_launches = lv.launches
    check(main_launches > 0, "main path never launched lease_validate")
    emit("main", device="cuda", **summary(card, main_launches))
    host = run_cluster("tpcc", "cpu", main_cfg)
    emit("main", device="cpu", **summary(host, 0))
    compare_runs("main", card, host)
    check(card["kernel_txns"] == host["kernel_txns"],
          "main: batched certification volume differs between cuda and cpu")

    # 5. forced path: every drain and settle on the device
    forced_cfg = dict(certify_jax_min=1, lease_jax_min=1,
                      cert_slot_mode="per_txn")
    lv.launches = 0
    card = run_cluster("bank", "cuda", forced_cfg, fail_at=120.0)
    forced_launches = lv.launches
    check(forced_launches > 0, "forced path never launched lease_validate")
    emit("forced", device="cuda", **summary(card, forced_launches))
    host = run_cluster("bank", "cpu", forced_cfg, fail_at=120.0)
    emit("forced", device="cpu", **summary(host, 0))
    compare_runs("forced", card, host)

    shape = main_cases[1]          # B = 16, R = 32, W = 16
    print(smi_line, flush=True)
    print(json.dumps({"kernels": [{
        "name": "lease_validate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lease_validate.cu",
        "replaces": "src/repro/kernels/lease_validate.py:70",
        "launches": main_launches,
        "max_abs_err": max(c["max_abs_err"] for c in main_cases),
        "ms": shape["ms"],
        "plain_ms": shape["plain_ms"],
        "bound_ms": shape["bound_ms"],
        "bound_by": shape["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
