"""Batched move scoring — every [class, target-node] candidate in one pass.

A candidate move relocates conflict class (or session) ``c``'s lease to
node ``n``.  Its score is the *expected forward time saved over a horizon*
minus the *one-time migration cost*:

    score[c, n] = (adv + load + co) · horizon_ms · fwd_cost[c]
                  − margin · move_cost[c]

* ``adv``  — A[c, n] − A[c, owner[c]]: the affinity-rate advantage of the
  target over the current owner (accesses/ms that stop being forwards);
* ``load`` — ``load_gain · max(0, cpu[owner] − cpu[n])``: proactive
  rebalancing pressure away from hot owners;
* ``co``   — ``co_gain ·`` co-access rate delta toward nodes owning the
  class's co-accessed classes (multi-class footprints commit in one
  piggyback when they land together).

Infeasible candidates are masked to −inf: the no-op ``n == owner[c]``,
unowned classes, targets violating the DTD's CPU constraint (3), targets
below the ``min_frac`` dominance share, and classes whose total affinity
rate is below ``min_rate``.

The reference evaluates this as one jit'd XLA computation (no Pallas
kernel); the port evaluates it as eager torch ops on the planner's device
(:func:`score_moves_async`).  Each op rounds once, in the association
order of the numpy twin :func:`score_moves_np`, and the row totals are
summed in numpy's own pairwise order (:func:`_row_sum`), so the port's
scores equal ``score_moves_np``'s bit for bit on the CPU and on the card.
The co-location term is a float64 matmul on the host, as in both of the
reference's forms.  On the card the inputs travel in one pinned buffer and
the evaluation runs on a side stream: :func:`score_moves_async` returns a
:class:`PendingScores` whose :meth:`~PendingScores.wait` blocks on that
stream's event alone.  Costs come from the byte model the router prices
with: :func:`price_move_costs` is the array twin of
:func:`repro_torch.dist.locality.price_session_dispatch`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..dist.locality import DCN_BW, DCN_RTT_S
from ..dist.sharding import PLAN_AXIS, plan_score_shardings

NEG_INF = float("-inf")
_PAIRWISE_BLOCK = 128         # numpy's PW_BLOCKSIZE


def price_move_costs(
    state_bytes,
    work_bytes,
    *,
    handoff_bytes: float = 512.0,
    dcn_bw: float = DCN_BW,
    rtt_s: float = DCN_RTT_S,
    seq_shards: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Array twin of ``price_session_dispatch``: per-class plan times.

    Returns ``(fwd_cost_s, move_cost_s)`` — the per-access forward time and
    the one-time state-migration time of every class, elementwise equal to
    ``price_session_dispatch(...).migrate_work_s`` / ``.migrate_state_s``
    for the same inputs (tests pin the parity).  float32 out: these feed
    the float32 scorer directly.
    """
    seq_shards = max(1.0, float(seq_shards))
    state_bytes = np.asarray(state_bytes, dtype=np.float64)
    work_bytes = np.asarray(work_bytes, dtype=np.float64)
    fwd_cost_s = rtt_s + work_bytes / dcn_bw
    move_cost_s = rtt_s + (state_bytes / seq_shards + handoff_bytes) / dcn_bw
    return (fwd_cost_s.astype(np.float32), move_cost_s.astype(np.float32))


def _row_sum(a: torch.Tensor) -> torch.Tensor:
    """Row sums of a float32 ``[C, N]`` tensor in the order numpy's
    ``a.sum(axis=1)`` adds them (its pairwise summation): below 8 columns
    one running sum from zero; up to 128, eight running sums combined as a
    tree and the remainder added in order; above, the halves (cut at a
    multiple of 8) summed alike and added."""
    c, n = a.shape
    if n < 8:
        s = torch.zeros((c,), dtype=a.dtype, device=a.device)
        for j in range(n):
            s = s + a[:, j]
        return s
    if n <= _PAIRWISE_BLOCK:
        m = n - n % 8
        r = a[:, :8]
        for i in range(8, m, 8):
            r = r + a[:, i:i + 8]
        s = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) \
            + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
        for i in range(m, n):
            s = s + a[:, i]
        return s
    half = n // 2
    half -= half % 8
    return _row_sum(a[:, :half]) + _row_sum(a[:, half:])


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float: torch converts it to a
    float32 tensor's dtype without a further rounding."""
    return float(np.float32(x))


def _score(rates, owner, fwd_cost, move_cost, cpu, co_adv, *, horizon_ms,
           margin, min_frac, min_rate, load_gain, co_gain, max_cpu,
           overload_ctrl) -> torch.Tensor:
    """The scores as torch ops, op for op :func:`score_moves_np`."""
    c, n = rates.shape
    dev = rates.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    owned = owner >= 0
    safe = owner.clamp(0, n - 1).long()
    own_rate = torch.where(owned, rates.gather(1, safe[:, None])[:, 0], zero)
    adv = rates - own_rate[:, None]
    own_cpu = torch.where(owned, cpu[safe], zero)
    load = _f32(load_gain) * torch.clamp_min(
        own_cpu[:, None] - cpu[None, :], 0.0)
    # numpy adds co_gain · co_adv even when co_adv is all zeros: adding the
    # scalar product keeps the sign of a zero sum as it does
    co = _f32(co_gain) * (co_adv if co_adv is not None else 0.0)
    benefit = ((adv + load) + co) * _f32(horizon_ms) * fwd_cost[:, None]
    score = benefit - _f32(margin) * move_cost[:, None]
    is_owner = torch.arange(n, device=dev)[None, :] == owner[:, None]
    total = _row_sum(rates)[:, None]
    dominant = (rates >= _f32(min_frac) * total) \
        & (total >= _f32(min_rate))
    mask = ~is_owner & owned[:, None] & dominant
    if overload_ctrl:
        mask &= (cpu < _f32(max_cpu))[None, :]
    return torch.where(mask, score, torch.full_like(score, NEG_INF))


def _co_adv(co_rates, owner: np.ndarray, n: int) -> np.ndarray:
    """Co-location advantage ``[C, N]`` (float32), on the host as in both
    of the reference's forms: co-access mass owned at the target minus at
    the current owner, one float64 matmul."""
    onehot = (owner[:, None] == np.arange(n)[None, :]).astype(np.float64)
    m = np.asarray(co_rates, dtype=np.float64) @ onehot
    at_owner = np.where(owner >= 0,
                        np.take_along_axis(
                            m, np.clip(owner, 0, n - 1)[:, None], axis=1)[:, 0],
                        0.0)
    return (m - at_owner[:, None]).astype(np.float32)


class PendingScores:
    """Scores dispatched by :func:`score_moves_async`, maybe still running.

    :meth:`wait` blocks on the evaluation's own event only and returns the
    ``[C, N]`` float32 scores.  Until then the pending object holds the
    pinned input buffer and the device tensors, so nothing the side stream
    reads or writes is freed under it.
    """

    def __init__(self, host: torch.Tensor, event=None, keep=()) -> None:
        self._host = host
        self._event = event
        self._keep = keep

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._keep = ()
        return self._host.numpy()


def score_moves_async(
    rates: np.ndarray,
    owner: np.ndarray,
    fwd_cost: np.ndarray,
    move_cost: np.ndarray,
    cpu: np.ndarray,
    *,
    horizon_ms: float,
    margin: float = 1.0,
    min_frac: float = 0.0,
    min_rate: float = 0.0,
    load_gain: float = 0.0,
    co_gain: float = 0.0,
    co_rates: Optional[np.ndarray] = None,
    max_cpu: float = 0.9,
    overload_ctrl: bool = True,
    device="cuda",
    mesh=None,
) -> PendingScores:
    """Dispatch the [class, target] scoring and return WITHOUT waiting.

    On ``cuda`` every input is packed into one pinned host buffer, copied
    to the card and scored on a side stream, and the scores are copied back
    into pinned memory on that stream behind an event: the caller keeps
    doing host work (decode steps) while the card evaluates, and pays the
    wait only at :meth:`PendingScores.wait` — the harvest half of the
    planner's overlapped epochs.  On ``cpu`` the evaluation runs here and
    the result is ready at once.  Both equal :func:`score_moves_np` bit for
    bit.

    ``mesh`` (a plan mesh, :func:`repro_torch.dist.sharding.make_plan_mesh`)
    splits the class axis over its ranks: each scores its block of rows
    and the blocks are all-gathered back, so every rank holds the whole
    matrix at once (a row's score does not depend on the other rows, so
    the result is the same bits).  A class count that does not divide over
    the mesh is scored unsharded, as the reference falls back.
    """
    dev = resolve_device(device)
    rates = np.asarray(rates, dtype=np.float32)
    c, n = rates.shape
    owner = np.asarray(owner, dtype=np.int32)
    co_adv = (_co_adv(co_rates, owner, n)
              if co_rates is not None and co_gain != 0.0 else None)
    if mesh is not None and plan_score_shardings(mesh, c) is not None:
        return _score_sharded(mesh, dev, rates, owner, fwd_cost, move_cost,
                              cpu, co_adv, horizon_ms=horizon_ms,
                              margin=margin, min_frac=min_frac,
                              min_rate=min_rate, load_gain=load_gain,
                              co_gain=co_gain, max_cpu=max_cpu,
                              overload_ctrl=overload_ctrl)
    parts = [rates.reshape(-1), owner,
             np.asarray(fwd_cost, dtype=np.float32).reshape(-1),
             np.asarray(move_cost, dtype=np.float32).reshape(-1),
             np.asarray(cpu, dtype=np.float32).reshape(-1)]
    if co_adv is not None:
        parts.append(co_adv.reshape(-1))
    sizes = [p.size for p in parts]
    kw = dict(horizon_ms=horizon_ms, margin=margin, min_frac=min_frac,
              min_rate=min_rate, load_gain=load_gain, co_gain=co_gain,
              max_cpu=max_cpu, overload_ctrl=overload_ctrl)

    def unpack(flat: torch.Tensor):
        views, at = [], 0
        for size in sizes:
            views.append(flat[at:at + size])
            at += size
        f = [v.view(torch.float32) for v in views]
        return (f[0].view(c, n), views[1], f[2], f[3], f[4],
                f[5].view(c, n) if co_adv is not None else None)

    if dev.type != "cuda":
        flat = torch.from_numpy(np.concatenate(
            [p.view(np.int32) for p in parts]))
        return PendingScores(_score(*unpack(flat), **kw))
    side = torch.cuda.Stream(dev)       # one of PyTorch's pooled streams
    with torch.cuda.device(dev), torch.cuda.stream(side):
        buf = torch.empty((sum(sizes),), dtype=torch.int32, pin_memory=True)
        np.concatenate([p.view(np.int32) for p in parts], out=buf.numpy())
        flat = buf.to(dev, non_blocking=True)
        scores = _score(*unpack(flat), **kw)
        host = torch.empty((c, n), dtype=torch.float32, pin_memory=True)
        host.copy_(scores, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
    return PendingScores(host, event, keep=(buf, flat, scores))


def _score_sharded(mesh, dev, rates, owner, fwd_cost, move_cost, cpu,
                   co_adv, **kw) -> PendingScores:
    """This rank's block of classes scored on ``dev``, then every rank's
    block all-gathered over the plan axis (:func:`plan_score_shardings`
    names what is cut: the class-indexed inputs by rows, ``cpu`` whole)."""
    from ..dist import comm

    c = rates.shape[0]
    specs = plan_score_shardings(mesh, c)
    k = comm.size(mesh, PLAN_AXIS)
    lo = comm.rank(mesh, PLAN_AXIS) * (c // k)
    rows = slice(lo, lo + c // k)

    def put(a, name, dtype):
        a = np.asarray(a, dtype=dtype)
        if specs[name]:
            a = a[rows]
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    block = _score(put(rates, "rates", np.float32),
                   put(owner, "owner", np.int32),
                   put(fwd_cost, "fwd_cost", np.float32),
                   put(move_cost, "move_cost", np.float32),
                   put(cpu, "cpu", np.float32),
                   None if co_adv is None else put(co_adv, "co_adv",
                                                   np.float32), **kw)
    whole = comm.all_gather(block, mesh, PLAN_AXIS, 0)
    return PendingScores(whole.cpu())


def score_moves(*args, **kwargs) -> np.ndarray:
    """Score all [class, target] moves in one evaluation (blocking:
    dispatch + wait — ``score_moves_async`` split at zero distance)."""
    return score_moves_async(*args, **kwargs).wait()


def score_moves_np(
    rates, owner, fwd_cost, move_cost, cpu, *,
    horizon_ms, margin=1.0, min_frac=0.0, min_rate=0.0, load_gain=0.0,
    co_gain=0.0, co_rates=None, max_cpu=0.9, overload_ctrl=True,
) -> np.ndarray:
    """Numpy twin of :func:`score_moves` (test oracle, float32)."""
    rates = np.asarray(rates, dtype=np.float32)
    owner = np.asarray(owner, dtype=np.int32)
    fwd_cost = np.asarray(fwd_cost, dtype=np.float32)
    move_cost = np.asarray(move_cost, dtype=np.float32)
    cpu = np.asarray(cpu, dtype=np.float32)
    c, n = rates.shape
    owned = owner >= 0
    safe = np.clip(owner, 0, n - 1)
    own_rate = np.where(
        owned, np.take_along_axis(rates, safe[:, None], axis=1)[:, 0], 0.0
    ).astype(np.float32)
    adv = rates - own_rate[:, None]
    own_cpu = np.where(owned, cpu[safe], 0.0).astype(np.float32)
    load = np.float32(load_gain) * np.maximum(
        np.float32(0.0), own_cpu[:, None] - cpu[None, :])
    if co_rates is not None and co_gain != 0.0:
        onehot = (owner[:, None] == np.arange(n)[None, :]).astype(np.float64)
        m = np.asarray(co_rates, dtype=np.float64) @ onehot
        at_owner = np.where(owned,
                            np.take_along_axis(m, safe[:, None], axis=1)[:, 0],
                            0.0)
        co_adv = (m - at_owner[:, None]).astype(np.float32)
    else:
        co_adv = np.zeros((c, n), dtype=np.float32)
    benefit = (adv + load + np.float32(co_gain) * co_adv) \
        * np.float32(horizon_ms) * fwd_cost[:, None]
    score = benefit - np.float32(margin) * move_cost[:, None]
    is_owner = np.arange(n)[None, :] == owner[:, None]
    total = rates.sum(axis=1, keepdims=True)
    dominant = (rates >= np.float32(min_frac) * total) \
        & (total >= np.float32(min_rate))
    mask = (~is_owner) & owned[:, None] & dominant
    if overload_ctrl:
        mask &= (cpu < max_cpu)[None, :]
    return np.where(mask, score, NEG_INF).astype(np.float32)
