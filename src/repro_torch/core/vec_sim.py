"""Vectorized cluster model for wide policy sweeps, batched on a torch device.

The port of :mod:`repro.core.jax_sim`: the same round-based, fixed-capacity
re-formulation of the lease/migration dynamics.  Each round every node
originates one transaction (two conflict classes drawn from a partition by
locality), the DTD picks the executing node with the vectorized short-term
cost, ownership moves when leases are acquired, and per-transaction latency
is accumulated in communication steps (p2p=1, URB=2, OAB=3 — the paper's own
cost model).

This is *not* the faithful reproduction vehicle (that is
:mod:`repro_torch.core.cluster`, the discrete-event simulator); it is the
approximation used to sweep thousands of (seed × locality × policy) points
at once — e.g. for tuning the DTD's cost constants or the conflict-class
granularity before committing to event-sim runs.  Cross-checked for the
qualitative trends the paper establishes: lease reuse rises with locality;
migration reduces lease traffic; throughput ordering ALC < FGL <
FGL+migration at high locality.

Layout for the card.  Where the reference vmaps a ``lax.scan`` over sweep
points, the port puts every point in the leading dimension: ``owner`` and
``last_owner_req`` are ``[G, C]``, the rounds are a Python loop, and within
a round the nodes' lease moves apply in node order, as the reference's inner
scan does (later nodes win ties; the tie marker is ``i * 7919 + 1``).  The
draws are split from the dynamics: :func:`simulate_classes` takes the drawn
class pairs ``ccs[G, R, N, 2]`` and returns the totals; :func:`simulate` and
:func:`locality_sweep` draw them on the host from
``numpy.random.default_rng(seed)`` (the port's convention: host draws are
numpy) and move them to the device, so runs on ``cuda`` and ``cpu`` are
bit-equal.  The totals are sums of small integers in fp32, hence exact.  A
round issues a few dozen small launches, so on the card the loop is bound
by launch latency, not by the device.

Example::

    from repro_torch.core import vec_sim
    out = vec_sim.locality_sweep([0.0, 0.5, 0.9], seeds=4, migrate=True)
    out = vec_sim.locality_sweep([0.0, 0.9], seeds=4, device="cpu")
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from .. import resolve_device

C_P2P, C_URB, C_AB = 1.0, 2.0, 3.0


class SweepResult(NamedTuple):
    steps_total: torch.Tensor     # accumulated communication steps
    commits: torch.Tensor
    piggybacks: torch.Tensor
    lease_moves: torch.Tensor
    forwards: torch.Tensor

    @property
    def throughput(self) -> torch.Tensor:
        """Commits per communication step (relative units)."""
        return self.commits / torch.clamp_min(self.steps_total, 1e-9)

    @property
    def reuse_rate(self) -> torch.Tensor:
        return self.piggybacks / torch.clamp_min(self.commits, 1.0)


def draw_classes(seed: int, localities: Sequence[float], *, n_nodes: int = 4,
                 n_classes: int = 64, n_rounds: int = 512) -> np.ndarray:
    """The class pairs ``[L, R, N, 2]`` (int64) of one seed at each locality.

    Per round and node: with probability ``locality`` the node's own
    partition, else one drawn uniformly; then two classes drawn uniformly
    within it.  The uniforms and partitions are drawn once per seed and
    shared by every locality (common random numbers, as the reference's
    one key per seed)."""
    cpn = n_classes // n_nodes
    rng = np.random.default_rng(seed)
    u = rng.random((n_rounds, n_nodes))
    other = rng.integers(0, n_nodes, (n_rounds, n_nodes))
    offs = rng.integers(0, cpn, (n_rounds, n_nodes, 2))
    loc = np.asarray(localities, np.float64).reshape(-1, 1, 1)
    part = np.where(u[None] < loc, np.arange(n_nodes), other[None])
    return part[..., None] * cpn + offs[None]


def simulate_classes(ccs: torch.Tensor, *, n_nodes: int = 4,
                     n_classes: int = 64, fine_grained: bool = True,
                     migrate: bool = False) -> SweepResult:
    """The totals of ``G`` sweep points from their drawn class pairs.

    ``ccs``: ``[G, R, N, 2]`` integer tensor of class ids, on the device
    the points run on.  Returns a :class:`SweepResult` of ``[G]`` fp32
    tensors on that device."""
    g, n_rounds, n, _ = ccs.shape
    if n != n_nodes:
        raise ValueError(f"ccs has {n} nodes, n_nodes is {n_nodes}")
    dev = ccs.device
    classes_per_node = n_classes // n_nodes
    # flat ids into the [G * C] tables, round-major: each round's [G, N, 2]
    # slab contiguous
    base = torch.arange(g, device=dev).mul_(n_classes).view(g, 1, 1, 1)
    # lint: allow(id-dtype): the flat ids only index the tables, and
    # advanced indexing (owner[cc], lor[idx] = ...) widens int32 indices
    # to int64 at every call: one more kernel a lookup
    flat = (ccs.to(torch.int64) + base).transpose(0, 1).contiguous()
    nodes = torch.arange(n_nodes, device=dev)
    owner = nodes.repeat_interleave(classes_per_node).repeat(g)   # [G * C]
    lor = torch.zeros(g * n_classes, dtype=torch.int32, device=dev)
    # per round: [round time, commits, piggybacks, lease moves, forwards]
    stats = torch.zeros((n_rounds, g, 5), dtype=torch.float32, device=dev)
    stats[:, :, 1] = float(n_nodes)
    for r in range(n_rounds):
        cc = flat[r]                                         # [G, N, 2]
        own = owner[cc]
        owns_all = (own == nodes[:, None]).all(dim=2)
        if fine_grained:
            reuse = owns_all
        else:
            # coarse ALC: reuse only if the pair was acquired together
            last = lor[cc]
            reuse = owns_all & (last[..., 0] == last[..., 1])
        # candidate executor: owner of the first class (attractor)
        cand = own[..., 0]
        if migrate:
            forward = ~reuse & (own[..., 1] == cand) & (cand != nodes)
        else:
            forward = torch.zeros_like(reuse)
        exec_node = torch.where(forward, cand, nodes)
        exec_reuse = reuse | forward
        cost = torch.where(
            exec_reuse,
            torch.where(forward, C_P2P + C_URB, C_URB),
            C_AB + 2.0 * C_URB)
        acquire = ~exec_reuse
        # lease moves in node order: later nodes win ties (the total
        # order of the round's OABs); a pair's two writes carry one value
        for i in range(n_nodes):
            idx = cc[:, i]                                   # [G, 2]
            take = acquire[:, i:i + 1]
            owner[idx] = torch.where(take, exec_node[:, i:i + 1], owner[idx])
            lor[idx] = torch.where(take, i * 7919 + 1, lor[idx])
        stats[r, :, 0] = cost.amax(dim=1).float()
        stats[r, :, 2] = reuse.sum(dim=1).float()
        stats[r, :, 3] = acquire.sum(dim=1).float()
        stats[r, :, 4] = forward.sum(dim=1).float()
    tot = stats.sum(dim=0)
    return SweepResult(tot[:, 0], tot[:, 1], tot[:, 2], tot[:, 3], tot[:, 4])


def simulate(seed: int, locality: float, *, n_nodes: int = 4,
             n_classes: int = 64, n_rounds: int = 512,
             fine_grained: bool = True, migrate: bool = False,
             device="cuda") -> SweepResult:
    """One sweep point: 0-d tensors on ``device``."""
    dev = resolve_device(device)
    ccs = draw_classes(seed, [locality], n_nodes=n_nodes,
                       n_classes=n_classes, n_rounds=n_rounds)
    res = simulate_classes(torch.from_numpy(ccs).to(dev), n_nodes=n_nodes,
                           n_classes=n_classes, fine_grained=fine_grained,
                           migrate=migrate)
    return SweepResult(*(t[0] for t in res))


def _seed_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over dim 1, summed in seed order: the same bits on every
    device (a reduction kernel's order differs between CPU and CUDA)."""
    acc = x[:, 0]
    for s in range(1, x.shape[1]):
        acc = acc + x[:, s]
    return acc / x.shape[1]


def sweep_means(localities, res: SweepResult) -> Dict[str, torch.Tensor]:
    """``[L]`` means over seeds of totals laid out ``[L, S]``."""
    return {"locality": torch.as_tensor(localities, dtype=torch.float32,
                                        device=res.commits.device),
            "throughput": _seed_mean(res.throughput),
            "reuse": _seed_mean(res.reuse_rate),
            "lease_moves": _seed_mean(res.lease_moves)}


def simulate_grid(ccs: torch.Tensor, **kw) -> SweepResult:
    """:func:`simulate_classes` over a grid of draws ``ccs[L, S, R, N, 2]``:
    the totals laid out ``[L, S]``."""
    n_loc, n_seeds = ccs.shape[:2]
    res = simulate_classes(ccs.flatten(0, 1), **kw)
    return SweepResult(*(t.view(n_loc, n_seeds) for t in res))


def sweep_from_classes(localities, ccs: torch.Tensor, *, n_nodes: int = 4,
                       n_classes: int = 64, fine_grained: bool = True,
                       migrate: bool = False) -> Dict[str, torch.Tensor]:
    """:func:`locality_sweep` over given draws ``ccs[L, S, R, N, 2]``:
    ``[L]`` means over the ``S`` seeds."""
    return sweep_means(localities, simulate_grid(
        ccs, n_nodes=n_nodes, n_classes=n_classes,
        fine_grained=fine_grained, migrate=migrate))


def locality_sweep(
    localities, seeds=4, *, n_nodes=4, n_classes=64, n_rounds=512,
    fine_grained=True, migrate=False, device="cuda",
) -> Dict[str, torch.Tensor]:
    """Batched grid: returns tensors [len(localities)] averaged over seeds
    ``0 .. seeds - 1``."""
    dev = resolve_device(device)
    ccs = np.stack([draw_classes(s, localities, n_nodes=n_nodes,
                                 n_classes=n_classes, n_rounds=n_rounds)
                    for s in range(seeds)], axis=1)      # [L, S, R, N, 2]
    return sweep_from_classes(localities, torch.from_numpy(ccs).to(dev),
                              n_nodes=n_nodes, n_classes=n_classes,
                              fine_grained=fine_grained, migrate=migrate)
