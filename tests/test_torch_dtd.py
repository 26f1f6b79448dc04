"""repro_torch.core.dtd cost functions and solve against the jit'd JAX ones.

Exact for the short-term costs and the solve.  The long-term costs are
float32 sums taken in another order than XLA's, so they are held to
rtol 1e-6.
"""
import numpy as np
import pytest
import torch

from repro.core import dtd as jdtd
from repro_torch.core import dtd as tdtd


def _case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    s = int(rng.integers(1, 6))
    origin = int(rng.integers(0, n))
    lease = (rng.random((n, s)) < 0.5).astype(np.float32)
    freq = (rng.random((n, s)) * 3).astype(np.float32)
    cpu = rng.random(n).astype(np.float32)
    return n, origin, lease, freq, cpu


@pytest.mark.parametrize("ctrl", [False, True])
@pytest.mark.parametrize("seed", range(20))
def test_costs_match_jit(seed, ctrl):
    n, origin, lease, freq, cpu = _case(seed)
    got = tdtd.short_term_costs(torch.from_numpy(lease),
                                torch.from_numpy(cpu), origin, 0.85, ctrl)
    want = np.asarray(jdtd.short_term_costs(lease, cpu, np.int32(origin),
                                            0.85, ctrl))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got = tdtd.long_term_costs(torch.from_numpy(freq), torch.from_numpy(cpu),
                               0.85, ctrl)
    want = np.asarray(jdtd.long_term_costs(freq, cpu, 0.85, ctrl))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))


@pytest.mark.parametrize("seed", range(30))
def test_solve_matches_jit(seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 9))
    # ties are the interesting case: draw from a few levels
    costs = rng.integers(0, 3, n).astype(np.float32)
    costs[rng.random(n) < 0.3] = np.inf
    origin = int(rng.integers(n))
    for tie in (-1, 0, 3, 11):
        got = int(tdtd.solve(torch.from_numpy(costs), origin, tie))
        want = int(np.asarray(jdtd.solve(costs, np.int32(origin),
                                         np.int32(tie))))
        assert got == want, (costs, origin, tie)


def test_solve_all_infeasible_falls_back_to_origin():
    costs = torch.full((4,), float("inf"))
    assert int(tdtd.solve(costs, 2, -1)) == 2
    assert int(tdtd.solve(costs, 2, 5)) == 2
