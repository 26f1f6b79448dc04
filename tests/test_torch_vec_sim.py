"""The port's batched sweep model (``repro_torch.core.vec_sim``) against
``repro.core.jax_sim``.

The dynamics are held bit for bit on the reference's own draws: the class
pairs are drawn here with ``jax.random`` in ``jax_sim.simulate``'s split
order and fed to ``simulate_classes``.  The port's own draws are numpy's,
so the trends of ``tests/test_jax_sim.py`` are held on them as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_sim
from repro_torch.core import vec_sim

VARIANTS = {"ALC~": dict(fine_grained=False, migrate=False),
            "FGL~": dict(fine_grained=True, migrate=False),
            "LILAC~": dict(fine_grained=True, migrate=True)}


def jax_classes(key, locality, *, n_nodes=4, n_classes=64, n_rounds=64):
    """``simulate``'s draws, ``[R, N, 2]``: ``split(key, n_rounds)``, then
    ``split(k, n_nodes)``, then ``split(., 3)`` for the uniform, the
    partition and the two offsets."""
    cpn = n_classes // n_nodes
    loc = jnp.float32(locality)

    def node_ccs(k, node):
        k1, k2, k3 = jax.random.split(k, 3)
        local = jax.random.uniform(k1) < loc
        part = jnp.where(local, node, jax.random.randint(k2, (), 0, n_nodes))
        return part * cpn + jax.random.randint(k3, (2,), 0, cpn)

    def round_ccs(k):
        return jax.vmap(node_ccs)(jax.random.split(k, n_nodes),
                                  jnp.arange(n_nodes))

    return np.asarray(jax.vmap(round_ccs)(jax.random.split(key, n_rounds)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_simulate_classes_equals_jax_sim_bitwise(variant):
    """3 seeds x 3 localities at 64 rounds: every total bit for bit."""
    kw = VARIANTS[variant]
    points = [(s, loc) for s in range(3) for loc in (0.0, 0.5, 0.95)]
    ccs = np.stack([jax_classes(jax.random.PRNGKey(s), loc)
                    for s, loc in points])
    got = vec_sim.simulate_classes(torch.from_numpy(ccs), **kw)
    for g, (s, loc) in enumerate(points):
        want = jax_sim.simulate(jax.random.PRNGKey(s), loc, n_rounds=64,
                                **kw)
        for name in vec_sim.SweepResult._fields:
            a = getattr(got, name)[g]
            b = np.asarray(getattr(want, name))
            assert a.dtype == torch.float32 and b.dtype == np.float32
            assert a.numpy().tobytes() == b.tobytes(), (variant, s, loc, name)


def test_locality_sweep_means_equal_jax_sim():
    """``sweep_from_classes`` over the reference's draws gives
    ``locality_sweep``'s means (fp32 sums in another order: 1e-6)."""
    locs = [0.0, 0.3, 0.9]
    seeds = 3
    ccs = np.stack([np.stack([jax_classes(jax.random.PRNGKey(s), loc)
                              for s in range(seeds)]) for loc in locs])
    for kw in VARIANTS.values():
        got = vec_sim.sweep_from_classes(locs, torch.from_numpy(ccs), **kw)
        want = jax_sim.locality_sweep(locs, seeds=seeds, n_rounds=64, **kw)
        for k in ("locality", "throughput", "reuse", "lease_moves"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=0)


def test_draws_follow_locality_and_seed():
    a = vec_sim.draw_classes(0, [0.0, 1.0], n_rounds=32)
    assert a.shape == (2, 32, 4, 2) and a.dtype == np.int64
    part = a // 16
    assert (part[1] == np.arange(4)[None, :, None]).all()   # all local
    assert ((a >= 0) & (a < 64)).all()
    assert (vec_sim.draw_classes(0, [0.0], n_rounds=32)[0] == a[0]).all()
    assert not (vec_sim.draw_classes(1, [0.0], n_rounds=32) == a[:1]).all()


def test_simulate_is_one_point_of_the_sweep():
    one = vec_sim.simulate(2, 0.7, n_rounds=64, migrate=True, device="cpu")
    assert one.commits.shape == () and float(one.commits) == 4 * 64
    ccs = torch.from_numpy(vec_sim.draw_classes(2, [0.7], n_rounds=64))
    res = vec_sim.simulate_classes(ccs, migrate=True)
    for a, b in zip(one, res):
        assert float(a) == float(b[0])


def test_cuda_is_asked_for_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vec_sim.locality_sweep([0.5], seeds=1, n_rounds=4)


# -- the trends of tests/test_jax_sim.py, on the port's own draws ------------

def _sweep(locs, seeds, **kw):
    return vec_sim.locality_sweep(locs, seeds=seeds, device="cpu", **kw)


def test_reuse_rises_with_locality():
    r = _sweep([0.0, 0.5, 0.95], 4)["reuse"].numpy()
    assert r[2] > r[1] > r[0]
    assert r[2] > 0.5


def test_fgl_beats_alc_reuse():
    fgl = _sweep([0.9], 4, fine_grained=True)
    alc = _sweep([0.9], 4, fine_grained=False)
    assert float(fgl["reuse"][0]) > float(alc["reuse"][0])
    assert float(fgl["throughput"][0]) >= float(alc["throughput"][0])


def test_migration_cuts_lease_moves():
    base = _sweep([0.3], 4, migrate=False)
    mig = _sweep([0.3], 4, migrate=True)
    assert float(mig["lease_moves"][0]) < float(base["lease_moves"][0])
    assert float(mig["throughput"][0]) >= float(base["throughput"][0])


def test_throughput_ordering_high_locality():
    """ALC <= FGL <= FGL+migration at high locality (paper Fig 3a shape)."""
    alc = _sweep([0.9], 6, fine_grained=False)
    fgl = _sweep([0.9], 6, fine_grained=True)
    lilac = _sweep([0.9], 6, fine_grained=True, migrate=True)
    a, f, l = (float(x["throughput"][0]) for x in (alc, fgl, lilac))
    assert a <= f + 1e-6 and f <= l + 1e-6
