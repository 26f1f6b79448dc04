"""Elastic restart in gloo worlds on the CPU (``train/elastic.py``).

A four-rank world takes a mesh train step of mixtral (experts chunked over
a model axis of 2) and commits the state; two of its ranks fail and the
survivors resume on the mesh they still make (``resume_after_failure``:
``plan_remesh``, ``remesh`` over the survivors' sub-group, the restore).
Then a world of two restores the same checkpoint with each rank keeping
only its expert chunk: a state saved by 4 ranks, resharded onto 2.  Both
restores are bit for bit.  ``plan_remesh`` itself is held to the
reference in ``tests/test_torch_sharding.py``.
"""
import numpy as np
import pytest
import torch

import torch_gloo
from repro_torch.train.tree import leaves, unflatten


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("elastic") / "ckpt")
    four = torch_gloo.run_world("elastic_save", 4, ckpt=ckpt)
    two = torch_gloo.run_world("elastic_restore", 2, ckpt=ckpt)
    return four, two


def _flat(tree) -> np.ndarray:
    return torch.cat([t.reshape(-1).float() for t in leaves(tree)]).numpy()


def test_mesh_train_state_is_replicated(worlds):
    """Every rank of the (2, 2) mesh ends the step with the same state
    (gradients summed over the data axis, expert chunks over the model
    axis), which rank 0 commits."""
    four, _ = worlds
    for r in four[1:]:
        np.testing.assert_array_equal(r["saved"], four[0]["saved"])
    assert np.isfinite(four[0]["saved"]).all()


def test_survivors_resume_bit_for_bit(worlds):
    """Ranks 2 and 3 fail; ranks 0 and 1 make a (1, 2) mesh of their own
    and restore step 7, every leaf equal to the committed one."""
    four, _ = worlds
    for r in four[:2]:
        assert int(r["step"]) == 7
        assert list(r["mesh"]) == [1, 2]
        np.testing.assert_array_equal(r["restored"], four[0]["saved"])
    assert all("restored" not in r for r in four[2:])


def test_world_of_two_restores_its_chunks(worlds):
    """A world of two restores the four-rank checkpoint onto a (1, 2)
    mesh: rank r keeps expert chunk r of every MoE layer (one chunk a
    rank) and every other leaf whole, bit for bit."""
    four, two = worlds
    full = torch_gloo._state("mixtral-8x7b", 2)
    shapes = [t.numel() for t in leaves(full)]
    saved = np.split(four[0]["saved"], np.cumsum(shapes)[:-1])
    state = unflatten(full, [torch.from_numpy(a).reshape(t.shape)
                             for a, t in zip(saved, leaves(full))])
    for rank, r in enumerate(two):
        assert int(r["step"]) == 7 and list(r["mesh"]) == [1, 2]
        assert set(r["chunk_rows"].tolist()) == {1}
        np.testing.assert_array_equal(
            r["restored"], _flat(torch_gloo._local_like(state, rank)))
