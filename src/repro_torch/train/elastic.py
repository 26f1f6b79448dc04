"""Elastic scaling: rebuild the mesh from the survivors and reshard state.

The port of :mod:`repro.train.elastic`.  The flow at scale:

1. the GCS view change (:mod:`repro_torch.core.gcs`) reports the
   surviving ranks;
2. :func:`remesh` builds the largest (data x model) mesh the survivors
   support (the model axis kept whole where it can be: TP groups must
   stay intact, so whole data rows are dropped first, which is how real
   pods fail) as a ``DeviceMesh`` over the survivors' sub-group, whose
   process groups only the survivors take part in making;
3. the training state is restored from the last committed checkpoint
   onto the *new* mesh (:func:`repro_torch.train.checkpoint.restore` with
   ``mesh`` and specs), and the data pipeline skips ahead to the
   checkpointed step: no token is lost or duplicated;
4. the paper's own mechanism covers the *soft* failure mode: an
   overloaded (straggling) node is excluded from DTD migration targets by
   constraint (3) long before it is declared failed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

from . import checkpoint


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_devices: int
    dropped: int


def plan_remesh(n_survivors: int, model_size: int,
                axis_names: Tuple[str, ...] = ("data", "model")
                ) -> ElasticPlan:
    """Largest data x model grid on the survivors, keeping TP groups
    whole."""
    model = model_size
    while model > 1 and n_survivors < model:
        model //= 2
    data = max(1, n_survivors // model)
    return ElasticPlan(mesh_shape=(data, model), axis_names=axis_names,
                       n_devices=data * model,
                       dropped=n_survivors - data * model)


def remesh(survivors: Sequence[int], plan: ElasticPlan, device=None):
    """A ``DeviceMesh`` of ``plan`` over the first ``plan.n_devices``
    surviving ranks (row-major); ``None`` on a rank it leaves out."""
    from repro_torch.launch.mesh import submesh

    return submesh(list(survivors)[:plan.n_devices], plan.mesh_shape,
                   plan.axis_names, device=device)


def resume_after_failure(
    ckpt_dir: str,
    like: Any,
    survivors: Sequence[int],
    model_size: int,
    make_specs: Optional[Callable] = None,
    device=None,
) -> Tuple[Any, Optional[int], Any]:
    """Full recovery path: new mesh + resharded restore + resume step.

    ``make_specs(mesh)`` returns the ``(path, leaf) -> spec`` rule of
    :func:`repro_torch.train.checkpoint.restore` for the new mesh (None:
    every leaf whole).  A surviving rank the new mesh leaves out gets
    ``(None, None, None)``.
    """
    plan = plan_remesh(len(survivors), model_size)
    mesh = remesh(survivors, plan, device=device)
    if mesh is None:
        return None, None, None
    specs = make_specs(mesh) if make_specs is not None else None
    state, step = checkpoint.restore(ckpt_dir, like, mesh=mesh, specs=specs)
    return state, step, mesh
