"""Sharding rules: who owns which slice of every tensor.

The port of :mod:`repro.dist.sharding`.  The locality pricing in
:mod:`.locality` is only meaningful once each tensor has a well-defined
owner; this module is that ledger.  It maps the port's parameter, batch
and cache trees onto a mesh whose axes split into *batch* axes (data
parallelism: ``pod``, ``data``), one *model* axis (tensor / expert
parallelism) and an optional *seq* axis:

* :func:`param_pspecs` — megatron-style rules by leaf name: column-parallel
  projections shard their output features, row-parallel ones their input
  features, chunked MoE expert weights their EP x TP chunk axis, and
  everything small is replicated.  Dims are indexed from the end, as in
  the reference, so the rule of a leaf does not depend on the group axis
  the reference stacks its scanned body on: the port keeps one dict per
  layer, and its per-layer spec is the reference's without that axis.
* :func:`batch_pspecs` / :func:`cache_pspecs` — inputs and caches shard
  their batch dim over the batch axes; GQA KV buffers also shard kv heads
  over the model axis, and the attention caches' sequence dim goes over
  the seq axis when the mesh has one (the long-context rule, which
  :func:`repro_torch.dist.locality.price_session_dispatch` prices at
  ``1 / seq_shards`` of the bytes per hop).

Every rule is guarded by divisibility: a dim that the mesh does not divide
is replicated rather than rejected.

A spec is a plain tuple with one entry per dim: ``None``, an axis name, or
a tuple of names (major to minor); ``()`` is a replicated leaf, as the
reference's ``P()``.  :func:`normalize` stores a one-name tuple as the
bare name, as jax 0.9's ``PartitionSpec`` does.  A *mesh* here is a
:class:`torch.distributed.device_mesh.DeviceMesh`, or, for the rules
alone, any ordered mapping of axis name to size (no process group
needed).  :func:`local_shard` and :func:`gather` move between a global
tensor and this rank's block of it: wherever a spec names an axis, a rank
holds only its block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.models.common import (ModelConfig, attn_shapes,
                                       layer_param_shapes, layer_plan)

from . import comm

MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PLAN_AXIS = "plan"

Spec = Tuple[Any, ...]

# projections whose *last* dim is feature-parallel (column-parallel)
_COL_PARALLEL = {"wq", "wk", "wv", "wq_b", "wkv_b", "w_in", "w_gate", "w_up",
                 "lm_head"}
# projections whose second-to-last dim is feature-parallel (row-parallel)
_ROW_PARALLEL = {"wo", "w_down", "w_out"}


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def normalize(spec: Sequence) -> Spec:
    """A one-name tuple entry becomes the bare name (jax 0.9's rule)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@dataclass(frozen=True)
class MeshAxes:
    """A mesh's axis names split into batch (data-parallel), model and seq.

    The ``seq`` axis (when the mesh has one) shards the sequence dim of
    long KV caches; it never takes part in batch data parallelism.
    """

    batch: Tuple[str, ...]
    model: str = MODEL_AXIS
    seq: Optional[str] = None

    @classmethod
    def for_mesh(cls, mesh) -> "MeshAxes":
        names = tuple(mesh_shape(mesh))
        seq = SEQ_AXIS if SEQ_AXIS in names else None
        return cls(batch=tuple(a for a in names
                               if a not in (MODEL_AXIS, SEQ_AXIS)), seq=seq)

    def model_size(self, mesh) -> int:
        return mesh_shape(mesh).get(self.model, 1)

    def seq_size(self, mesh) -> int:
        if self.seq is None:
            return 1
        return mesh_shape(mesh).get(self.seq, 1)


def _divisible_batch_axes(n: int, axes: Sequence[str], mesh
                          ) -> Optional[Tuple[str, ...]]:
    """Largest suffix of ``axes`` whose total size divides ``n`` (None:
    none).  Leading axes (``pod``) are dropped first, so a batch too small
    for the full mesh still uses the inner data axis."""
    shape = mesh_shape(mesh)
    axes = tuple(axes)
    while axes:
        size = 1
        for a in axes:
            size *= shape[a]
        if size > 1 and n % size == 0:
            return axes
        axes = axes[1:]
    return None


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param_spec(path: Sequence[str], shape: Tuple[int, ...], model: str,
                msize: int) -> Spec:
    """Sharding rule for one parameter leaf, by its name and ancestry;
    dims indexed from the end."""
    name = path[-1]
    in_experts = "experts" in path
    nd = len(shape)

    def at(dim_from_end: int) -> Spec:
        idx = nd + dim_from_end
        if msize <= 1 or idx < 0 or shape[idx] % msize:
            return ()
        spec: List[Any] = [None] * nd
        spec[idx] = model
        return tuple(spec)

    if in_experts and name in ("w_gate", "w_up", "w_down"):
        return at(-4)              # [nc, n_e, d, f_c]: the chunk axis
    if name == "embed":
        return at(-2)              # [vocab, d]: vocab-parallel
    if name in _COL_PARALLEL:
        return at(-1)
    if name in _ROW_PARALLEL:
        return at(-2)
    return ()                      # norms, router, conv taps, biases


def param_tree_shapes(cfg: ModelConfig, model_size: int = 1
                      ) -> Dict[str, Any]:
    """The port's parameter tree of shapes (one dict per layer), MoE
    experts in the chunked layout of ``model_size``."""
    tree: Dict[str, Any] = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "layers": layer_param_shapes(cfg, model_size),
        "final_norm": (cfg.d_model,),
    }
    if any(k.mixer == "shared_attn" for k in layer_plan(cfg).kinds):
        tree["shared_attn"] = {"attn": attn_shapes(cfg),
                               "ln_attn": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return tree


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_pspecs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """Spec tree congruent with the port's parameter tree at the mesh's
    model size (:func:`repro_torch.models.common.init_params` with
    ``model_size``)."""
    ax = MeshAxes.for_mesh(mesh)
    msize = ax.model_size(mesh)
    return _map_tree(lambda p, s: _param_spec(p, tuple(s), ax.model, msize),
                     param_tree_shapes(cfg, msize))


# ---------------------------------------------------------------------------
# Batch inputs
# ---------------------------------------------------------------------------

def batch_pspecs(cfg: ModelConfig, mesh, specs: Dict[str, Any]
                 ) -> Dict[str, Spec]:
    """Specs for a model-input dict (leaves with a ``.shape``).

    Every input shards its batch dim over the batch axes; M-RoPE positions
    carry a leading ``[3]`` section axis, so their batch dim is dim 1.
    Scalars (decode ``pos``) are replicated.
    """
    ax = MeshAxes.for_mesh(mesh)
    out: Dict[str, Spec] = {}
    for k, v in specs.items():
        shape = tuple(v.shape)
        bdim = 1 if (k == "positions" and len(shape) == 3) else 0
        if len(shape) <= bdim:
            out[k] = ()
            continue
        baxes = _divisible_batch_axes(shape[bdim], ax.batch, mesh)
        spec: List[Any] = [None] * len(shape)
        if baxes:
            spec[bdim] = baxes
        out[k] = tuple(spec)
    return out


# ---------------------------------------------------------------------------
# KV / SSM caches
# ---------------------------------------------------------------------------

# attention-cache leaves whose dim right after batch is the sequence dim;
# ndim relative to the batch dim tells them from same-named params
_SEQ_CACHE_NDIM = {"k": 4, "v": 4,          # GQA [B, S, n_kv, head_dim]
                   "c_kv": 3, "k_pe": 3}    # MLA [B, S, lat]


def kv_buffer_spec(shape: Sequence[int], *, bdim: int, batch,
                   model: str = MODEL_AXIS, msize: int = 1,
                   seq: Optional[str] = None, ssize: int = 1) -> Spec:
    """Layout rule for one attention KV buffer ``[.., B, S, (n_kv, ) D]``.

    The single source of the KV layout: batch at ``bdim``, the sequence
    dim right after it over the ``seq`` axis, and, for 4-dim GQA buffers,
    kv heads over the model axis.  :func:`cache_pspecs` allocates with it
    and ``repro_torch.models.attention._shard_kv`` cuts a prefill's cache
    with it, so the two cannot drift apart.
    """
    shape = tuple(shape)
    spec: List[Any] = [None] * len(shape)
    if batch and len(shape) > bdim:
        spec[bdim] = batch
    if len(shape) == bdim + 4 and msize > 1 and shape[bdim + 2] % msize == 0:
        spec[bdim + 2] = model
    if seq is not None and ssize > 1 and len(shape) > bdim + 1 and \
            shape[bdim + 1] % ssize == 0:
        spec[bdim + 1] = seq
    return tuple(spec)


def _cache_leaf_spec(name: str, shape: Tuple[int, ...], bdim: int, baxes,
                     model: str, msize: int, seq: Optional[str] = None,
                     ssize: int = 1) -> Spec:
    # attention KV buffers take the full layout rule; everything else (the
    # mamba conv/ssm state carries no seq dim) shards batch only
    if len(shape) == bdim + _SEQ_CACHE_NDIM.get(name, -1):
        return kv_buffer_spec(shape, bdim=bdim, batch=baxes, model=model,
                              msize=msize, seq=seq, ssize=ssize)
    spec: List[Any] = [None] * len(shape)
    if baxes and len(shape) > bdim:
        spec[bdim] = baxes
    return tuple(spec)


def cache_pspecs(cfg: ModelConfig, mesh, tree: List[Dict[str, Any]],
                 batch: int) -> List[Dict[str, Any]]:
    """Spec tree congruent with ``decoder.init_cache(cfg, batch, ..)``: one
    dict per layer, every leaf (a tensor, or anything with a ``.shape``)
    with the batch at dim 0."""
    ax = MeshAxes.for_mesh(mesh)
    msize, ssize = ax.model_size(mesh), ax.seq_size(mesh)
    baxes = _divisible_batch_axes(batch, ax.batch, mesh)
    return [{mixer: {name: _cache_leaf_spec(name, tuple(leaf.shape), 0,
                                            baxes, ax.model, msize, ax.seq,
                                            ssize)
                     for name, leaf in leaves.items()}
             for mixer, leaves in layer.items()}
            for layer in tree]


# ---------------------------------------------------------------------------
# This rank's block of a tensor
# ---------------------------------------------------------------------------

def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor laid out by
    ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = comm.size(mesh, entry)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {entry!r} ({n} ranks)")
        out[dim] //= n
    return tuple(out)


def local_shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the global ``t`` under ``spec`` (a copy of its
    own wherever the spec names an axis, so the whole tensor can be
    freed)."""
    sliced = False
    for dim, entry in enumerate(spec):
        n = comm.size(mesh, entry)
        if n == 1:
            continue
        step = local_shape(t.shape, (None,) * dim + (entry,), mesh)[dim]
        t = t.narrow(dim, comm.rank(mesh, entry) * step, step)
        sliced = True
    return t.clone() if sliced else t


def gather(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The global tensor from every rank's block (all-gathers along each
    sharded dim): the inverse of :func:`local_shard`."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            t = comm.all_gather(t, mesh, entry, dim)
    return t


# ---------------------------------------------------------------------------
# Planner score mesh: shard the [class, target] matrix over the ranks
# ---------------------------------------------------------------------------

def make_plan_mesh(n_devices: Optional[int] = None, device=None):
    """1-D mesh (axis ``plan``) for sharding planner move-scoring.

    The ``[class, target]`` score matrix of
    :func:`repro_torch.plan.score.score_moves` splits on its class axis, so
    the pow2-padded class dim shards evenly over any pow2 rank count.  The
    mesh takes the largest power of two of the world's ranks (at most
    ``n_devices``).  Returns ``None`` with no process group, below two
    ranks, and on a rank the mesh leaves out: callers treat ``None`` as
    "score unsharded".
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        return None
    n = dist.get_world_size()
    if n_devices is not None:
        n = min(n, n_devices)
    while n & (n - 1):
        n &= n - 1
    if n <= 1:
        return None
    from repro_torch.launch.mesh import submesh

    return submesh(list(range(n)), (n,), (PLAN_AXIS,), device=device)


def plan_score_shardings(mesh, n_classes: int) -> Optional[Dict[str, Spec]]:
    """Specs of the scorer's inputs on a plan mesh.

    Class-indexed arrays shard their leading (class) axis; the ``cpu``
    vector (node-indexed) is replicated.  Returns ``None`` when the class
    count does not divide over the mesh (callers score unsharded rather
    than reshard mid-epoch).
    """
    size = mesh_shape(mesh)[PLAN_AXIS]
    if size <= 1 or n_classes % size:
        return None
    row, vec = (PLAN_AXIS, None), (PLAN_AXIS,)
    return {"rates": row, "owner": vec, "fwd_cost": vec, "move_cost": vec,
            "cpu": (), "co_adv": row}
