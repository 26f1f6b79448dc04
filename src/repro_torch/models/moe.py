"""Mixture-of-Experts FFN: routing, the dense oracle, the routed path and
the sharded expert paths.

The port of :mod:`repro.models.moe`.

* :func:`moe_ref` — the reference's dense-mask loop, kept as the oracle:
  every expert runs on every token and the gate (zero where the token did
  not pick the expert) weights its output.
* :func:`moe_apply` — the layer's entry point.  It computes ``moe_ref``'s
  function routed: for each expert in id order it gathers the (token, k)
  rows routed to it, applies the SwiGLU expert to those rows only and
  ``index_add_``s the gated fp32 rows into the output.  There is no
  capacity and no drop.  The fp32 sums run in the same expert order, and
  the dense loop only adds exact zeros besides, so the two differ only
  where a matrix product rounds differently for another row count.  At
  deepseek-v2's 160 experts and top 6 the dense loop does 26.7x the expert
  work, at mixtral's 8 and top 2 it does 4x.  Within one expert a token
  occurs at most once, so the scatter has no duplicate index and is
  deterministic on the card.

On a mesh whose ``model`` axis has more than one rank, expert weights
are laid out in *chunks*: the model axis is split into ``ep x tp`` (expert
parallelism x tensor parallelism inside an expert), and model rank ``m``
owns chunk ``m`` (:func:`to_chunked`).  Two paths compute the layer, as
in the reference, each as per-rank code over a ``DeviceMesh``
(:mod:`repro_torch.dist.comm`):

* :func:`moe_sharded` — tokens replicated over the model axis (the
  "migrate work to the state owner" branch: the work is already where the
  state is).  Each rank routes, gathers its experts' tokens into
  capacity-bounded buffers, runs its chunk and scatters back; one
  all-reduce over the model axis sums the experts and the f-slices.
* :func:`moe_sharded_a2a` — tokens sharded over the batch and model axes;
  the routed rows go to their expert chunks and back by two
  ``all_to_all_single`` legs, and :func:`repro_torch.kernels.ops.
  moe_combine` sums the tp partials and scatters the gated rows.

:func:`moe_apply` picks between them per cell with the DTD's verdict
(:func:`dispatch_verdict`: :func:`repro_torch.dist.locality.
price_moe_dispatch`, cached), or as ``dispatch`` forces.  The capacity,
the slot order (arrival order per expert) and the drops are the
reference's.  The sharded paths take the global batch and return the
global result (``shard_map``'s contract); the decoder, whose stack already
runs this rank's rows, calls them with ``batch_local=True``.  Expert
weights may be the global chunked tensors ``[n_chunks, ...]`` or this
rank's chunk ``[1, ...]``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import comm
from repro_torch.dist import sharding as shd
from repro_torch.obs import trace as obs_trace

from .common import ModelConfig, chunk_plan, mlp_apply, silu


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def router_topk(logits: torch.Tensor, top_k: int, norm_topk: bool,
                router_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (gate values [T, K] float32, expert ids [T, K] int32).

    ``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` promises no order, so the port takes the first ``top_k``
    of a stable descending sort, which keeps that order.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :top_k], ids[:, :top_k]
    if norm_topk:
        vals = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return vals * router_scale, ids.to(torch.int32)


def aux_load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean prob x token fraction)."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)                                          # [E]
    onehot = F.one_hot(ids[..., 0].long(), n_experts).float()
    ce = onehot.mean(dim=0)
    return n_experts * torch.sum(me * ce)


def _route(p: Dict[str, Any], xt: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits in fp32 (TF32 stays off, PyTorch's default), top-k."""
    m = cfg.moe
    logits = xt.float() @ p["router"].float()
    return router_topk(logits, m.top_k, norm_topk=(m.n_shared == 0),
                       router_scale=m.router_scale)


def _expert(we: Dict[str, torch.Tensor], e: int,
            x: torch.Tensor) -> torch.Tensor:
    """Expert ``e`` of the chunked ``n_chunks = 1`` layout on rows ``x``."""
    h = silu(x @ we["w_gate"][0, e]) * (x @ we["w_up"][0, e])
    return h @ we["w_down"][0, e]


def _finish(p: Dict[str, Any], out: torch.Tensor, xt: torch.Tensor,
            cfg: ModelConfig, shape) -> torch.Tensor:
    """The fp32 sum cast back to x's dtype, plus the shared experts (one
    SwiGLU of width ``n_shared x d_shared``)."""
    y = out.to(xt.dtype)
    if cfg.moe.n_shared:
        y = y + mlp_apply(p["shared"], xt, "swiglu")
    return y.reshape(shape)


def _shared(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, mesh,
            model_axis: str) -> torch.Tensor:
    """The shared experts on a mesh: outside the expert paths, under the
    dense rules (``w_gate`` / ``w_up`` column-, ``w_down`` row-parallel)
    when ``p["shared"]`` holds this rank's blocks, as GSPMD partitions
    the reference's (it applies them outside its ``shard_map``)."""
    m = cfg.moe
    tp = shd.block_tp((mesh, model_axis), p["shared"]["w_down"], 0,
                      m.n_shared * m.d_shared)
    return mlp_apply(p["shared"], x, "swiglu", tp)


# ---------------------------------------------------------------------------
# Reference path (oracle; exact, no drops)
# ---------------------------------------------------------------------------

def moe_ref(p: Dict[str, Any], x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """[B, S, d] -> [B, S, d]; loops over experts with dense masks.

    Expert weights are in the chunked layout with n_chunks = 1:
    ``experts.w_gate [1, E, d, f]`` etc.
    """
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    gates, ids = _route(p, xt, cfg)
    out = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.moe.n_experts):
        w = torch.where(ids == e, gates, 0.0).sum(dim=-1)           # [T]
        out = out + _expert(p["experts"], e, xt).float() * w[:, None]
    return _finish(p, out, xt, cfg, x.shape)


# ---------------------------------------------------------------------------
# Chunked expert weight layout (EP x TP over the model axis)
# ---------------------------------------------------------------------------

def to_chunked(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
               model_size: int):
    """[E, d, f] expert weights -> chunked [n_chunks, n_e, d, f_c] layout.

    Chunk m holds experts ``(m // tp) * n_e + [0, n_e)`` restricted to
    f-slice ``m % tp``.
    """
    e, d, f = w_gate.shape
    ep, tp, n_e, nc = chunk_plan(e, model_size)
    f_c = f // tp

    def chunks_in(w):          # [E, d, f] -> [ep, tp, n_e, d, f_c]
        wr = torch.movedim(w.reshape(ep, n_e, d, tp, f_c), 3, 1)
        return wr.reshape(nc, n_e, d, f_c)

    def chunks_out(w):         # w_down [E, f, d]: slice along f
        wr = torch.movedim(w.reshape(ep, n_e, tp, f_c, d), 2, 1)
        return wr.reshape(nc, n_e, f_c, d)

    return chunks_in(w_gate), chunks_in(w_up), chunks_out(w_down)


def chunked_shapes(cfg: ModelConfig, model_size: int
                   ) -> Dict[str, Tuple[int, ...]]:
    m = cfg.moe
    ep, tp, n_e, nc = chunk_plan(m.n_experts, model_size)
    f_c = m.d_expert // tp
    return {
        "w_gate": (nc, n_e, cfg.d_model, f_c),
        "w_up": (nc, n_e, cfg.d_model, f_c),
        "w_down": (nc, n_e, f_c, cfg.d_model),
    }


# ---------------------------------------------------------------------------
# Sharded path: tokens replicated over the model axis
# ---------------------------------------------------------------------------

def _model_shape(mesh, model_axis: str) -> Tuple[int, int]:
    """(this rank's coordinate, ranks) along the model axis."""
    return comm.rank(mesh, model_axis), comm.size(mesh, model_axis)


def _my_chunk(w: torch.Tensor, mrank: int, msize: int) -> torch.Tensor:
    """Chunk ``mrank`` of global ``[n_chunks, ...]`` expert weights, or
    the one chunk this rank holds."""
    if w.shape[0] == msize:
        return w[mrank]
    if w.shape[0] == 1:
        return w[0]
    raise ValueError(f"expert weights of {w.shape[0]} chunks on a model "
                     f"axis of {msize}")


def _moe_local(x_loc: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
               wu: torch.Tensor, wd: torch.Tensor, *, cfg: ModelConfig,
               mesh, model_axis: str, capacity: int) -> torch.Tensor:
    """Per-rank body: route, gather my experts' tokens, FFN, scatter, one
    all-reduce over the model axis.

    ``x_loc [T, d]`` is this batch shard's tokens, replicated over the
    model axis; ``wg, wu [n_e, d, f_c]``, ``wd [n_e, f_c, d]`` this rank's
    chunk.  Accumulates in the compute dtype, as the reference does (its
    psum moves the compute dtype, not fp32).
    """
    m = cfg.moe
    mrank, msize = _model_shape(mesh, model_axis)
    ep, tp, n_e, _ = chunk_plan(m.n_experts, msize)
    ep_rank = mrank // tp
    # the tokens and the router enter the model-parallel region: each rank
    # uses all of them for its own experts' part, so their gradients add up
    x_loc = comm.region_input(x_loc, mesh, model_axis)
    router = comm.region_input(router, mesh, model_axis)

    t_loc, d = x_loc.shape
    acc_dt = x_loc.dtype
    gates, ids = router_topk(x_loc.float() @ router.float(), m.top_k,
                             norm_topk=(m.n_shared == 0),
                             router_scale=m.router_scale)
    # slot of each (token, k) choice among all choices of its expert, in
    # arrival order, for capacity dropping
    flat_ids = ids.reshape(-1).long()                        # [T*K]
    flat_gates = gates.reshape(-1)
    onehot = F.one_hot(flat_ids, m.n_experts).to(torch.int32)
    slot = torch.cumsum(onehot, dim=0) - onehot              # [T*K, E]
    token_of = torch.arange(t_loc * m.top_k, device=x_loc.device) // m.top_k
    y = torch.zeros((t_loc, d), dtype=acc_dt, device=x_loc.device)
    for le in range(n_e):
        gid = ep_rank * n_e + le
        # lint: allow(id-dtype): an expert-capacity slot (an int64 cumsum),
        # not a protocol id: scatter takes int64 indices
        slot_e = slot[:, gid].long()
        keep = (flat_ids == gid) & (slot_e < capacity)
        # the capacity buffer, slot -> (token, gate), scattered as the
        # reference does: every choice not kept goes to an overflow row
        # that is cut off, so no shape depends on the routing and the host
        # never waits on the device; empty slots hold the out-of-range
        # token t_loc and gate 0
        dest = torch.where(keep, slot_e, capacity)
        tok_idx = torch.full((capacity + 1,), t_loc, dtype=torch.long,
                             device=x_loc.device).scatter(
            0, dest, torch.where(keep, token_of, t_loc))[:capacity]
        gate_buf = flat_gates.new_zeros((capacity + 1,)).scatter(
            0, dest, torch.where(keep, flat_gates, 0.0))[:capacity]
        filled = (tok_idx < t_loc)[:, None]
        rows = tok_idx.clamp(max=t_loc - 1)
        zero = torch.zeros((), dtype=acc_dt, device=x_loc.device)
        xg = torch.where(filled, x_loc[rows], zero)           # [C, d]
        h = silu(xg @ wg[le]) * (xg @ wu[le])                # [C, f_c]
        o = (h @ wd[le]) * gate_buf[:, None].to(acc_dt)
        y = y.index_add(0, rows, torch.where(filled, o, zero))
    # one reduction: the experts across ep ranks and the partial f-slices
    # across tp ranks
    return comm.all_reduce(y, mesh, model_axis)


def moe_sharded(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, mesh,
                *, batch_axes: Tuple[str, ...] = ("data",),
                model_axis: str = "model", capacity_factor: float = 1.25,
                batch_local: bool = False) -> torch.Tensor:
    """EP/TP MoE over ``mesh`` with tokens replicated over the model axis;
    expert weights in the chunked layout.

    ``x [B, S, d]`` is the global batch: this rank runs the rows of its
    batch shard and the result is gathered back.  ``batch_local``: ``x``
    is already this rank's rows and the result stays so.
    """
    m = cfg.moe
    b, s, d = x.shape
    # the batch axes (leading ones dropped first) whose ranks divide b;
    # none is replication over them
    baxes = () if batch_local else shd._divisible_batch_axes(
        b, [a for a in batch_axes if a in mesh.mesh_dim_names], mesh) or ()
    x_loc = x
    if baxes:
        n = comm.size(mesh, baxes)
        x_loc = x.narrow(0, comm.rank(mesh, baxes) * (b // n), b // n)
    t_loc = x_loc.shape[0] * s
    mrank, msize = _model_shape(mesh, model_axis)
    capacity = max(int(max(1, t_loc * m.top_k * capacity_factor)
                       // m.n_experts), 8)
    we = p["experts"]
    y = _moe_local(x_loc.reshape(-1, d), p["router"],
                   _my_chunk(we["w_gate"], mrank, msize),
                   _my_chunk(we["w_up"], mrank, msize),
                   _my_chunk(we["w_down"], mrank, msize), cfg=cfg, mesh=mesh,
                   model_axis=model_axis, capacity=capacity)
    y = y.reshape(x_loc.shape).to(x.dtype)
    if m.n_shared:
        y = y + _shared(p, x_loc, cfg, mesh, model_axis)
    return comm.all_gather(y, mesh, baxes, 0) if baxes else y


# ---------------------------------------------------------------------------
# Token all-to-all path (the priced "dispatch" plan)
# ---------------------------------------------------------------------------

def _moe_local_a2a(x_loc: torch.Tensor, router: torch.Tensor,
                   wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
                   cfg: ModelConfig, mesh, model_axis: str, capacity: int,
                   shard: int, t_valid: int) -> torch.Tensor:
    """Per-rank body: route my tokens, all-to-all them to their expert
    *chunks*, partial FFN there, all-to-all the partial activations back,
    and :func:`repro_torch.kernels.ops.moe_combine` them.

    Model rank ``m`` owns chunk ``m``: experts ``(m // tp) * n_e + [0,
    n_e)`` restricted to f-slice ``m % tp``.  A routed token goes to all
    ``tp`` ranks of its expert's chunk group, each returns its f-slice
    partial, and the combine sums the ``tp`` partials per slot.  Each
    destination block is laid out ``[n_e, cap_e]`` by the chunk's local
    expert, so the receiver takes each expert's rows by a reshape and no
    expert id crosses the wire.  ``shard`` is this rank's index in the
    global token order; rows at global index ``>= t_valid`` are padding and
    are never dispatched.
    """
    from repro_torch.kernels import ops as kops

    m = cfg.moe
    msize = comm.size(mesh, model_axis)
    ep, tp, n_e, _ = chunk_plan(m.n_experts, msize)
    cap_e = capacity // n_e                               # per (src, expert)
    t_loc, d = x_loc.shape
    dev = x_loc.device
    acc_dt = x_loc.dtype
    router = comm.region_input(router, mesh, model_axis)
    gates, ids = router_topk(x_loc.float() @ router.float(), m.top_k,
                             norm_topk=(m.n_shared == 0),
                             router_scale=m.router_scale)
    flat_ids = ids.reshape(-1).long()                     # [T*K]
    flat_gates = gates.reshape(-1)
    grp = flat_ids // n_e                                 # owning ep group
    le = flat_ids % n_e                                   # its local expert
    token_of = torch.arange(t_loc * m.top_k, device=dev) // m.top_k
    valid = (shard * t_loc + token_of) < t_valid
    # per-expert arrival slot, exactly the replicated path's; all tp
    # copies of a token share one slot
    onehot = F.one_hot(flat_ids, m.n_experts).to(torch.int32) \
        * valid[:, None]
    slot = torch.cumsum(onehot, dim=0) - onehot           # [T*K, E]
    # lint: allow(id-dtype): an expert-capacity slot (an int64 cumsum), not
    # a protocol id: index_put's index
    slot_d = (slot * onehot).sum(dim=1).long()
    keep = (slot_d < cap_e) & valid

    nbuf = msize * capacity                               # = ep*tp*capacity
    # every buffer takes one overflow row for the choices not kept, cut
    # off after the scatter (the reference's mode="drop"): no shape
    # depends on the routing
    sub = le * cap_e + slot_d                             # expert sub-block
    x_routed = x_loc[token_of]
    dest = torch.cat([torch.where(keep, (grp * tp + j) * capacity + sub,
                                  nbuf) for j in range(tp)])
    send_x = x_loc.new_zeros((nbuf + 1, d)).index_put(
        (dest,), x_routed.repeat(tp, 1))[:nbuf]
    # sender-side combine metadata per (group, expert slot); never crosses
    # the wire
    crow = torch.where(keep, grp * capacity + sub, ep * capacity)
    tok_slot = torch.full((ep * capacity + 1,), t_loc, dtype=torch.int32,
                          device=dev).index_put(
        (crow,), torch.where(keep, token_of, t_loc).to(torch.int32)
    )[:ep * capacity]
    gate_slot = flat_gates.new_zeros((ep * capacity + 1,)).index_put(
        (crow,), torch.where(keep, flat_gates, 0.0))[:ep * capacity]

    recv_x = comm.all_to_all(send_x, mesh, model_axis)
    # each source block arrives sub-blocked [n_e, cap_e]: every received
    # row runs exactly one expert's FFN
    recv_e = recv_x.reshape(msize, n_e, cap_e, d)
    outs = []
    for e in range(n_e):
        xe = recv_e[:, e].reshape(msize * cap_e, d)
        h = silu(xe @ wg[e]) * (xe @ wu[e])               # [.., f_c]
        outs.append((h @ wd[e]).to(acc_dt).reshape(msize, cap_e, d))
    out = torch.stack(outs, dim=1).reshape(nbuf, d)
    # the return leg lands each chunk's partial in its sender's (group, tp,
    # expert slot) cell; moe_combine sums the tp partials per slot (the
    # f-slice psum) and scatters the gated rows to their tokens
    back = comm.all_to_all(out, mesh, model_axis)
    return kops.moe_combine(back, tok_slot, gate_slot, tp=tp,
                            capacity=capacity, t_out=t_loc)


def _a2a_plan(cfg: ModelConfig, t_total: int, mesh, batch_axes, model_axis
              ) -> Tuple[int, int, int, int]:
    """(token_shards, ep, tp, t_pad) for the a2a layout: any chunk layout,
    and a token count that does not divide is padded up to ``t_pad`` (the
    next shard multiple) with masked rows."""
    model_size = comm.size(mesh, model_axis)
    ep, tp, _, _ = chunk_plan(cfg.moe.n_experts, model_size)
    shards = model_size * comm.size(mesh, [a for a in batch_axes
                                           if a in mesh.mesh_dim_names])
    t_pad = -(-t_total // shards) * shards
    return shards, ep, tp, t_pad


def moe_sharded_a2a(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                    mesh, *, batch_axes: Tuple[str, ...] = ("data",),
                    model_axis: str = "model",
                    capacity_factor: float = 1.25,
                    batch_local: bool = False) -> torch.Tensor:
    """Token-dispatch MoE: tokens sharded over the (batch x model) axes,
    routed rows moved by a pair of all-to-alls; expert chunks stay put.

    ``x [B, S, d]`` is the global batch and the result global;
    ``batch_local``: ``x`` is this rank's rows (cut over the model axis
    alone here), and the result too.
    """
    m = cfg.moe
    b, s, d = x.shape
    axes = tuple(a for a in batch_axes if a in mesh.mesh_dim_names) \
        if not batch_local else ()
    axes = (*axes, model_axis)
    shards, ep, tp, t_pad = _a2a_plan(cfg, b * s, mesh, axes[:-1],
                                      model_axis)
    t_loc = t_pad // shards
    mrank, msize = _model_shape(mesh, model_axis)
    _, _, n_e, _ = chunk_plan(m.n_experts, msize)
    cap_e = max(8, -(-int(t_loc * m.top_k * capacity_factor)
                     // m.n_experts))
    shard = comm.rank(mesh, axes)
    xt = x.reshape(b * s, d)
    if t_pad != b * s:
        xt = F.pad(xt, (0, 0, 0, t_pad - b * s))
    # every rank of the model axis holds all of xt and uses its own rows
    xt = comm.region_input(xt, mesh, model_axis)
    we = p["experts"]
    y = _moe_local_a2a(
        xt.narrow(0, shard * t_loc, t_loc), p["router"],
        _my_chunk(we["w_gate"], mrank, msize),
        _my_chunk(we["w_up"], mrank, msize),
        _my_chunk(we["w_down"], mrank, msize), cfg=cfg, mesh=mesh,
        model_axis=model_axis, capacity=n_e * cap_e, shard=shard,
        t_valid=b * s)
    y = comm.all_gather(y.to(x.dtype), mesh, axes, 0)[:b * s]
    y = y.reshape(b, s, d)
    if m.n_shared:
        y = y + _shared(p, x, cfg, mesh, model_axis)
    return y


# ---------------------------------------------------------------------------
# Dispatch autotuning: the DTD verdict, cached per cell
# ---------------------------------------------------------------------------

# (tokens_per_device, ep_degree, tp_degree, layer dims) -> prefer token
# a2a.  One pricing call per cell ever: shapes recur, so the verdict is a
# dict hit after the first call.
_DISPATCH_CACHE: Dict[Tuple[int, ...], bool] = {}


def dispatch_verdict(cfg: ModelConfig, tokens_per_device: int,
                     ep_degree: int, tp_degree: int = 1) -> bool:
    """Cached ``price_moe_dispatch`` verdict for one (T/device, ep, tp)
    cell — tp > 1 prices the chunked layout's partial-activation psum."""
    m = cfg.moe
    key = (tokens_per_device, ep_degree, tp_degree, cfg.d_model, m.top_k,
           m.n_experts, m.d_expert)
    v = _DISPATCH_CACHE.get(key)
    if v is None:
        from repro_torch.dist.locality import price_moe_dispatch

        v = price_moe_dispatch(
            tokens_per_device, cfg.d_model, m.top_k, m.n_experts,
            m.d_expert, ep_degree, tp_degree=tp_degree).prefer_dispatch
        _DISPATCH_CACHE[key] = v
    return v


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def moe_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              mesh=None, *, dispatch: str = "auto", **kw) -> torch.Tensor:
    """MoE layer entry point with the DTD's dispatch verdict.

    Off a mesh, or on a model axis of one rank: ``moe_ref``'s function,
    each expert applied to its routed rows only (one host sync a call
    reads the rows per expert; experts that no token picked launch
    nothing).  On a model axis of more than one rank: ``dispatch="auto"``
    takes the cached :func:`dispatch_verdict` for this (tokens per rank,
    ep, tp) cell — token all-to-all (:func:`moe_sharded_a2a`) where the
    routed activations are lighter on the wire than replication,
    :func:`moe_sharded` otherwise; ``"a2a"`` / ``"replicate"`` force a
    path.  ``kw`` goes to the sharded path (``batch_axes``,
    ``model_axis``, ``capacity_factor``, ``batch_local``).  Emits the
    reference's ``moe-dispatch`` span (``path``, ``tokens``, and ``ep``,
    ``tp`` on a mesh) on the module-level recorder.
    """
    tr = obs_trace.TRACE
    model_axis = kw.get("model_axis", "model")
    if mesh is None or model_axis not in mesh.mesh_dim_names or \
            comm.size(mesh, model_axis) == 1:
        if tr.enabled:
            tr.span("moe-dispatch", "moe", tr.time, 0.0, path="ref",
                    tokens=int(x.shape[0] * x.shape[1]))
        return _moe_routed(p, x, cfg)
    if dispatch not in ("auto", "a2a", "replicate"):
        raise ValueError(f"unknown moe dispatch {dispatch!r}")
    use_a2a = False
    ep = tp = 0
    if dispatch != "replicate":
        b, s, _ = x.shape
        batch_axes = () if kw.get("batch_local") else \
            tuple(a for a in kw.get("batch_axes", ("data",))
                  if a in mesh.mesh_dim_names)
        shards, ep, tp, t_pad = _a2a_plan(cfg, b * s, mesh, batch_axes,
                                          model_axis)
        use_a2a = (dispatch == "a2a"
                   or dispatch_verdict(cfg, t_pad // shards, ep, tp))
    if tr.enabled:
        tr.span("moe-dispatch", "moe", tr.time, 0.0,
                path="a2a" if use_a2a else "replicate",
                tokens=int(x.shape[0] * x.shape[1]), ep=ep, tp=tp)
    if use_a2a:
        return moe_sharded_a2a(p, x, cfg, mesh, **kw)
    return moe_sharded(p, x, cfg, mesh, **kw)


def _moe_routed(p: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """``moe_ref``'s function on one device, each expert on its routed
    rows only (the module docstring)."""
    m = cfg.moe
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    gates, ids = _route(p, xt, cfg)
    flat = ids.reshape(-1)
    # (token, k) rows grouped by expert; a stable sort keeps token order
    order = torch.argsort(flat, stable=True)
    tokens = order // m.top_k
    gate = gates.reshape(-1)[order]
    # lint: allow(host-sync): the routed path runs each expert on its own
    # rows only, so the host needs the counts (the capacity paths do not)
    counts = torch.bincount(flat, minlength=m.n_experts).tolist()
    out = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            rows = tokens[start:start + n]
            y = _expert(p["experts"], e, xt[rows]).float()
            out.index_add_(0, rows, y * gate[start:start + n, None])
        start += n
    return _finish(p, out, xt, cfg, x.shape)
