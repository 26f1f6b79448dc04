"""Mixture-of-Experts FFN: routing, the dense oracle and the routed path.

The port of :mod:`repro.models.moe` for one device.

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

Left out: the sharded paths (``_moe_local``, ``moe_sharded``, the token
all-to-all ``moe_sharded_a2a`` with ``_a2a_plan`` and ``dispatch_verdict``):
ROADMAP queue 1 item 9.  ``moe_apply`` with a mesh raises.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

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
# Entry point
# ---------------------------------------------------------------------------

def moe_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              mesh=None) -> torch.Tensor:
    """MoE layer entry point on one device: ``moe_ref``'s function, each
    expert applied to its routed rows only.

    One host sync a call reads the rows per expert; experts that no token
    picked launch nothing.  Emits the reference's ``moe-dispatch`` span
    (``path="ref"``, the reference's name for its one-device path) on the
    module-level recorder.  A mesh raises: the sharded paths are ROADMAP
    queue 1 item 9.
    """
    if mesh is not None:
        raise NotImplementedError("the sharded MoE paths are not ported yet "
                                  "(ROADMAP queue 1 item 9)")
    tr = obs_trace.TRACE
    if tr.enabled:
        tr.span("moe-dispatch", "moe", tr.time, 0.0, path="ref",
                tokens=int(x.shape[0] * x.shape[1]))
    m = cfg.moe
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    gates, ids = _route(p, xt, cfg)
    flat = ids.reshape(-1)
    # (token, k) rows grouped by expert; a stable sort keeps token order
    order = torch.argsort(flat, stable=True)
    tokens = order // m.top_k
    gate = gates.reshape(-1)[order]
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
