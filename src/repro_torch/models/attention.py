"""Attention mixers: GQA (causal / bidirectional / sliding-window), MLA.

The port of :mod:`repro.models.attention`.  KV caches are explicit dicts
threaded by the caller.  The inner product goes through
:func:`repro_torch.kernels.ops.attention` (the flash kernel on a CUDA
tensor, at every query length) unless the caller asks for the plain
version with ``use_kernel="ref"``.  MLA's one-token decode is the
reference's absorbed form in fp32 einsums, outside any kernel, as in the
reference.

On a mesh (``ctx.mesh``) each rank runs its own block; the layout of a
KV buffer is :func:`repro_torch.dist.sharding.kv_buffer_spec`'s (kv heads
over the model axis, the sequence over the seq axis):

* **seq-sharded decode** — each seq rank holds one contiguous chunk of
  the ring and attends over it alone, then the ranks merge their ``(out,
  lse)`` pairs with one all-gather over the seq group: only the softmax
  statistics and the chunk outputs move, never the cache.  On CUDA the
  log-sum-exp comes from the flash kernel's ``decode_split``; MLA merges
  its absorbed latent context the same way.  A rank that holds some kv
  heads attends for their q heads, and the heads are gathered over the
  model axis before ``wo``.
* **sequence-parallel attention** (the reference's ``seq_parallel``) — a
  multi-token pass whose head count does not divide the model axis
  splits its queries over the model axis, with k and v whole, and gathers
  the outputs back.
* a prefill's cache leaves cut to this rank's block (:func:`_shard_kv`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.dist import comm
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, attn_mask

from .common import ModelConfig, apply_rope, rms_norm

INVALID_POS = 2 ** 30      # kv position of a ring slot not yet written

Index = Union[int, torch.Tensor]


def _cache_update(buf: torch.Tensor, new: torch.Tensor,
                  index: Index) -> torch.Tensor:
    """Write ``new`` into the seq axis (1) of ``buf`` at scalar or per-row
    ``index``, IN PLACE, and return ``buf``.

    The reference returns an updated copy (``dynamic_update_slice``); the
    port writes into the ring it was given, which saves a copy of the
    whole cache per layer and step.  The start is clamped so the update
    fits, as ``dynamic_update_slice`` clamps it.
    """
    b, s = new.shape[:2]
    top = buf.shape[1] - s
    new = new.to(buf.dtype)
    if isinstance(index, int):
        start = min(max(index, 0), top)
        buf[:, start:start + s] = new
        return buf
    index = index.to(device=buf.device, dtype=torch.long)
    rows = index.clamp(0, top).expand(b)[:, None] \
        + torch.arange(s, device=buf.device)[None, :]
    buf[torch.arange(b, device=buf.device)[:, None], rows] = new
    return buf


def _ring_positions(cache_index: Index, s: int, s_max: int, b: int,
                    device, offset: int = 0) -> torch.Tensor:
    """kv positions ``[B, s_max]`` of a ring (or of its chunk starting at
    ``offset``) written up to ``cache_index + s``; the slots beyond it are
    invalid and masked as ``INVALID_POS``."""
    kv_pos = torch.arange(offset, offset + s_max, dtype=torch.int32,
                          device=device)[None, :].expand(b, s_max)
    upto = torch.as_tensor(cache_index, device=device) + s
    if upto.dim() == 1:
        upto = upto[:, None]
    return torch.where(kv_pos < upto, kv_pos,
                       torch.full_like(kv_pos, INVALID_POS))


def sdpa(q, k, v, *, q_positions: torch.Tensor, kv_positions: torch.Tensor,
         causal: bool, sliding_window: Optional[int] = None,
         logit_softcap: float = 0.0, scale: Optional[float] = None,
         use_kernel: str = "auto", return_lse: bool = False):
    """Scaled dot-product attention with GQA.

    ``use_kernel="ref"`` runs the plain version on any device; any other
    value dispatches by device (:class:`~repro_torch.models.decoder.RunCtx`
    checks the value).  ``return_lse`` adds each row's log-sum-exp
    ``[B, Sq, Hq]`` (:func:`repro_torch.kernels.ops.attention`).
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return ops.attention(q, k, v, q_positions=q_positions,
                         kv_positions=kv_positions, causal=causal,
                         sliding_window=sliding_window,
                         logit_softcap=logit_softcap, scale=scale,
                         plain=use_kernel == "ref", return_lse=return_lse)


# ---------------------------------------------------------------------------
# The mesh: this rank's block of a KV buffer, the seq-sharded combine
# ---------------------------------------------------------------------------

def _on_mesh(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


def _shard_kv(ctx, arr: torch.Tensor) -> torch.Tensor:
    """This rank's block of a prefill's KV buffer ``[B, S, ...]`` (the
    batch is already this rank's): :func:`~repro_torch.dist.sharding.
    kv_buffer_spec`'s kv heads over the model axis and, on a seq mesh, the
    sequence over the seq axis, so the cache a prefill returns is laid
    out as ``init_cache(mesh=)`` allocates it."""
    if not _on_mesh(ctx):
        return arr
    spec = shd.kv_buffer_spec(
        arr.shape, bdim=0, batch=None, model=ctx.model_axis,
        msize=ctx.model_size, seq=ctx.seq_axis if ctx.seq_sharded else None,
        ssize=ctx.seq_size)
    if ctx.seq_sharded and ctx.seq_size > 1 and spec[1] is None:
        raise ValueError(f"a prompt of {arr.shape[1]} tokens does not "
                         f"divide over the seq axis ({ctx.seq_size} ranks)")
    return shd.local_shard(arr, spec, ctx.mesh)


def _chunk_update(buf: torch.Tensor, new: torch.Tensor, index: Index,
                  offset: int) -> torch.Tensor:
    """Write ``new`` (positions ``index + j``) into the chunk ``buf`` that
    holds ring positions ``offset ..``, IN PLACE: each position lands on
    the rank whose chunk holds it, and the others write nothing.

    One token a row (decode) writes through a clamped index, rewriting
    the slot's own value where the position lies outside the chunk, so
    the host never waits on the device; several tokens a row take a
    masked write.
    """
    b, s = new.shape[:2]
    n = buf.shape[1]
    new = new.to(buf.dtype)
    start = torch.as_tensor(index, device=buf.device).to(torch.long)
    start = start.expand(b) if start.dim() == 0 else start
    at = start[:, None] + torch.arange(s, device=buf.device)[None, :] - offset
    keep = (at >= 0) & (at < n)
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    if s == 1:
        at = at.clamp(0, n - 1)
        mask = keep.reshape(b, 1, *([1] * (new.dim() - 2)))
        buf[rows, at] = torch.where(mask, new, buf[rows, at])
    else:
        buf[rows[keep], at[keep]] = new[keep]
    return buf


def _seq_combine(ctx, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Merge the seq ranks' attention over their chunks: ``out [B, Sq, H,
    D]`` and ``lse [B, Sq, H]`` travel in one all-gather, and rank ``r``'s
    output is weighted by ``exp(lse_r - max_r lse_r)``.  A rank that saw no
    key has weight 0; over one rank the weight is 1 and the output is
    returned bit for bit."""
    packed = torch.cat([out.float(), lse[..., None].float()], dim=-1)
    every = comm.all_gather(packed[None], ctx.mesh, ctx.seq_axis, 0)
    outs, lses = every[..., :-1], every[..., -1]
    top = lses.max(dim=0).values
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - top)                             # [n, B, Sq, H]
    merged = (w[..., None] * outs).sum(dim=0) / \
        w.sum(dim=0)[..., None].clamp_min(torch.finfo(torch.float32).tiny)
    return merged.to(out.dtype)


def _ring_chunk(ctx, buf: torch.Tensor) -> Tuple[int, bool]:
    """(first ring position of this rank's chunk, whether the ring is
    seq-sharded): chunk ``r`` of the seq axis holds ``r * S_loc ..``."""
    if _on_mesh(ctx) and ctx.seq_sharded:
        return comm.rank(ctx.mesh, ctx.seq_axis) * buf.shape[1], True
    return 0, False


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


def gqa_project_qkv(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                  # [B, S, d]
    cfg: ModelConfig,
    positions: torch.Tensor,          # [B, S] or [3, B, S]
    rope_theta: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _split_heads(x @ p["wq"], cfg.n_heads)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads)
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, gemma=cfg.gemma_norm)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, gemma=cfg.gemma_norm)
    q = apply_rope(q, positions, rope_theta, cfg.partial_rotary,
                   cfg.mrope_sections)
    k = apply_rope(k, positions, rope_theta, cfg.partial_rotary,
                   cfg.mrope_sections)
    return q, k, v.contiguous()


def gqa_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    is_global: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[Index] = None,
    return_cache: bool = False,
    use_kernel: str = "auto",
    ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One GQA attention block (no residual / norm — the caller owns those).

    ``cache`` (decode): dict(k=[B, S_max, Hkv, D], v=...), written in place
    at ``cache_index`` (a scalar, or ``[B]`` for continuous batching); on a
    mesh, this rank's block of it (module docstring).

    When the head count does not divide the model axis, a multi-token
    pass without a cache runs *sequence-parallel*: the query sequence is
    split over the model axis (k and v whole), so the quadratic score work
    is partitioned, and the outputs are gathered back before ``wo``.
    """
    theta = cfg.rope_theta
    window = None
    if not is_global and cfg.sliding_window is not None:
        window = cfg.sliding_window
    elif is_global and cfg.rope_theta_global is not None:
        theta = cfg.rope_theta_global

    b, s = x.shape[:2]
    q, k, v = gqa_project_qkv(p, x, cfg, positions, theta)
    q_pos = positions[0] if positions.dim() == 3 else positions
    opts = dict(causal=cfg.causal, sliding_window=window, logit_softcap=0.0,
                use_kernel=use_kernel)

    new_cache = None
    if cache is not None and cache_index is not None:
        hkv = cache["k"].shape[2]
        heads = hkv != k.shape[2]         # kv heads sharded over the model axis
        if heads:
            lo = comm.rank(ctx.mesh, ctx.model_axis) * hkv
            g = cfg.n_heads // cfg.n_kv_heads
            q, k, v = q[:, :, lo * g:(lo + hkv) * g], k[:, :, lo:lo + hkv], \
                v[:, :, lo:lo + hkv]
        offset, sharded = _ring_chunk(ctx, cache["k"])
        if sharded:
            k_all = _chunk_update(cache["k"], k, cache_index, offset)
            v_all = _chunk_update(cache["v"], v, cache_index, offset)
        else:
            k_all = _cache_update(cache["k"], k, cache_index)
            v_all = _cache_update(cache["v"], v, cache_index)
        if return_cache:
            new_cache = {"k": k_all, "v": v_all}
        kv_pos = _ring_positions(cache_index, s, k_all.shape[1], b, x.device,
                                 offset)
        if sharded:
            out = _seq_combine(ctx, *sdpa(
                q.contiguous(), k_all, v_all, q_positions=q_pos,
                kv_positions=kv_pos, return_lse=True, **opts))
        else:
            out = sdpa(q.contiguous(), k_all, v_all, q_positions=q_pos,
                       kv_positions=kv_pos, **opts)
        if heads:
            out = comm.all_gather(out, ctx.mesh, ctx.model_axis, 2)
    else:
        if return_cache:
            new_cache = {"k": _shard_kv(ctx, k), "v": _shard_kv(ctx, v)}
        seq_parallel = (_on_mesh(ctx) and s > 1
                        and cfg.n_heads % ctx.model_size != 0
                        and s % ctx.model_size == 0)
        if seq_parallel:
            ax = (None, ctx.model_axis)
            q = ctx.shard_act(comm.region_input(q, ctx.mesh, ctx.model_axis),
                              *ax).contiguous()
            k = comm.region_input(k, ctx.mesh, ctx.model_axis)
            v = comm.region_input(v, ctx.mesh, ctx.model_axis)
            out = sdpa(q, k, v, q_positions=ctx.shard_act(q_pos, *ax),
                       kv_positions=q_pos, **opts)
            out = comm.all_gather(out, ctx.mesh, ctx.model_axis, 1)
        else:
            out = sdpa(q, k, v, q_positions=q_pos, kv_positions=q_pos,
                       **opts)
    return out.reshape(b, s, -1) @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------
#
# The KV cache stores only the compressed latent c_kv [B, S, kv_lora] and the
# decoupled rope key k_pe [B, S, rope_dim].

def mla_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[Index] = None,
    return_cache: bool = False,
    use_kernel: str = "auto",
    is_global: bool = True,
    ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One MLA block (no residual / norm).  ``cache`` (decode): dict(c_kv=
    [B, S_max, kv_lora], k_pe=[B, S_max, rope]), written in place; on a
    seq mesh, this rank's chunk of it, whose absorbed context is merged
    with the other chunks' by their log-sum-exp.

    A multi-token pass expands the latent into per-head K and V and goes
    through :func:`sdpa` with ``scale = qk_dim ** -0.5`` (deepseek-v2: Dk
    192, Dv 128, the flash kernel's ``simt`` variant on the card).  One
    token against a cache scores in latent space (``w_k`` absorbed into
    the query) in fp32 einsums and never expands the cache.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, r = m.qk_nope_head_dim, m.kv_lora_rank
    qk_dim = dn + m.qk_rope_head_dim

    # --- queries (low-rank) -------------------------------------------------
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(b, s, h, qk_dim)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    # --- compressed KV latent (k_pe rotated on a singleton head axis) --------
    ckv_full = x @ p["wkv_a"]                              # [B,S,kv_lora+rope]
    c_kv = rms_norm(ckv_full[..., :r], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(ckv_full[..., None, r:], positions,
                      cfg.rope_theta)[..., 0, :]           # [B,S,rope_dim]

    q_pos = positions[0] if positions.dim() == 3 else positions
    new_cache = None
    sharded = False
    if cache is not None and cache_index is not None:
        offset, sharded = _ring_chunk(ctx, cache["c_kv"])
        if sharded:
            c_use = _chunk_update(cache["c_kv"], c_kv, cache_index, offset)
            pe_use = _chunk_update(cache["k_pe"], k_pe, cache_index, offset)
        else:
            c_use = _cache_update(cache["c_kv"], c_kv, cache_index)
            pe_use = _cache_update(cache["k_pe"], k_pe, cache_index)
        if return_cache:
            new_cache = {"c_kv": c_use, "k_pe": pe_use}
        kv_pos = _ring_positions(cache_index, s, c_use.shape[1], b, x.device,
                                 offset)
    else:
        if return_cache:
            new_cache = {"c_kv": _shard_kv(ctx, c_kv),
                         "k_pe": _shard_kv(ctx, k_pe)}
        kv_pos = q_pos
        c_use, pe_use = c_kv, k_pe

    # --- expand latent to per-head K/V (absorbed form for decode) -----------
    wkv_b = p["wkv_b"].reshape(r, h, dn + m.v_head_dim)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]            # [r, h, dk|dv]
    scale = qk_dim ** -0.5
    if s == 1 and cache is not None:
        c32 = c_use.float()
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_k.float())
        logits = torch.einsum("bqhr,bkr->bhqk", q_lat, c32)
        logits = logits + torch.einsum("bqhd,bkd->bhqk", q_pe.float(),
                                       pe_use.float())
        logits = logits * scale
        mask = attn_mask(q_pos, kv_pos, cfg.causal, None)
        logits = torch.where(mask[:, None, :, :], logits, NEG_INF)
        pr = torch.softmax(logits, dim=-1)
        ctx_lat = torch.einsum("bhqk,bkr->bqhr", pr, c32)
        if sharded:
            lse = torch.logsumexp(logits, dim=-1).transpose(1, 2)
            ctx_lat = _seq_combine(ctx, ctx_lat, lse)
        out = torch.einsum("bqhr,rhd->bqhd", ctx_lat,
                           w_v.float()).to(x.dtype)
    else:
        if sharded:
            raise NotImplementedError("MLA over a seq-sharded cache decodes "
                                      "one token at a time")
        skv = c_use.shape[1]
        k_nope = torch.einsum("bkr,rhd->bkhd", c_use, w_k.to(c_use.dtype))
        v_full = torch.einsum("bkr,rhd->bkhd", c_use,
                              w_v.to(c_use.dtype)).contiguous()
        k_full = torch.cat(
            [k_nope, pe_use[:, :, None, :].expand(b, skv, h,
                                                  m.qk_rope_head_dim)],
            dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        out = sdpa(q_full, k_full, v_full, q_positions=q_pos,
                   kv_positions=kv_pos, causal=cfg.causal,
                   sliding_window=None, scale=scale, use_kernel=use_kernel)
    return out.reshape(b, s, -1) @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------

def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Zeroed cache entry for one attention layer."""
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_pe": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                dtype=dtype, device=device),
        }
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
