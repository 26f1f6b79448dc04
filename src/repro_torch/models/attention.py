"""Attention mixers: GQA (causal / bidirectional / sliding-window).

The port of :mod:`repro.models.attention`.  KV caches are explicit dicts
threaded by the caller.  The inner product goes through
:func:`repro_torch.kernels.ops.attention` (the flash kernel on a CUDA
tensor, at every query length) unless the caller asks for the plain
version with ``use_kernel="ref"``.

Left out: the mesh and sequence-parallel branches (``_shard_kv``,
``seq_parallel``; ROADMAP queue 1 item 9) and MLA (item 8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, attn_mask  # noqa: F401

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


def sdpa(q, k, v, *, q_positions: torch.Tensor, kv_positions: torch.Tensor,
         causal: bool, sliding_window: Optional[int] = None,
         logit_softcap: float = 0.0, scale: Optional[float] = None,
         use_kernel: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention with GQA.

    ``use_kernel="ref"`` runs the plain version on any device; any other
    value dispatches by device (:class:`~repro_torch.models.decoder.RunCtx`
    checks the value).
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return ops.attention(q, k, v, q_positions=q_positions,
                         kv_positions=kv_positions, causal=causal,
                         sliding_window=sliding_window,
                         logit_softcap=logit_softcap, scale=scale,
                         plain=use_kernel == "ref")


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
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One GQA attention block (no residual / norm — the caller owns those).

    ``cache`` (decode): dict(k=[B, S_max, Hkv, D], v=...), written in place
    at ``cache_index`` (a scalar, or ``[B]`` for continuous batching).
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

    new_cache = None
    if cache is not None and cache_index is not None:
        k_all = _cache_update(cache["k"], k, cache_index)
        v_all = _cache_update(cache["v"], v, cache_index)
        if return_cache:
            new_cache = {"k": k_all, "v": v_all}
        s_max = k_all.shape[1]
        kv_pos = torch.arange(s_max, dtype=torch.int32,
                              device=x.device)[None, :].expand(b, s_max)
        # entries beyond the current write point are invalid -> mask via pos
        upto = torch.as_tensor(cache_index, device=x.device) + s
        if upto.dim() == 1:
            upto = upto[:, None]
        kv_pos = torch.where(kv_pos < upto, kv_pos,
                             torch.full_like(kv_pos, INVALID_POS))
        out = sdpa(q, k_all, v_all, q_positions=q_pos, kv_positions=kv_pos,
                   causal=cfg.causal, sliding_window=window,
                   logit_softcap=0.0, use_kernel=use_kernel)
    else:
        if return_cache:
            new_cache = {"k": k, "v": v}
        out = sdpa(q, k, v, q_positions=q_pos, kv_positions=q_pos,
                   causal=cfg.causal, sliding_window=window,
                   logit_softcap=0.0, use_kernel=use_kernel)
    return out.reshape(b, s, -1) @ p["wo"], new_cache


def mla_attention(*args: Any, **kwargs: Any):
    """DeepSeek-V2 latent attention: not ported yet."""
    raise NotImplementedError("MLA attention is not ported yet "
                              "(ROADMAP queue 1 item 8: MLA + MoE)")


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Zeroed cache entry for one attention layer."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA caches are not ported yet "
                                  "(ROADMAP queue 1 item 8: MLA + MoE)")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
