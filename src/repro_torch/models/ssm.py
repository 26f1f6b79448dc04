"""Mamba2 (state-space duality) mixer: chunked SSD scan + recurrent decode.

The port of :mod:`repro.models.ssm`.  Prefill goes through
:func:`repro_torch.kernels.ops.ssd`, which pads the sequence to a multiple
of the chunk and runs the SSD kernel on a CUDA tensor, or the plain version
when the caller asks for it with ``use_kernel="ref"``.  Decode is the O(1)-per-token
recurrent step over the cached state, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import segsum, ssd_chunked  # noqa: F401

from .common import ModelConfig, rms_norm, silu


def ssd_recurrent_step(
    h_state: torch.Tensor,  # [B, H, P, N]
    x_t: torch.Tensor,      # [B, H, P]
    dt_t: torch.Tensor,     # [B, H]
    a: torch.Tensor,        # [H]
    b_t: torch.Tensor,      # [B, G, N]
    c_t: torch.Tensor,      # [B, G, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the SSD recurrence; returns (y_t, new_state)."""
    h, g = x_t.shape[1], b_t.shape[1]
    hpg = h // g
    be = b_t.float().repeat_interleave(hpg, dim=1)           # [B,H,N]
    ce = c_t.float().repeat_interleave(hpg, dim=1)
    da = torch.exp(dt_t.float() * a.float()[None, :])        # [B,H]
    upd = (dt_t.float()[:, :, None, None] * x_t.float()[..., None]
           * be[:, :, None, :])                              # [B,H,P,N]
    new = h_state.float() * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new, ce)
    return y.to(x_t.dtype), new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B,S,C], w [K,C], b [C]; optional left-context state [B,K-1,C].

    A sum of K shifted products, as the reference writes it (not cuDNN's
    convolution, which would run float32 in TF32 on the card).
    """
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_in_proj(cfg: ModelConfig, proj: torch.Tensor):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    z, xbc, dt = torch.split(proj, [di, di + 2 * gn,
                                    proj.shape[-1] - 2 * di - 2 * gn], dim=-1)
    return z, xbc, dt                                        # dt: [B,S,nh]


def mamba2_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                 # [B, S, d]
    cfg: ModelConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    return_cache: bool = False,
    use_kernel: str = "auto",
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full Mamba2 mixer.  ``cache`` = {conv [B,K-1,C], ssm [B,H,P,N]}."""
    s = cfg.ssm
    bsz, seq, _ = x.shape
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    a = -torch.exp(p["A_log"].float())
    d_skip = p["D"].to(x.dtype).repeat_interleave(s.head_dim)[None, None, :]

    proj = x @ p["w_in"]
    z, xbc, dt_raw = _split_in_proj(cfg, proj)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    if seq == 1 and cache is not None:
        # --- decode: shift conv state, recurrent SSD step --------------------
        conv_state = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)],
                               dim=1)                        # [B,K,C]
        xbc_t = torch.einsum("bkc,kc->bc", conv_state.float(),
                             p["conv_w"].float()) + p["conv_b"]
        xbc_t = silu(xbc_t).to(x.dtype)[:, None, :]
        xs, b_mat, c_mat = torch.split(xbc_t, [di, gn, gn], dim=-1)
        y_t, new_ssm = ssd_recurrent_step(
            cache["ssm"],
            xs.reshape(bsz, nh, s.head_dim),
            dt[:, 0],
            a,
            b_mat.reshape(bsz, s.n_groups, s.d_state),
            c_mat.reshape(bsz, s.n_groups, s.d_state),
        )
        y = y_t.reshape(bsz, 1, di)
        y = y + xs * d_skip
        new_cache = ({"conv": conv_state[:, 1:, :], "ssm": new_ssm}
                     if return_cache else None)
    else:
        # --- train / prefill: chunked scan -----------------------------------
        conv_in_state = cache["conv"] if cache is not None else None
        xbc_c = silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                     conv_in_state))
        xs, b_mat, c_mat = torch.split(xbc_c, [di, gn, gn], dim=-1)
        # the kernel takes contiguous [B, S, H, P] and [B, S, G, N]
        xh = xs.reshape(bsz, seq, nh, s.head_dim).contiguous()
        bm = b_mat.reshape(bsz, seq, s.n_groups, s.d_state).contiguous()
        cm = c_mat.reshape(bsz, seq, s.n_groups, s.d_state).contiguous()
        h0 = cache["ssm"] if cache is not None else None
        y_h, final = ops.ssd(xh, dt, a, bm, cm, chunk=s.chunk, h0=h0,
                             plain=use_kernel == "ref")
        y = y_h.reshape(bsz, seq, di).to(x.dtype)
        y = y + xs * d_skip
        new_cache = None
        if return_cache:
            k = s.d_conv
            tail = xbc[:, -(k - 1):, :]
            if cache is not None:
                tail = torch.cat([cache["conv"], xbc], dim=1)[:, -(k - 1):, :]
            elif seq < k - 1:
                tail = torch.cat([xbc.new_zeros((bsz, k - 1 - seq,
                                                 xbc.shape[2])), xbc], dim=1)
            new_cache = {"conv": tail.contiguous(), "ssm": final}

    # gated RMSNorm (Mamba2: norm(y * silu(z)))
    y = rms_norm(y * silu(z.float()).to(y.dtype), p["gate_norm"],
                 cfg.norm_eps)
    return y @ p["w_out"], new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }
