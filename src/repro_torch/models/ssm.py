"""Mamba2 (state-space duality) mixer: chunked SSD scan + recurrent decode.

The port of :mod:`repro.models.ssm`.  Prefill goes through
:func:`repro_torch.kernels.ops.ssd`, which pads the sequence to a multiple
of the chunk and runs the SSD kernel on a CUDA tensor, or the plain version
when the caller asks for it with ``use_kernel="ref"``.  Decode is the O(1)-per-token
recurrent step over the cached state, as in the reference.

Tensor parallelism (this rank's blocks of ``w_in`` / ``w_out`` on a
model axis, :class:`_Heads`): the in-projection's output is gathered,
then the rank runs the conv, the scan (the SSD kernel over its ``H / m``
heads) and the gated norm over its own heads, as GSPMD partitions the
reference's block (its dot FLOPs a device are the single device's over
the axis size), and ``w_out`` sums the parts.  The caches stay whole on
every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import comm
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import segsum, ssd_chunked  # noqa: F401
from repro_torch.obs.regions import region

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


class _Heads:
    """The heads one rank of a tensor-parallel Mamba2 block computes.

    ``w_in``'s column block cuts the concatenation ``[z | x | B | C |
    dt]``, not the heads, so its output is gathered whole over the model
    axis.  Where ``w_out`` is a row block and the axis divides the heads
    (and the groups line up with them), the rank then runs the conv, the
    scan and the gated norm over its own ``H / m`` heads (the ``B`` / ``C``
    groups they read are whole on every rank), as GSPMD partitions the
    reference's block; the norm's sum of squares is summed over the axis.
    Otherwise every rank runs all heads.  The caches stay whole on every
    rank (:func:`repro_torch.dist.sharding.cache_pspecs` replicates them
    over the model axis): the conv tail is the whole gathered input, the
    final states are gathered over the heads.
    """

    def __init__(self, p, cfg: ModelConfig, ctx):
        s = cfg.ssm
        d = cfg.d_model
        self.di, self.nh = s.d_inner(d), s.n_heads(d)
        self.gn, self.P, self.N = s.n_groups * s.d_state, s.head_dim, \
            s.d_state
        self.tp = ctx.model_tp if ctx is not None else None
        width = 2 * self.di + 2 * self.gn + self.nh
        self.t_in = shd.block_tp(self.tp, p["w_in"], -1, width) is not None
        self.t_out = shd.block_tp(self.tp, p["w_out"], 0, self.di) \
            is not None
        self.h0, self.hl, self.g0, self.gl = 0, self.nh, 0, s.n_groups
        if self.t_out and self.nh % ctx.model_size == 0:
            hl = self.nh // ctx.model_size
            hpg = self.nh // s.n_groups
            if hl % hpg == 0 or hpg % hl == 0:
                self.hl = hl
                self.h0 = comm.rank(*self.tp) * hl
                self.g0, self.gl = self.h0 // hpg, max(1, hl // hpg)
        self.part = self.hl != self.nh

    def channels(self, device) -> torch.Tensor:
        """This rank's columns of ``[x | B | C]`` (the conv's channels)."""
        c0, cl = self.h0 * self.P, self.hl * self.P
        b0, bl = self.g0 * self.N, self.gl * self.N
        return torch.cat([torch.arange(c0, c0 + cl, device=device),
                          self.di + torch.arange(b0, b0 + bl, device=device),
                          self.di + self.gn + torch.arange(b0, b0 + bl,
                                                           device=device)])

    def leaf(self, t: torch.Tensor, lo: int, n: int, dim: int = -1
             ) -> torch.Tensor:
        """Columns ``[lo, lo + n)`` of a replicated leaf ``t`` (its gradient
        summed over the ranks that each use a part of it)."""
        if not self.part:
            return t
        return comm.region_input(t, *self.tp).narrow(dim, lo, n)


def _gated_norm(y: torch.Tensor, w: torch.Tensor, eps: float, hd: _Heads
                ) -> torch.Tensor:
    """:func:`rms_norm` over all ``d_inner`` channels, of which ``y`` holds
    this rank's when the heads are split (the sum of squares is summed
    over the model axis)."""
    if not hd.part:
        return rms_norm(y, w, eps)
    dt = y.dtype
    y = y.float()
    ss = comm.all_reduce(torch.sum(y * y, dim=-1, keepdim=True), *hd.tp)
    ss = comm.region_input(ss, *hd.tp)         # each rank uses it on its part
    return (y * torch.rsqrt(ss / hd.di + eps) * w.float()).to(dt)


def mamba2_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                 # [B, S, d]
    cfg: ModelConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    return_cache: bool = False,
    use_kernel: str = "auto",
    ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full Mamba2 mixer.  ``cache`` = {conv [B,K-1,C], ssm [B,H,P,N]}.

    With this rank's blocks of ``w_in`` / ``w_out`` on a mesh (``ctx``),
    tensor-parallel over the model axis as :class:`_Heads` says."""
    s = cfg.ssm
    bsz, seq, _ = x.shape
    hd = _Heads(p, cfg, ctx)
    di, h0, hl = hd.di, hd.h0, hd.hl
    cl, bl = hl * s.head_dim, hd.gl * s.d_state
    a = -torch.exp(hd.leaf(p["A_log"], h0, hl).float())
    d_skip = hd.leaf(p["D"], h0, hl).to(x.dtype).repeat_interleave(
        s.head_dim)[None, None, :]

    with region("repro.mamba.in_proj"):
        if hd.t_in:
            proj = comm.all_gather(comm.region_input(x, *hd.tp) @ p["w_in"],
                                   *hd.tp, -1)
        else:
            proj = x @ p["w_in"]
    if hd.part:                       # whole on every rank, used per rank
        proj = comm.region_input(proj, *hd.tp)
    z, xbc, dt_raw = _split_in_proj(cfg, proj)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if hd.part:
        chans = hd.channels(x.device)
        z = z.narrow(-1, h0 * s.head_dim, cl)
        dt_raw = dt_raw.narrow(-1, h0, hl)
        conv_w = comm.region_input(conv_w, *hd.tp).index_select(1, chans)
        conv_b = comm.region_input(conv_b, *hd.tp).index_select(0, chans)
    mine = (lambda t: t.index_select(-1, chans)) if hd.part else \
        (lambda t: t)
    dt = F.softplus(dt_raw.float()
                    + hd.leaf(p["dt_bias"], h0, hl).float())

    if seq == 1 and cache is not None:
        # --- decode: shift conv state, recurrent SSD step --------------------
        conv_state = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)],
                               dim=1)                        # [B,K,C]
        xbc_t = torch.einsum("bkc,kc->bc", mine(conv_state).float(),
                             conv_w.float()) + conv_b
        xbc_t = silu(xbc_t).to(x.dtype)[:, None, :]
        xs, b_mat, c_mat = torch.split(xbc_t, [cl, bl, bl], dim=-1)
        y_t, new_ssm = ssd_recurrent_step(
            cache["ssm"].narrow(1, h0, hl),
            xs.reshape(bsz, hl, s.head_dim),
            dt[:, 0],
            a,
            b_mat.reshape(bsz, hd.gl, s.d_state),
            c_mat.reshape(bsz, hd.gl, s.d_state),
        )
        y = y_t.reshape(bsz, 1, cl)
        y = y + xs * d_skip
        if hd.part and return_cache:
            new_ssm = comm.all_gather(new_ssm, *hd.tp, 1)
        new_cache = ({"conv": conv_state[:, 1:, :], "ssm": new_ssm}
                     if return_cache else None)
    else:
        # --- train / prefill: chunked scan -----------------------------------
        conv_in_state = mine(cache["conv"]) if cache is not None else None
        xbc_c = silu(causal_conv1d(mine(xbc), conv_w, conv_b,
                                   conv_in_state))
        xs, b_mat, c_mat = torch.split(xbc_c, [cl, bl, bl], dim=-1)
        # the kernel takes contiguous [B, S, H, P] and [B, S, G, N]
        xh = xs.reshape(bsz, seq, hl, s.head_dim).contiguous()
        bm = b_mat.reshape(bsz, seq, hd.gl, s.d_state).contiguous()
        cm = c_mat.reshape(bsz, seq, hd.gl, s.d_state).contiguous()
        h_in = cache["ssm"].narrow(1, h0, hl) if cache is not None else None
        y_h, final = ops.ssd(xh, dt, a, bm, cm, chunk=s.chunk, h0=h_in,
                             plain=use_kernel == "ref")
        y = y_h.reshape(bsz, seq, cl).to(x.dtype)
        y = y + xs * d_skip
        new_cache = None
        if return_cache:
            if hd.part:
                final = comm.all_gather(final, *hd.tp, 1)
            k = s.d_conv
            tail = xbc[:, -(k - 1):, :]
            if cache is not None:
                tail = torch.cat([cache["conv"], xbc], dim=1)[:, -(k - 1):, :]
            elif seq < k - 1:
                tail = torch.cat([xbc.new_zeros((bsz, k - 1 - seq,
                                                 xbc.shape[2])), xbc], dim=1)
            new_cache = {"conv": tail.contiguous(), "ssm": final}

    # gated RMSNorm (Mamba2: norm(y * silu(z)))
    y = _gated_norm(y * silu(z.float()).to(y.dtype),
                    hd.leaf(p["gate_norm"], h0 * s.head_dim, cl),
                    cfg.norm_eps, hd)
    with region("repro.mamba.out_proj"):
        if not hd.t_out:
            return y @ p["w_out"], new_cache
        if not hd.part:               # whole y, this rank's rows of w_out
            w = p["w_out"].shape[0]
            y = comm.region_input(y, *hd.tp).narrow(
                -1, comm.rank(*hd.tp) * w, w)
        return comm.all_reduce(y @ p["w_out"], *hd.tp), new_cache


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
