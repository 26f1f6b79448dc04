"""Mamba2 SSD chunked scan — the hand-written Hopper kernel and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``
/ ``_ssd_kernel``).  The CUDA source is ``csrc/ssd_scan.cu``: one block per
(batch, block of heads) sweeps the chunks in a loop, keeping the fp32
``[Hb, P, N]`` state in shared memory throughout and writing it out once.
The intra-chunk term is tiled in 64-row strips by 64-column tiles, since a
whole ``[L, L]`` decay matrix does not fit in a block's shared memory at
L = 256; C·Bᵀ is computed once per tile for all heads of the block
(``n_groups == 1``).  It is bound by operations; this first version runs
on the fp32 CUDA cores.

The plain version is :func:`repro_torch.kernels.ref.ssd_ref`.  Built by
:mod:`.nvcc` at first use; nothing is built at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .nvcc import CudaLibrary, check_launch

LIB = CudaLibrary("ssd_scan", {
    "ssd_scan_launch": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int),
})
MAX_HEAD_DIM = 64
MAX_STATE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last reset (a plain integer: the
# wrapper adds one where it launches, nowhere else)
launches = 0


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device, dtype: torch.dtype) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int = 256,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; returns ``(y, final_state)``.

    ``x``: ``[B, S, H, P]`` float32 or bfloat16; ``dt``: ``[B, S, H]``
    float32 (softplus'd); ``a``: ``[H]`` float32; ``b_mat``/``c_mat``:
    ``[B, S, 1, N]`` in x's type; ``h0``: ``[B, H, P, N]`` float32 or None
    (zeros).  ``S % chunk == 0``, P <= 64, N <= 128 and a multiple of 4.
    Two heads go to a block (one if H is odd) and share its C·Bᵀ tiles.
    Returns ``y [B, S, H, P]`` in x's type and the final state
    ``[B, H, P, N]`` float32.  Raises on anything else, on a failed build
    and on a refused launch.
    """
    global launches
    if x.device.type != "cuda":
        raise ValueError("ssd_scan launches on CUDA tensors only; CPU "
                         "callers use ref.ssd_ref")
    dev = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D, got shape {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    if b_mat.dim() != 4:
        raise ValueError(f"b_mat must be 4-D, got shape "
                         f"{tuple(b_mat.shape)}")
    g, n = b_mat.shape[2], b_mat.shape[3]
    if g != 1:
        raise ValueError(f"ssd_scan takes n_groups == 1, got {g}")
    _check("x", x, (bsz, s, h, p), dev, x.dtype)
    _check("dt", dt, (bsz, s, h), dev, torch.float32)
    _check("a", a, (h,), dev, torch.float32)
    _check("b_mat", b_mat, (bsz, s, 1, n), dev, x.dtype)
    _check("c_mat", c_mat, (bsz, s, 1, n), dev, x.dtype)
    if h0 is None:
        h0 = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
    _check("h0", h0, (bsz, h, p, n), dev, torch.float32)
    if chunk < 1 or s % chunk:
        raise ValueError(f"S = {s} is not a multiple of chunk = {chunk}")
    if not (0 < p <= MAX_HEAD_DIM):
        raise ValueError(f"head dim P = {p} outside 1..{MAX_HEAD_DIM}")
    if not (0 < n <= MAX_STATE) or n % 4:
        raise ValueError(f"state dim N = {n} must be a multiple of 4 in "
                         f"4..{MAX_STATE}")
    if bsz == 0 or s == 0 or h == 0:
        raise ValueError("ssd_scan needs B, S and H >= 1")
    hb = 2 if h % 2 == 0 else 1
    y = torch.empty_like(x)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), h0.data_ptr(), y.data_ptr(), final.data_ptr(),
            _DTYPES[x.dtype], bsz, s, h, p, n, chunk, hb, stream)
    check_launch("ssd_scan", err)
    launches += 1
    return y, final
