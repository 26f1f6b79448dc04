"""Online-softmax GQA attention — the hand-written Hopper kernel and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``).  The CUDA source is
``csrc/flash_attention.cu``: one block per (batch, q head, q tile) with the
kv sweep as a loop inside the block, fp32 running max, normaliser and
accumulator, k/v tiles staged in shared memory, and kv tiles that the
positions hide entirely skipped.  It is bound by operations at prefill and
by bytes at decode; this first version runs on the fp32 CUDA cores.

Semantics follow the Pallas kernel: masking by position (causal, sliding
window, kv positions >= 2^29 are padding), the finite ``NEG_INF``, tanh
softcap, explicit scale, Dk and Dv independent (each at most 256), and the
``l == 0`` guard.  The plain version is
:func:`repro_torch.kernels.ref.sdpa_ref`; the two agree on every query row
that sees at least one key.

Built by :mod:`.nvcc` at first use; nothing is built at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .nvcc import CudaLibrary, check_launch

LIB = CudaLibrary("flash_attention", {
    "flash_attention_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        ctypes.c_int),
})
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last reset (a plain integer: the
# wrapper adds one where it launches, nowhere else)
launches = 0


def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device,
           dtype: torch.dtype) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, sliding_window: Optional[int] = None,
                    logit_softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``[B, Sq, Hq, Dv]``.

    ``q``: ``[B, Sq, Hq, Dk]``, ``k``: ``[B, Skv, Hkv, Dk]``, ``v``:
    ``[B, Skv, Hkv, Dv]``, all float32 or all bfloat16; positions int32
    ``[B, Sq]`` / ``[B, Skv]``.  Every tensor contiguous, Hq a multiple of
    Hkv, Dk and Dv at most 256.  Raises on anything else, on a failed build
    and on a refused launch.
    """
    global launches
    if q.device.type != "cuda":
        raise ValueError("flash_attention launches on CUDA tensors only; "
                         "CPU callers use ref.sdpa_ref")
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    _check("q", q, 4, dev, q.dtype)
    _check("k", k, 4, dev, q.dtype)
    _check("v", v, 4, dev, q.dtype)
    _check("q_positions", q_positions, 2, dev, torch.int32)
    _check("kv_positions", kv_positions, 2, dev, torch.int32)
    b, sq, hq, dk = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != dk:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if not (0 < dk <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims Dk = {dk}, Dv = {dv} outside "
                         f"1..{MAX_HEAD_DIM}")
    if tuple(q_positions.shape) != (b, sq):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} != "
                         f"{(b, sq)}")
    if tuple(kv_positions.shape) != (b, skv):
        raise ValueError(f"kv_positions {tuple(kv_positions.shape)} != "
                         f"{(b, skv)}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if min(b, sq, skv, hq) < 1:
        raise ValueError("flash_attention needs B, Sq, Skv and Hq >= 1")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=dev)
    scale = float(scale) if scale is not None else dk ** -0.5
    lib = LIB.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, sq,
            skv, hq, hkv, dk, dv, scale, float(logit_softcap), int(causal),
            int(sliding_window or 0), stream)
    check_launch("flash_attention", err)
    launches += 1
    return out
