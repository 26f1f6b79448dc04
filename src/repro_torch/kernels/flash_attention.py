"""Online-softmax GQA attention — the hand-written Hopper kernels and their wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``).  The CUDA sources are
``csrc/flash_attention.cu`` (the launcher and the design notes) and its
headers; the launcher picks one of three variants from the dtype and the
shapes alone, and :func:`variant` is its twin here:

- ``prefill_tc`` — bf16, (Dk, Dv) in :data:`PREFILL_TC_DIMS`: (64, 64),
  hubert's (80, 80) (computed at 128 columns, the padding read as zeros),
  (128, 128) and deepseek-v2's MLA (192, 128); more than 64 query rows per
  kv head (Sq x group).  Bound by operations.  Q and 128-key K/V tiles
  arrive by TMA into a shared-memory ring fed by a producer warp; two
  consumer warpgroups run Q.K^T and P.V on ``wgmma`` (bf16 tensor cores,
  fp32 accumulators), the softmax in fp32 on the accumulator fragment,
  and skip the kv tiles the positions hide.  P.V runs twice, on P's bf16 high
  and low parts, which keeps ~16 bits of P at (Dk + 2 Dv) / (Dk + Dv) times
  the operations (1.5x at Dk = Dv, 1.4x at MLA's): a single bf16 P misses
  the two-ulp output limit in early causal rows.
- ``decode_split`` — f32 or bf16, Dk = Dv in {64, 128}, at most 64 query
  rows per kv head (glm4-9b decode: 1 x 16).  Bound by bytes.  The group's
  q heads are the rows of one tile, so each K/V byte is read once per kv
  head, and the kv sweep is split across blocks (:func:`decode_splits`);
  fp32 partials go to a scratch this wrapper allocates and a second kernel
  merges them.  On request (``return_lse``) the merge also writes each
  row's fp32 log-sum-exp ``[B, Sq, Hq]``, which a seq-sharded decode's
  ranks exchange to combine their chunks (``models.attention``).
- ``simt`` — everything else (f32 prefill, other head dims, other Dk !=
  Dv pairs, (80, 80) and (192, 128) at 64 rows or fewer): one block per
  (batch, q head, q tile) on the fp32 CUDA cores.

Semantics follow the Pallas kernel in every variant: masking by position
(causal, sliding window, kv positions >= 2^29 are padding), the finite
``NEG_INF``, tanh softcap, explicit scale, GQA by index, Dk and Dv each at
most 256, and the ``l == 0`` guard.  Every variant computes in fp32 and
rounds the output once.  The plain version is
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
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
        + [ctypes.c_void_p, ctypes.c_longlong,
           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_variant": (
        [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)],
        ctypes.c_int),
})
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the launcher's variant codes, in order
VARIANTS = ("simt", "prefill_tc", "decode_split")
DECODE_MAX_ROWS = 64        # Sq x group served by decode_split
DECODE_SPLIT_DIMS = ((64, 64), (128, 128))
PREFILL_TC_DIMS = DECODE_SPLIT_DIMS + ((80, 80), (192, 128))
_TARGET_BLOCKS = 264        # decode_split: two waves of 132 SMs
_MIN_SPLIT_KEYS = 64

# kernel launches since the count was last reset (plain integers: the
# wrapper adds one where it launches, nowhere else), in all, by variant,
# and those that wrote the log-sum-exp output
launches = 0
variant_launches = {name: 0 for name in VARIANTS}
lse_launches = 0


def variant(dtype: torch.dtype, sq: int, hq: int, hkv: int, dk: int,
            dv: int) -> str:
    """The variant the launcher takes for these shapes (its twin)."""
    if (dk, dv) not in PREFILL_TC_DIMS:
        return "simt"
    few_rows = sq * (hq // hkv) <= DECODE_MAX_ROWS
    if few_rows and (dk, dv) in DECODE_SPLIT_DIMS:
        return "decode_split"
    if not few_rows and dtype == torch.bfloat16:
        return "prefill_tc"
    return "simt"


def decode_splits(b: int, hkv: int, skv: int) -> int:
    """decode_split's blocks along the kv sweep, from the shapes alone:
    about two waves of the card's SMs, at least 64 keys a split."""
    want = -(-_TARGET_BLOCKS // (b * hkv))
    return max(1, min(want, skv // _MIN_SPLIT_KEYS))


def decode_scratch_floats(b: int, hkv: int, skv: int, rows: int,
                          dv: int) -> int:
    """decode_split's fp32 scratch: an (m, l) pair per (b, kv head, split,
    row), padded to 16 bytes, then those rows' ``dv`` accumulators."""
    slots = b * hkv * decode_splits(b, hkv, skv) * rows
    return -(-2 * slots // 4) * 4 + slots * dv


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
                    scale: Optional[float] = None, return_lse: bool = False):
    """Launch the kernel on CUDA tensors; returns ``[B, Sq, Hq, Dv]``, or
    with ``return_lse`` the pair ``(out, lse)``: ``lse [B, Sq, Hq]`` fp32,
    each row's log-sum-exp of its scaled, capped and masked scores (-inf
    where the row saw no key), which ``decode_split`` alone computes.

    ``q``: ``[B, Sq, Hq, Dk]``, ``k``: ``[B, Skv, Hkv, Dk]``, ``v``:
    ``[B, Skv, Hkv, Dv]``, all float32 or all bfloat16; positions int32
    ``[B, Sq]`` / ``[B, Skv]``.  Every tensor contiguous, Hq a multiple of
    Hkv, Dk and Dv at most 256; q, k and v 16-byte aligned where the
    variant is ``prefill_tc`` or ``decode_split``.  Raises on anything else,
    on a failed build and on a refused launch.
    """
    global launches, lse_launches
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
    name = variant(q.dtype, sq, hq, hkv, dk, dv)
    if name != "simt" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} needs q, k and v 16-byte aligned")
    if return_lse and name != "decode_split":
        raise ValueError(f"the log-sum-exp comes from decode_split alone; "
                         f"these shapes take {name} (Dk = {dk}, Dv = {dv}, "
                         f"{sq * (hq // hkv)} rows a kv head)")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, sq, hq), dtype=torch.float32, device=dev)
           if return_lse else None)
    scratch = None
    if name == "decode_split":
        scratch = torch.empty(decode_scratch_floats(b, hkv, skv,
                                                    sq * (hq // hkv), dv),
                              dtype=torch.float32, device=dev)
    scale = float(scale) if scale is not None else dk ** -0.5
    chosen = ctypes.c_int(-1)
    lib = LIB.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, sq,
            skv, hq, hkv, dk, dv, scale, float(logit_softcap), int(causal),
            int(sliding_window or 0),
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(), ctypes.byref(chosen),
            None if lse is None else lse.data_ptr(), stream)
    check_launch("flash_attention", err)
    if VARIANTS[chosen.value] != name:
        raise RuntimeError(f"flash_attention: the launcher took "
                           f"{VARIANTS[chosen.value]}, variant() says {name}")
    launches += 1
    variant_launches[name] += 1
    lse_launches += bool(return_lse)
    return (out, lse) if return_lse else out
