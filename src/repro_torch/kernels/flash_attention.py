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
  merges them.
- ``simt`` — everything else (f32 prefill, other head dims, other Dk !=
  Dv pairs, (80, 80) and (192, 128) at 64 rows or fewer): one block per
  (batch, q head, 128 or 16 query rows).  The name is historical (it first
  ran on the fp32 CUDA cores): ``Q K^T`` and ``P V`` run on the tensor
  cores as split-TF32 ``mma.sync`` products (each fp32 operand in two TF32
  parts, three products for each, ~22 of fp32's 24 bits; bf16 operands are
  exact), K/V tiles arriving by ``cp.async``.  Plain twin of that
  arithmetic: :func:`repro_torch.kernels.ref.sdpa_x3_ref`.

On request (``return_lse``) every variant also writes each row's fp32
log-sum-exp ``[B, Sq, Hq]``, with the output's bits unchanged: a
seq-sharded decode's ranks exchange it to combine their chunks
(``models.attention``), and the backward recomputes P from it.

The backward (:func:`flash_attention_backward`) has no Pallas
counterpart: the reference differentiates its plain function.  It
computes that gradient from the forward's output and lse, after a
``D = rowsum(dO O)`` pre-pass, with no atomics (two calls give equal
bits), in one of two variants the launcher picks from the dtype and the
shapes alone (:func:`backward_variant` is its twin):

- ``tc`` (``csrc/flash_backward_tc.cuh``) — bf16, (Dk, Dv) in
  :data:`BACKWARD_TC_DIMS` ((64, 64), (80, 80), (128, 128) and MLA's
  (192, 128)), more than 64 query rows per kv head.  FlashAttention-2's
  backward on ``wgmma``: dK and dV per (64 keys, b, kv head) over a TMA
  ring of Q and dO tiles, P and dS formed in fp32 and each rounded once to
  bf16 as a register operand, dK and dV in fp32 registers; when B x Hkv x
  key tiles falls short of two waves of the card the GQA group's q heads
  are split over blocks (:func:`backward_splits`) whose fp32 partials one
  pass sums in order; dQ per (64 rows, b, q head) over a ring of K/V
  tiles.  At (192, 128) dK and dV do not fit one warpgroup's registers
  beside S and dP, so two warpgroups share each tile (S, P and dV; dP, dS
  and dK), P handed over in shared memory.  Plain twin:
  :func:`repro_torch.kernels.ref.sdpa_bwd_tc_ref`.
- ``simt`` (``csrc/flash_backward.cuh``) — everything else (f32, other
  head dims and pairs, and 64 rows or fewer per kv head): dK/dV per (b,
  kv head, key tile) and dQ per (b, q head, q tile), every product as the
  forward ``simt``'s split-TF32 ``mma.sync`` (P and dS split like any
  fp32 operand; plain twin :func:`repro_torch.kernels.ref.sdpa_bwd_x3_ref`).
  ``variant="simt"`` runs it at any shape, to time it beside ``tc``.

Their plain version is :func:`repro_torch.kernels.ref.sdpa_bwd_ref`.

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

from repro_torch.obs.regions import region

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
    "flash_attention_backward_variant": (
        [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)],
        ctypes.c_int),
    "flash_attention_backward_launch": (
        [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 8
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
        ctypes.c_int),
})
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the launcher's variant codes, in order
VARIANTS = ("simt", "prefill_tc", "decode_split")
DECODE_MAX_ROWS = 64        # Sq x group served by decode_split
DECODE_SPLIT_DIMS = ((64, 64), (128, 128))
PREFILL_TC_DIMS = DECODE_SPLIT_DIMS + ((80, 80), (192, 128))
_TARGET_BLOCKS = 264        # decode_split, dkdv_tc: two waves of 132 SMs
_MIN_SPLIT_KEYS = 64
# the backward launcher's variant codes, in order, and tc's (Dk, Dv) pairs
BACKWARD_VARIANTS = ("simt", "tc")
BACKWARD_TC_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))
_BWD_TILE = 64              # keys of a dkdv_tc block

# kernel launches since the count was last reset (plain integers: the
# wrappers add one where they launch, nowhere else): forward calls in all,
# by variant, and those that wrote the log-sum-exp output; backward calls
# in all and by variant
launches = 0
variant_launches = {name: 0 for name in VARIANTS}
lse_launches = 0
backward_launches = 0
backward_variant_launches = {name: 0 for name in BACKWARD_VARIANTS}


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


def backward_variant(dtype: torch.dtype, sq: int, hq: int, hkv: int,
                     dk: int, dv: int) -> str:
    """The backward variant the launcher takes for these shapes (its
    twin): ``tc`` for bf16 at :data:`BACKWARD_TC_DIMS` with more than
    :data:`DECODE_MAX_ROWS` query rows per kv head, ``simt`` otherwise
    (f32; other head dims; decode_split's few-row shapes under grad)."""
    if (dtype == torch.bfloat16 and (dk, dv) in BACKWARD_TC_DIMS
            and sq * (hq // hkv) > DECODE_MAX_ROWS):
        return "tc"
    return "simt"


def backward_splits(b: int, hkv: int, skv: int, group: int
                    ) -> tuple:
    """``tc``'s shares of a GQA group's q heads over ``dkdv_tc`` blocks,
    from the shapes alone: one while B x Hkv x 64-key tiles fills two
    waves of the card, else enough to; ``(shares, heads a share)``."""
    tiles = b * hkv * -(-skv // _BWD_TILE)
    want = 1 if tiles >= _TARGET_BLOCKS else -(-_TARGET_BLOCKS // tiles)
    per = -(-group // min(want, group))
    return -(-group // per), per


def backward_scratch_floats(name: str, b: int, sq: int, skv: int, hq: int,
                            hkv: int, dk: int, dv: int) -> int:
    """The backward's fp32 scratch: D for every row (padded to 16 bytes),
    then, where ``tc`` splits the group, the shares' dK and dV partials."""
    rows = -(-b * sq * hq // 4) * 4
    if name != "tc":
        return rows
    shares, _ = backward_splits(b, hkv, skv, hq // hkv)
    return rows + (0 if shares == 1 else shares * b * skv * hkv * (dk + dv))


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


def _shapes(q, k, v, q_positions, kv_positions, sliding_window):
    """Check the forward's operands; ``(B, Sq, Skv, Hq, Hkv, Dk, Dv)``."""
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
    return b, sq, skv, hq, hkv, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, sliding_window: Optional[int] = None,
                    logit_softcap: float = 0.0,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Launch the kernel on CUDA tensors; returns ``[B, Sq, Hq, Dv]``, or
    with ``return_lse`` the pair ``(out, lse)``: ``lse [B, Sq, Hq]`` fp32,
    each row's log-sum-exp of its scaled, capped and masked scores, which
    every variant writes on request without changing the output's bits.
    A row that saw no key gets at most NEG_INF / 2 (NEG_INF + log of the
    hidden keys its tiles held, or -inf where every tile was skipped), so
    it weighs nothing in a merge; its output is not defined.

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
    b, sq, skv, hq, hkv, dk, dv = _shapes(q, k, v, q_positions, kv_positions,
                                          sliding_window)
    name = variant(q.dtype, sq, hq, hkv, dk, dv)
    if name != "simt" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} needs q, k and v 16-byte aligned")
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
    with region("repro.launch.flash"), torch.cuda.device(dev):
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


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             q_positions: torch.Tensor,
                             kv_positions: torch.Tensor, causal: bool = True,
                             sliding_window: Optional[int] = None,
                             logit_softcap: float = 0.0,
                             scale: Optional[float] = None,
                             variant: Optional[str] = None):
    """Launch the backward kernels on CUDA tensors: ``(dq, dk, dv)`` of
    :func:`flash_attention` for the output gradient ``dout``, from the
    forward's ``out`` and ``lse`` (``return_lse=True``).  The variant is
    :func:`backward_variant`'s; ``variant="simt"`` runs the CUDA-core
    kernels at any shape instead (to time them beside ``tc``).

    ``out`` and ``dout`` are ``[B, Sq, Hq, Dv]`` in q's dtype, ``lse``
    ``[B, Sq, Hq]`` fp32; the rest as :func:`flash_attention` takes it,
    every variant's shapes included.  Each gradient is in its input's
    shape and dtype.  Plain version: :func:`ref.sdpa_bwd_ref`.  Raises on
    anything else, on a failed build and on a refused launch.
    """
    global backward_launches
    if q.device.type != "cuda":
        raise ValueError("flash_attention_backward launches on CUDA tensors "
                         "only; CPU callers use ref.sdpa_bwd_ref")
    dev = q.device
    b, sq, skv, hq, hkv, dk, dv = _shapes(q, k, v, q_positions, kv_positions,
                                          sliding_window)
    for name, t in (("out", out), ("dout", dout)):
        _check(name, t, 4, dev, q.dtype)
        if tuple(t.shape) != (b, sq, hq, dv):
            raise ValueError(f"{name} {tuple(t.shape)} != {(b, sq, hq, dv)}")
    _check("lse", lse, 3, dev, torch.float32)
    if tuple(lse.shape) != (b, sq, hq):
        raise ValueError(f"lse {tuple(lse.shape)} != {(b, sq, hq)}")
    name = backward_variant(q.dtype, sq, hq, hkv, dk, dv)
    if variant not in (None, "simt", name):
        raise ValueError(f"backward variant {variant!r} does not take these "
                         f"shapes (backward_variant() says {name!r})")
    name = variant or name
    if name == "tc" and any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("the tc backward needs q, k, v and dout 16-byte "
                         "aligned")
    dq, dk_, dv_ = (torch.empty_like(t) for t in (q, k, v))
    scratch = torch.empty(backward_scratch_floats(name, b, sq, skv, hq, hkv,
                                                  dk, dv),
                          dtype=torch.float32, device=dev)
    scale = float(scale) if scale is not None else dk ** -0.5
    chosen = ctypes.c_int(-1)
    lib = LIB.load()
    with region("repro.launch.flash_bwd"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_backward_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), dq.data_ptr(), dk_.data_ptr(),
            dv_.data_ptr(), scratch.data_ptr(), scratch.numel(),
            _DTYPES[q.dtype], b, sq, skv, hq, hkv, dk, dv, scale,
            float(logit_softcap), int(causal), int(sliding_window or 0),
            -1 if variant is None else BACKWARD_VARIANTS.index(name),
            ctypes.byref(chosen), stream)
    check_launch("flash_attention_backward", err)
    if BACKWARD_VARIANTS[chosen.value] != name:
        raise RuntimeError(f"flash_attention_backward: the launcher took "
                           f"{BACKWARD_VARIANTS[chosen.value]}, "
                           f"backward_variant() says {name}")
    backward_launches += 1
    backward_variant_launches[name] += 1
    return dq, dk_, dv_
