"""Mamba2 SSD chunked scan — the hand-written Hopper kernels and their wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``
/ ``_ssd_kernel``).  The CUDA sources are ``csrc/ssd_scan.cu`` (the
launcher and the design notes) and its headers; the launcher picks one of
two variants from the dtype and the shapes alone, and :func:`variant` is
its twin here:

- ``tc`` — bf16 x/B/C, P = 64, N in {64, 128}, the chunk a multiple of 64
  up to 256 (mamba2-780m prefill).  Two kernels per call, on ``wgmma``
  (bf16 tensor cores, fp32 accumulators) fed by TMA: ``ssd_state``
  carries the fp32 state through the chunks of one (b, head, 64 state
  columns) in its accumulator and writes the state entering each chunk
  (bf16) with the chunk's dacum and dt to scratch this wrapper allocates;
  ``ssd_chunk_scan`` computes y for every (b, chunk, 64-row strip, 16
  heads) in parallel from those.  The state product takes the weighted x
  as bf16 hi + lo parts (a single bf16 rounding misses the state's atol
  2e-3).
- ``simt`` — everything else (f32, chunk 32, P != 64, other N).  The name
  is historical: ``tc``'s two-kernel plan on split-TF32 ``mma.sync`` (each
  fp32 operand as two TF32 parts, three products for one; bf16 exact),
  with fp32 entering states in scratch, which keeps f32 within 2e-5 of
  max |y|: ``state_kernel`` per (64 state columns, head, b) carries the
  state through the chunks, ``chunk_kernel`` per (b, chunk, 64-row
  strip, 2 heads) computes y, every chunk in parallel.

The backward (:func:`ssd_scan_backward`) has no Pallas counterpart: the
reference differentiates its plain function.  It computes that gradient
in three phases: the state entering each chunk; a reverse pass over the
chunks carrying the state's gradient from the final state's; then per
chunk the intra-chunk and carried terms' gradients, with B's, C's and A's
sums over heads and sequence taken in a fixed order (no atomics: two
calls give equal bits).  Its variant is the forward's
(:func:`backward_variant`):

- ``tc`` (``csrc/ssd_backward_tc.cuh``) — the forward ``tc``'s shapes.
  The entering states come from the forward's ``ssd_state`` kernel (bf16,
  with each chunk's dacum and dt); the third phase puts every product on
  ``wgmma`` as 64 x 64 bf16 tiles with fp32 accumulators, one block per
  (b, chunk, 2 heads at N 64 / 1 at N 128) computing C B^T once for its
  heads, the decays applied in fp32 before each tile's one bf16
  rounding; dB and dC leave as per-head-group partials.  Plain twin:
  :func:`~repro_torch.kernels.ref.ssd_bwd_tc_ref`.
- ``simt`` (``csrc/ssd_backward.cuh``) — everything else: the same
  phases with every product on split-TF32 ``mma.sync`` as the forward
  ``simt``: each chunk's own state in parallel and a scan for the (fp32)
  entering states, the reverse pass as ``tc``'s, and one block per (b,
  chunk, head group: :func:`simt_backward_heads`) in the third phase.
  Plain twin:
  :func:`~repro_torch.kernels.ref.ssd_bwd_x3_ref`.  ``variant="simt"``
  runs it at any shape, to time it beside ``tc``.

The plain versions are :func:`repro_torch.kernels.ref.ssd_ref` (``simt``'s
split products: :func:`~repro_torch.kernels.ref.ssd_x3_ref`) and, per
``tc`` kernel, :func:`~repro_torch.kernels.ref.ssd_states` and
:func:`~repro_torch.kernels.ref.ssd_outputs`; the backward's is
:func:`~repro_torch.kernels.ref.ssd_bwd_ref`.  Built by :mod:`.nvcc` at
first use; nothing is built at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.obs.regions import region

from .nvcc import CudaLibrary, check_launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
LIB = CudaLibrary("ssd_scan", {
    "ssd_scan_launch": (
        [_P] * 10 + [_I] * 7 + [_LL, _LL, ctypes.POINTER(_I), _P], _I),
    "ssd_scan_variant": (
        [_I] * 7 + [ctypes.POINTER(_LL)] * 2, _I),
    "ssd_tc_state_launch": ([_P] * 8 + [_I] * 5 + [_P], _I),
    "ssd_tc_chunk_launch": ([_P] * 6 + [_I] * 5 + [_P], _I),
    "ssd_scan_backward_variant": (
        [_I] * 7 + [ctypes.POINTER(_LL)], _I),
    "ssd_scan_backward_launch": (
        [_P] * 15 + [_LL] + [_I] * 8 + [ctypes.POINTER(_I), _P], _I),
})
MAX_HEAD_DIM = 64
MAX_STATE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the launcher's variant codes, in order
VARIANTS = ("simt", "tc")
TC_HEAD_DIM = 64
TC_STATES = (64, 128)
TC_TILE = 64                 # tc's chunk is a multiple of it
TC_MAX_CHUNK = 256

# kernel launches since the counts were last reset (plain integers: the
# wrappers add one where they launch, nowhere else): calls of ssd_scan in
# all and by variant, launches of each of tc's two kernels, and calls of
# the backward in all and by variant
launches = 0
variant_launches = {name: 0 for name in VARIANTS}
phase_launches = {"ssd_state": 0, "ssd_chunk_scan": 0}
backward_launches = 0
backward_variant_launches = {name: 0 for name in VARIANTS}


def variant(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The variant the launcher takes for these shapes (its twin)."""
    if (dtype == torch.bfloat16 and p == TC_HEAD_DIM and n in TC_STATES
            and chunk % TC_TILE == 0 and 0 < chunk <= TC_MAX_CHUNK):
        return "tc"
    return "simt"


def tc_scratch(b: int, s: int, h: int, n: int, chunk: int
               ) -> Tuple[int, int]:
    """tc's scratch: the entering states (bf16 elements, ``[B, nc, H, P,
    N]``) and each chunk's dacum and dt (floats, ``[B, nc, H, 2, L]``)."""
    bch = b * (s // chunk) * h
    return bch * TC_HEAD_DIM * n, bch * 2 * chunk


def simt_scratch(b: int, s: int, h: int, p: int, n: int, chunk: int
                 ) -> Tuple[int, int]:
    """``simt``'s scratch: the entering states (floats, ``[B, nc, H, P,
    N]``) and each chunk's dacum and dt (floats, ``[B, nc, H, 2, L]``)."""
    bch = b * (s // chunk) * h
    return bch * p * n, bch * 2 * chunk


def scratch(name: str, b: int, s: int, h: int, p: int, n: int, chunk: int
            ) -> Tuple[int, int]:
    """The forward's scratch for variant ``name``, as the launcher's
    ``ssd_scan_variant`` reports it (entering states in elements: bf16 for
    ``tc``, fp32 for ``simt``; dacum / dt in floats)."""
    return (tc_scratch(b, s, h, n, chunk) if name == "tc"
            else simt_scratch(b, s, h, p, n, chunk))


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


def _aligned(name: str, *tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs x, b_mat, c_mat and h0 16-byte "
                         f"aligned")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _shapes(fn: str, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
            **states: Optional[torch.Tensor]
            ) -> Tuple[int, int, int, int, int]:
    """Check the operands that :func:`ssd_scan` and its backward both take
    (``states``: the ``[B, H, P, N]`` float32 ones, None allowed);
    ``(B, S, H, P, N)``."""
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
        raise ValueError(f"{fn} takes n_groups == 1, got {g}")
    _check("x", x, (bsz, s, h, p), dev, x.dtype)
    _check("dt", dt, (bsz, s, h), dev, torch.float32)
    _check("a", a, (h,), dev, torch.float32)
    _check("b_mat", b_mat, (bsz, s, 1, n), dev, x.dtype)
    _check("c_mat", c_mat, (bsz, s, 1, n), dev, x.dtype)
    for name, t in states.items():
        if t is not None:
            _check(name, t, (bsz, h, p, n), dev, torch.float32)
    if chunk < 1 or s % chunk:
        raise ValueError(f"S = {s} is not a multiple of chunk = {chunk}")
    if not (0 < p <= MAX_HEAD_DIM):
        raise ValueError(f"head dim P = {p} outside 1..{MAX_HEAD_DIM}")
    if not (0 < n <= MAX_STATE) or n % 4:
        raise ValueError(f"state dim N = {n} must be a multiple of 4 in "
                         f"4..{MAX_STATE}")
    if bsz == 0 or s == 0 or h == 0:
        raise ValueError(f"{fn} needs B, S and H >= 1")
    return bsz, s, h, p, n


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int = 256,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels on CUDA tensors; returns ``(y, final_state)``.

    ``x``: ``[B, S, H, P]`` float32 or bfloat16; ``dt``: ``[B, S, H]``
    float32 (softplus'd); ``a``: ``[H]`` float32; ``b_mat``/``c_mat``:
    ``[B, S, 1, N]`` in x's type; ``h0``: ``[B, H, P, N]`` float32 or None
    (zeros).  ``S % chunk == 0``, P <= 64, N <= 128 and a multiple of 4;
    for ``tc`` x, b_mat, c_mat and h0 16-byte aligned.  Returns ``y [B, S,
    H, P]`` in x's type and the final state ``[B, H, P, N]`` float32.
    Raises on anything else, on a failed build and on a refused launch.
    """
    global launches
    if x.device.type != "cuda":
        raise ValueError("ssd_scan launches on CUDA tensors only; CPU "
                         "callers use ref.ssd_ref")
    dev = x.device
    bsz, s, h, p, n = _shapes("ssd_scan", x, dt, a, b_mat, c_mat, chunk,
                              h0=h0)
    if h0 is None:
        h0 = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
    name = variant(x.dtype, p, n, chunk)
    if name == "tc":
        _aligned(name, x, b_mat, c_mat, h0)
    n_states, n_meta = scratch(name, bsz, s, h, p, n, chunk)
    states = torch.empty(n_states, device=dev, dtype=torch.bfloat16
                         if name == "tc" else torch.float32)
    meta = torch.empty(n_meta, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    chosen = ctypes.c_int(-1)
    lib = LIB.load()
    with region("repro.launch.ssd"), torch.cuda.device(dev):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), h0.data_ptr(), y.data_ptr(), final.data_ptr(),
            states.data_ptr(), meta.data_ptr(), _DTYPES[x.dtype], bsz, s, h,
            p, n, chunk, states.numel(), meta.numel(), ctypes.byref(chosen),
            _stream(dev))
    check_launch("ssd_scan", err)
    if VARIANTS[chosen.value] != name:
        raise RuntimeError(f"ssd_scan: the launcher took "
                           f"{VARIANTS[chosen.value]}, variant() says {name}")
    launches += 1
    variant_launches[name] += 1
    if name == "tc":
        for phase in phase_launches:
            phase_launches[phase] += 1
    return y, final


def _tc_shapes(x: torch.Tensor, b_mat: torch.Tensor, chunk: int
               ) -> Tuple[int, int, int, int]:
    if x.device.type != "cuda":
        raise ValueError("the tc kernels launch on CUDA tensors only")
    if x.dim() != 4 or b_mat.dim() != 4:
        raise ValueError("x and b_mat must be 4-D")
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    if chunk < 1 or s % chunk or variant(x.dtype, p, n, chunk) != "tc":
        raise ValueError(f"not a tc shape: {x.dtype}, P {p}, N {n}, "
                         f"S {s}, chunk {chunk}")
    return bsz, s, h, n


def tc_states(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b_mat: torch.Tensor, *, chunk: int, h0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``tc``'s first kernel alone (``ssd_state``), for checking it
    against :func:`ref.ssd_states`.  Returns the states entering each
    chunk ``[B, nc, H, P, N]`` bf16, each chunk's dacum and dt ``[B, nc,
    H, 2, L]`` float32 and the final state ``[B, H, P, N]`` float32."""
    bsz, s, h, n = _tc_shapes(x, b_mat, chunk)
    dev, nc = x.device, s // chunk
    _check("dt", dt, (bsz, s, h), dev, torch.float32)
    _check("a", a, (h,), dev, torch.float32)
    _check("b_mat", b_mat, (bsz, s, 1, n), dev, x.dtype)
    _check("h0", h0, (bsz, h, TC_HEAD_DIM, n), dev, torch.float32)
    _check("x", x, tuple(x.shape), dev, x.dtype)
    _aligned("ssd_state", x, b_mat, h0)
    states = torch.empty((bsz, nc, h, TC_HEAD_DIM, n), dtype=torch.bfloat16,
                         device=dev)
    meta = torch.empty((bsz, nc, h, 2, chunk), dtype=torch.float32,
                       device=dev)
    final = torch.empty((bsz, h, TC_HEAD_DIM, n), dtype=torch.float32,
                        device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.ssd_tc_state_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
            h0.data_ptr(), states.data_ptr(), meta.data_ptr(),
            final.data_ptr(), bsz, s, h, n, chunk, _stream(dev))
    check_launch("ssd_state", err)
    phase_launches["ssd_state"] += 1
    return states, meta, final


def tc_outputs(x: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
               states: torch.Tensor, meta: torch.Tensor, *, chunk: int
               ) -> torch.Tensor:
    """``tc``'s second kernel alone (``ssd_chunk_scan``): y ``[B, S, H,
    P]`` bf16 from the entering states and dacum / dt that
    :func:`tc_states` returns, for checking it against
    :func:`ref.ssd_outputs`."""
    bsz, s, h, n = _tc_shapes(x, b_mat, chunk)
    dev, nc = x.device, s // chunk
    _check("x", x, tuple(x.shape), dev, x.dtype)
    _check("b_mat", b_mat, (bsz, s, 1, n), dev, x.dtype)
    _check("c_mat", c_mat, (bsz, s, 1, n), dev, x.dtype)
    _check("states", states, (bsz, nc, h, TC_HEAD_DIM, n), dev,
           torch.bfloat16)
    _check("meta", meta, (bsz, nc, h, 2, chunk), dev, torch.float32)
    _aligned("ssd_chunk_scan", x, b_mat, c_mat, states, meta)
    y = torch.empty_like(x)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.ssd_tc_chunk_launch(
            x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            states.data_ptr(), meta.data_ptr(), y.data_ptr(), bsz, s, h, n,
            chunk, _stream(dev))
    check_launch("ssd_chunk_scan", err)
    phase_launches["ssd_chunk_scan"] += 1
    return y


def backward_variant(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The backward variant the launcher takes for these shapes (its twin):
    ``tc`` where the forward takes it, ``simt`` otherwise."""
    return variant(dtype, p, n, chunk)


def backward_heads_per_block(n: int, h: int) -> int:
    """Heads of one ``tc`` backward ``chunk_tc`` block: two at N 64 when H
    is even, else one; dB's and dC's partials are per such group."""
    return 2 if n == 64 and h % 2 == 0 else 1


def simt_backward_heads(n: int, dtype: torch.dtype) -> int:
    """Heads of one ``simt`` backward ``chunk_kernel`` block: two in bf16 at
    N <= 64, else one (H need not divide: the last group may hold fewer);
    dB's and dC's partials are per such group."""
    return 2 if dtype == torch.bfloat16 and n <= 64 else 1


def backward_scratch_floats(name: str, b: int, s: int, h: int, p: int,
                            n: int, chunk: int, dtype: torch.dtype) -> int:
    """The backward's fp32 scratch for x's ``dtype``.  ``simt``: the
    entering states and the leaving states' gradients ``[B, nc, H, P, N]``,
    each chunk's dacum and dt ``[B, nc, H, 2, L]``, two ``[B, nc, H]``
    columns (each part padded to 16 bytes), and dB's and dC's partials per
    head group (:func:`simt_backward_heads`).
    ``tc``: the entering states (bf16) and each chunk's dacum and dt, the
    forward kernel's final state and a zero h0 ``[B, H, P, N]``, the
    leaving states' gradients, two ``[B, nc, H]`` columns (padded to 16
    bytes), and dB's and dC's partials per head group."""
    bch = b * (s // chunk) * h
    col = -(-bch // 4) * 4
    if name != "tc":
        groups = -(-h // simt_backward_heads(n, dtype))
        parts = b * (s // chunk) * groups * chunk * n
        return (2 * bch * p * n + -(-bch * 2 * chunk // 4) * 4 + 2 * col
                + 2 * parts)
    parts = bch // backward_heads_per_block(n, h) * chunk * n
    return (bch * p * n // 2 + bch * 2 * chunk + 2 * b * h * p * n
            + bch * p * n + 2 * col + 2 * parts)


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b_mat: torch.Tensor, c_mat: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: torch.Tensor,
                      dfinal: Optional[torch.Tensor], *, chunk: int,
                      variant: Optional[str] = None):
    """Launch the backward kernels on CUDA tensors: the gradients ``(dx,
    ddt, da, db_mat, dc_mat, dh0)`` of :func:`ssd_scan` for ``dy`` (x's
    shape and dtype) and ``dfinal`` (``[B, H, P, N]`` float32, None:
    zero).  Arguments as :func:`ssd_scan` takes them (``h0`` None: zeros);
    each gradient in its input's dtype, ``dh0`` float32.  Plain version:
    :func:`ref.ssd_bwd_ref` (``tc``'s roundings: :func:`ref.ssd_bwd_tc_ref`).
    The variant is :func:`backward_variant`'s; ``variant="simt"`` runs the
    CUDA-core kernels at any shape instead (to time them beside ``tc``).
    Raises on anything else, on a failed build and on a refused launch.
    """
    global backward_launches
    if x.device.type != "cuda":
        raise ValueError("ssd_scan_backward launches on CUDA tensors only; "
                         "CPU callers use ref.ssd_bwd_ref")
    dev = x.device
    bsz, s, h, p, n = _shapes("ssd_scan_backward", x, dt, a, b_mat, c_mat,
                              chunk, h0=h0, dfinal=dfinal)
    _check("dy", dy, (bsz, s, h, p), dev, x.dtype)
    name = backward_variant(x.dtype, p, n, chunk)
    if variant not in (None, "simt", name):
        raise ValueError(f"backward variant {variant!r} does not take these "
                         f"shapes (backward_variant() says {name!r})")
    name = variant or name
    if name == "tc":
        _aligned("the tc backward", x, b_mat, c_mat, dy,
                 *(() if h0 is None else (h0,)))
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    da = torch.empty_like(a)
    db, dc = torch.empty_like(b_mat), torch.empty_like(c_mat)
    dh0 = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    scratch = torch.empty(backward_scratch_floats(name, bsz, s, h, p, n,
                                                  chunk, x.dtype),
                          dtype=torch.float32, device=dev)
    chosen = ctypes.c_int(-1)
    lib = LIB.load()
    with region("repro.launch.ssd_bwd"), torch.cuda.device(dev):
        err = lib.ssd_scan_backward_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), None if h0 is None else h0.data_ptr(),
            dy.data_ptr(), None if dfinal is None else dfinal.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
            dc.data_ptr(), dh0.data_ptr(), scratch.data_ptr(),
            scratch.numel(), _DTYPES[x.dtype], bsz, s, h, p, n, chunk,
            -1 if variant is None else VARIANTS.index(name),
            ctypes.byref(chosen), _stream(dev))
    check_launch("ssd_scan_backward", err)
    if VARIANTS[chosen.value] != name:
        raise RuntimeError(f"ssd_scan_backward: the launcher took "
                           f"{VARIANTS[chosen.value]}, backward_variant() "
                           f"says {name}")
    backward_launches += 1
    backward_variant_launches[name] += 1
    return dx, ddt, da, db, dc, dh0
