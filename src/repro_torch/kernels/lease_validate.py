"""Batched TL2 certification — the hand-written Hopper kernel and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/lease_validate.py``
(``lease_validate`` / ``_validate_kernel``).  The CUDA source is
``csrc/lease_validate.cu``: one warp per transaction gathering straight
from the L2-resident version table, instead of the TPU's chunk-local
masked compare.  The kernel is bound by bytes; at the simulator's shapes
(8-16 transactions a drain) it is bound by the launch.

The shared library is built with ``nvcc`` at first use, keyed by a hash of
the source and flags, into ``build/`` at the repository root, and loaded
with ``ctypes``.  Nothing is built or imported at module import.

Semantics follow :func:`repro_torch.kernels.ref.lease_validate_ref`: an
item is clipped to ``[0, n_items - 1]`` and a negative slot always passes.
The Pallas kernel differs for items past the end (it pads the table with
-2 and ignores them); callers never pass such items.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "lease_validate.cu"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches since the count was last reset (a plain integer: the
# wrapper adds one where it launches, nowhere else)
launches = 0
# nvcc wall seconds and ptxas report of the build this process loaded
build_info: Dict[str, object] = {}
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the lease_validate kernel needs "
                           "the CUDA toolkit to build")
    return path


def build() -> Path:
    """Compile the kernel into ``build/`` unless this exact build exists."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"lease_validate-{key}"
    lib = out_dir / "liblease_validate.so"
    if lib.exists():
        build_info.setdefault("cached", True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent builder never sees half a file
    build_info.update(
        cached=False, nvcc_s=seconds,
        ptxas=[ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
               if "ptxas info" in ln or "spill" in ln])
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.lease_validate_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device
           ) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lease_validate(store_versions: torch.Tensor, read_items: torch.Tensor,
                   read_versions: torch.Tensor, write_locks: torch.Tensor,
                   write_items: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``ok[B]`` bool.

    ``store_versions``/``write_locks``: ``[n_items]`` int32 (locks 0/1);
    ``read_items``/``read_versions``: ``[B, R]`` int32, -1 padded;
    ``write_items``: ``[B, W]`` int32, -1 padded.  Raises on anything
    else, on a failed build and on a refused launch.
    """
    global launches
    if store_versions.device.type != "cuda":
        raise ValueError("lease_validate launches on CUDA tensors only; "
                         "CPU callers use ref.lease_validate_ref")
    dev = store_versions.device
    _check("store_versions", store_versions, 1, dev)
    _check("write_locks", write_locks, 1, dev)
    _check("read_items", read_items, 2, dev)
    _check("read_versions", read_versions, 2, dev)
    _check("write_items", write_items, 2, dev)
    n = store_versions.shape[0]
    b, r = read_items.shape
    if n < 1:
        raise ValueError("store_versions is empty")
    if write_locks.shape[0] != n:
        raise ValueError(f"write_locks has {write_locks.shape[0]} items, "
                         f"store_versions {n}")
    if read_versions.shape != read_items.shape:
        raise ValueError(f"read_versions {tuple(read_versions.shape)} != "
                         f"read_items {tuple(read_items.shape)}")
    if write_items.shape[0] != b:
        raise ValueError(f"write_items has {write_items.shape[0]} rows, "
                         f"read_items {b}")
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return ok
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lease_validate_launch(
            store_versions.data_ptr(), read_items.data_ptr(),
            read_versions.data_ptr(), write_locks.data_ptr(),
            write_items.data_ptr(), ok.data_ptr(), n, b, r,
            write_items.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"lease_validate launch failed: CUDA error {err}")
    launches += 1
    return ok
