"""Build and load the port's CUDA kernels: ``nvcc`` at first use, ``ctypes``.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, which may
include ``csrc/*.cuh`` headers.  A :class:`CudaLibrary` compiles it with
``nvcc`` for ``sm_90a`` into ``build/<name>-<key>/lib<name>.so`` at the
repository root, where the key hashes the source, every header of
``csrc/`` and the flags, so an unchanged kernel is built once per checkout
and a changed header is never served from a stale build.  ``ptxas -v`` output (registers, shared memory, spills) and the
``nvcc`` wall seconds are kept in :attr:`CudaLibrary.info`.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.

Nothing is built or loaded at import: the CPU tests import every module on
a host without ``nvcc``.
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
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signature of an exported launcher: (argtypes, restype)
Signature = Tuple[Sequence[object], object]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                           "CUDA toolkit to build")
    return path


class CudaLibrary:
    """One ``csrc/<name>.cu`` built into a shared library and its launchers."""

    def __init__(self, name: str, functions: Dict[str, Signature]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.functions = functions
        self.info: Dict[str, object] = {}
        self._lib: Optional[ctypes.CDLL] = None

    def target(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.name.encode() + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        key = digest.hexdigest()[:16]
        return BUILD_ROOT / f"{self.name}-{key}" / f"lib{self.name}.so"

    def _start(self) -> Optional[Tuple[subprocess.Popen, str, float]]:
        lib = self.target()
        if lib.exists():
            self.info.setdefault("cached", True)
            return None
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                 str(self.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        return proc, tmp, time.perf_counter()

    def _finish(self, started: Tuple[subprocess.Popen, str, float]) -> None:
        proc, tmp, t0 = started
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{self.source}:\n{out}{err}")
        # atomic: a concurrent build never sees half a file
        os.replace(tmp, self.target())
        self.info.update(
            cached=False, nvcc_s=seconds,
            ptxas=[ln.strip() for ln in (out + err).splitlines()
                   if "ptxas" in ln or "spill" in ln])

    def build(self) -> Path:
        """Compile into ``build/`` unless this exact build exists."""
        started = self._start()
        if started is not None:
            self._finish(started)
        return self.target()

    def load(self) -> ctypes.CDLL:
        """Build if needed, load once, and type every exported launcher."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fname, (argtypes, restype) in self.functions.items():
                fn = getattr(lib, fname)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            self._lib = lib
        return self._lib


def build_all(libraries: Iterable[CudaLibrary]) -> None:
    """Start one ``nvcc`` per library at once, then wait for every one.

    Raises the first build failure after all compilers have exited.
    """
    running = [(lib, lib._start()) for lib in libraries]
    errors = []
    for lib, started in running:
        if started is None:
            continue
        try:
            lib._finish(started)
        except RuntimeError as exc:
            errors.append(exc)
    if errors:
        raise errors[0]


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
