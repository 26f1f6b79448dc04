"""Fault-tolerant checkpointing: atomic two-phase commit + async writer.

The port of :mod:`repro.train.checkpoint`, on the same on-disk protocol::

    <dir>/step_00000120/          # one directory per step
        manifest.json             # leaf paths, shapes, dtypes, the step
        leaf_00000.npy ...        # row-major leaves
    <dir>/step_00000120.COMMITTED # phase-2 marker (rename-based atomicity)

* ``save`` writes into ``step_X.tmp/``, fsyncs, renames it to ``step_X/``
  and only then drops the ``.COMMITTED`` marker: a crash at any point
  leaves either a complete committed checkpoint or ignorable garbage.
* ``AsyncCheckpointer`` copies the tree to host memory synchronously (the
  optimizer updates the device tensors in place at the next step) and
  writes to disk in a worker thread.
* ``restore`` loads the newest (or a given) committed step into ``like``'s
  structure, each leaf onto ``like``'s device and dtype; with a ``mesh``
  and a spec tree it keeps this rank's block of each leaf, so a state
  saved by a world of one size restores onto a world of another (the
  elastic restart, :mod:`.elastic`).

Trees flatten in the port's own order (:mod:`.tree`); a bf16 leaf is
stored as fp32 (numpy has no bf16) and cast back on restore.  Reading the
reference's checkpoints is not supported.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .tree import leaves_with_paths, unflatten


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy, never a view of a
    tensor the training loop goes on to update)."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _tree_to_manifest(tree: Any) -> Tuple[dict, list]:
    pairs = leaves_with_paths(tree)
    manifest = {"leaves": [
        {"path": [str(k) for k in path], "shape": list(leaf.shape),
         "dtype": str(leaf.dtype)}
        for path, leaf in pairs]}
    return manifest, [leaf for _, leaf in pairs]


def _write(ckpt_dir: Path, step: int, manifest: dict, arrays: list) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = ckpt_dir / (name + ".tmp")
    final = ckpt_dir / name
    marker = ckpt_dir / (name + ".COMMITTED")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    for i, arr in enumerate(arrays):
        with open(tmp / f"leaf_{i:05d}.npy", "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
    with open(tmp / "manifest.json", "w") as f:
        json.dump({**manifest, "step": step}, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                 # phase 1: data in place
    marker.touch()                        # phase 2: commit point
    return final


def save(ckpt_dir: str | Path, step: int, tree: Any) -> Path:
    """Synchronous atomic save; returns the committed directory."""
    manifest, flat = _tree_to_manifest(tree)
    return _write(Path(ckpt_dir), step, manifest, [_host(x) for x in flat])


def committed_steps(ckpt_dir: str | Path) -> list:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for m in ckpt_dir.glob("step_*.COMMITTED"):
        s = int(m.name.removesuffix(".COMMITTED").removeprefix("step_"))
        if (ckpt_dir / f"step_{s:08d}").exists():
            steps.append(s)
    return sorted(steps)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, like: Any, step: Optional[int] = None,
            mesh=None, specs: Optional[Callable] = None) -> Tuple[Any, int]:
    """Restore the newest (or given) committed step into ``like``'s
    structure: each leaf a new tensor on the device and in the dtype of
    ``like``'s leaf at the same place.

    ``mesh`` with ``specs`` (``(path, like_leaf) -> spec``, a
    :mod:`repro_torch.dist.sharding` spec; ``()`` for a whole leaf)
    reshards: each rank reads the saved global leaf and keeps its block
    under the spec, whatever world saved it.
    """
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    pairs = leaves_with_paths(like)
    if [e["path"] for e in manifest["leaves"]] != \
            [[str(k) for k in path] for path, _ in pairs]:
        raise ValueError(f"checkpoint {d} holds another tree than `like`")
    out = []
    for i, (path, want) in enumerate(pairs):
        arr = torch.from_numpy(np.load(d / f"leaf_{i:05d}.npy"))
        if mesh is not None and specs is not None:
            from repro_torch.dist.sharding import local_shard

            arr = local_shard(arr, specs(path, want), mesh)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"leaf {i} of {d} restores as "
                             f"{tuple(arr.shape)}, `like` holds "
                             f"{tuple(want.shape)}")
        out.append(arr.to(device=want.device, dtype=want.dtype))
    return unflatten(like, out), step


def prune(ckpt_dir: str | Path, keep: int = 3) -> None:
    steps = committed_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(Path(ckpt_dir) / f"step_{s:08d}", ignore_errors=True)
        (Path(ckpt_dir) / f"step_{s:08d}.COMMITTED").unlink(missing_ok=True)


class AsyncCheckpointer:
    """Background writer: ``submit`` copies to host, then queues the disk
    I/O for a worker thread; ``close`` drains the queue and joins it."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3) -> None:
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=2)
        self._errors: list = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, manifest, arrays = item
            try:
                _write(self.ckpt_dir, step, manifest, arrays)
                prune(self.ckpt_dir, self.keep)
            except Exception as e:  # surfaced on the next submit / close
                self._errors.append(e)

    def submit(self, step: int, tree: Any) -> None:
        if self._errors:
            raise RuntimeError(f"async checkpoint failed: {self._errors[0]}")
        manifest, flat = _tree_to_manifest(tree)
        self._q.put((step, manifest, [_host(x) for x in flat]))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._errors:
            raise RuntimeError(f"async checkpoint failed: {self._errors[0]}")
