"""Host meshes over the ranks of a ``torch.distributed`` world.

The port of :mod:`repro.launch.mesh`'s ``make_host_mesh``.  The reference
lays a ``jax.sharding.Mesh`` over the devices of one process; the port
runs one process per rank (``torchrun``, or a world of one) and lays a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks.  With no
process group yet, :func:`make_host_mesh` starts a world of one itself:
NCCL on ``cuda``, gloo where the caller asks for the CPU.  A world of one
still runs every collective of the mesh paths.

Left out: ``make_production_mesh`` (the 512-placeholder-device mesh of the
compile-only dry run) belongs to the dry run, ROADMAP queue 1 item 10b.

Example (four CPU ranks)::

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --device cpu \\
        --arch glm4-9b --preset smoke --steps 4 --batch 8 --seq 64
"""
from __future__ import annotations

import os
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device="cuda") -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in the environment),
    or start a world of one on a free local port; NCCL for ``cuda``, gloo
    for the CPU.  Returns this rank's device (``cuda:LOCAL_RANK``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(
                backend, device_id=dev if dev.type == "cuda" else None)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                rank=0, world_size=1,
                device_id=dev if dev.type == "cuda" else None)
    return dev


def _device_type(device) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_host_mesh(model: int = 1, seq: int = 1, device=None) -> DeviceMesh:
    """A mesh over every rank of the world (started if need be).

    The reference's sizing rule: ``model`` is capped at the rank count,
    ``seq`` > 1 inserts a ``seq`` axis between ``data`` and ``model``
    (the largest feasible size not above the one asked for), and ``data``
    takes the rest.  Axis names ``("data", "model")`` or ``("data", "seq",
    "model")``.
    """
    if not dist.is_initialized():
        init_world("cuda" if device is None else device)
    n = dist.get_world_size()
    model = min(model, n)
    seq = max(1, min(seq, n // model))
    while (n // model) % seq:
        seq -= 1                      # largest feasible seq axis <= requested
    kind = _device_type(device)
    if seq > 1:
        return init_device_mesh(kind, (n // (model * seq), seq, model),
                                mesh_dim_names=("data", "seq", "model"))
    return init_device_mesh(kind, (n // model, model),
                            mesh_dim_names=("data", "model"))


def submesh(ranks: Sequence[int], shape: Tuple[int, ...],
            names: Tuple[str, ...], device=None) -> Optional[DeviceMesh]:
    """A mesh of ``shape`` over ``ranks`` (row-major) of the world, which
    may leave ranks out; ``None`` on a rank outside it.

    Only the member ranks call in: the process groups are made with local
    synchronization, so ranks that left the world (failed hosts) need not
    take part.
    """
    ranks = [int(r) for r in ranks]
    me = dist.get_rank()
    kind = _device_type(device)
    if ranks == list(range(dist.get_world_size())):
        return init_device_mesh(kind, tuple(shape), mesh_dim_names=names)
    if me not in ranks:
        return None
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    groups = []
    for dim in range(len(shape)):
        # the ranks that share every coordinate but this dim's with me
        lines = grid.movedim(dim, -1).reshape(-1, shape[dim])
        mine = next(line for line in lines.tolist() if me in line)
        groups.append(dist.new_group(mine, use_local_synchronization=True))
    return DeviceMesh.from_group(groups if len(groups) > 1 else groups[0],
                                 kind, mesh=grid, mesh_dim_names=names)
