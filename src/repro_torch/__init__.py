"""Lilac-TM on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The package mirrors :mod:`repro` module for module and imports torch, numpy
and the standard library only.  Entry points take an explicit ``device``
and run on the card unless the caller asks for the CPU; asking for
``"cuda"`` on a host without a card raises instead of carrying on silently
on the CPU.
"""
from __future__ import annotations


def resolve_device(device) -> "torch.device":
    """``"cuda"``/``"cpu"`` (or a ``torch.device``) -> a usable device.

    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    present, and ``ValueError`` for any other device type.
    """
    import torch     # here, so that the stdlib-only lint imports no torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(expected 'cuda' or 'cpu')")
    return dev
