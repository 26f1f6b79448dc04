"""Architecture registry of the port: ``get_config(arch)`` lookup.

Each module defines ``CONFIG`` (the published configuration, a copy of the
reference's ``repro.configs`` module) and ``smoke_config()`` (the reduced
same-family config of the CPU tests).  Only the architectures whose layers
the port runs are registered; any other name raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.common import ModelConfig

_MODULES = {
    "glm4-9b": "glm4_9b",
    "mamba2-780m": "mamba2_780m",
}
# the reference's other architectures, and the ROADMAP item that ports them
_PENDING = {
    "qwen2-vl-2b": "queue 1 item 8 (vision frontend, M-RoPE)",
    "phi4-mini-3.8b": "queue 1 item 8 (further dense archs)",
    "minitron-4b": "queue 1 item 8 (further dense archs)",
    "gemma3-27b": "queue 1 item 8 (further dense archs)",
    "deepseek-v2-236b": "queue 1 item 8 (MLA + MoE)",
    "mixtral-8x7b": "queue 1 item 8 (MoE)",
    "hubert-xlarge": "queue 1 item 8 (encoder, audio frontend)",
    "zamba2-1.2b": "queue 1 item 8 (hybrid shared attention)",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch in _PENDING:
        raise KeyError(f"arch {arch!r} is not ported yet: ROADMAP "
                       f"{_PENDING[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
