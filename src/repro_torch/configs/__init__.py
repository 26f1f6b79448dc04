"""Architecture registry of the port: ``get_config(arch)`` lookup.

Each module defines ``CONFIG`` (the published configuration, a copy of the
reference's ``repro.configs`` module) and ``smoke_config()`` (the reduced
same-family config of the CPU tests).  All ten of the reference's
architectures are registered: a config is plain data, and the serving
simulator (``serve.engine.SimBackend``) reads nothing else.  Building the
layers of a config with a feature the port does not run yet (MLA, MoE,
shared attention, the vision and audio frontends, the layer pattern, norms
and activations only gemma3, minitron and hubert use:
``models.common.unported_features``) raises ``NotImplementedError`` naming
ROADMAP queue 1 item 8, where the layers are built
(``models.common.init_params``, ``params_from_numpy``,
``decoder.block_apply``).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.common import ModelConfig

_MODULES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "glm4-9b": "glm4_9b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "minitron-4b": "minitron_4b",
    "gemma3-27b": "gemma3_27b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mixtral-8x7b": "mixtral_8x7b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-780m": "mamba2_780m",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
