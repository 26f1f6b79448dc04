"""Plain references, one module per family: ``load(name)`` is
``bench/reference/<name>.py``, which a configuration names under
``"reference"``."""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"reference.{name}")
