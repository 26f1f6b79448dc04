"""The benchmark's weights, made on the device from ``--seed``.

One ``normal_`` call fills a flat buffer in the type the weights are held
in; the leaves are views into it, each scaled to its own standard
deviation.  Matrices: std 1/sqrt(fan_in), fan_in = shape[-2]; vectors
take the family's fixed initial values.  The same seed, device and type
give the same bits, so the reference makes its own copy after the
program's run.

The tree's layout is the configuration's family's (``bench/families/
<name>.py``: ``param_shapes`` and ``initial``).  Imports torch alone.
"""
from __future__ import annotations

import importlib
import math
from typing import Any, Dict, List, Tuple

import torch


def paths(tree, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """Every leaf with its path, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in paths(tree[k],
                                                         prefix + (k,))]
    if isinstance(tree, list):
        return [pl for i, t in enumerate(tree) for pl in paths(t,
                                                               prefix + (i,))]
    return [(prefix, tree)]


def _set(tree, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def load_family(name: str):
    """``bench/families/<name>.py``: a configuration's weight layout and
    work."""
    return importlib.import_module(f"families.{name}")


def make_params(family, m: Dict, seed: int, device, dtype: torch.dtype
                ) -> Dict[str, Any]:
    """The weights of model section ``m`` of ``family`` from ``seed``, on
    ``device`` in ``dtype``, drawn in one call."""
    shapes = family.param_shapes(m)
    leaves = paths(shapes)
    total = sum(math.prod(s) for _, s in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat.normal_(generator=gen)
    tree = _skeleton(shapes)
    at = 0
    with torch.no_grad():
        for path, shape in leaves:
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if len(shape) >= 2:
                t.mul_(1.0 / math.sqrt(shape[-2]))
            else:
                family.initial(path[-1], t)
            _set(tree, path, t)
    return tree
