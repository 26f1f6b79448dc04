"""Compare ``prefill_tc``'s compiled SASS between two source trees.

    PYTHONPATH=src python tools/sass_compare.py OTHER_CSRC

Builds ``csrc/flash_attention.cu`` of this tree and of ``OTHER_CSRC``
(another checkout's ``src/repro_torch/kernels/csrc``) with
``repro_torch.kernels.nvcc.NVCC_FLAGS`` into a temporary directory,
disassembles both with ``cuobjdump -sass`` and prints one JSON line per
entry function whose mangled name holds ``prefill_tc_kernel``: ``same``
(instruction for instruction), ``differs``, or the one tree it is in.
Exits 1 when a function of both trees differs.  It shows whether an edit
of a template left its other instantiations as they were; it needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

from repro_torch.kernels.nvcc import CSRC, NVCC_FLAGS, _nvcc

LIBRARY = "flash_attention"
MARKER = "prefill_tc_kernel"


def functions(sass: str) -> Dict[str, List[str]]:
    """``cuobjdump -sass`` text -> {mangled name: its instruction lines}."""
    out: Dict[str, List[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is not None and line.strip():
            cur.append(line.strip())
    return out


def disassemble(csrc: Path, workdir: Path) -> str:
    lib = workdir / f"lib{LIBRARY}.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                    str(csrc / f"{LIBRARY}.cu")], check=True,
                   capture_output=True, text=True)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def compare(mine: Dict[str, List[str]], other: Dict[str, List[str]],
            marker: str) -> List[dict]:
    """One record per function holding ``marker`` in either tree."""
    names = sorted(n for n in set(mine) | set(other) if marker in n)
    out = []
    for name in names:
        if name not in other:
            verdict = "only_this_tree"
        elif name not in mine:
            verdict = "only_other_tree"
        else:
            verdict = "same" if mine[name] == other[name] else "differs"
        lines = mine.get(name, other.get(name))
        out.append(dict(function=name, verdict=verdict,
                        instructions=sum(ln.startswith("/*") for ln in lines)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_csrc", type=Path)
    args = ap.parse_args(argv)
    trees = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, csrc in (("mine", CSRC), ("other", args.other_csrc)):
            workdir = Path(tmp) / name
            workdir.mkdir()
            trees[name] = functions(disassemble(csrc, workdir))
    records = compare(trees["mine"], trees["other"], MARKER)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 1 if any(r["verdict"] == "differs" for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
