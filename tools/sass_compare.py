"""Compare the kernels' compiled SASS between two source trees.

    PYTHONPATH=src python tools/sass_compare.py OTHER_CSRC

Builds each library of ``LIBRARIES`` (``csrc/<name>.cu``) of this tree and
of ``OTHER_CSRC`` (another checkout's ``src/repro_torch/kernels/csrc``)
with ``repro_torch.kernels.nvcc.NVCC_FLAGS`` into a temporary directory,
disassembles both with ``cuobjdump -sass`` and prints one JSON line per
entry function whose mangled name holds one of the library's markers (in
``flash_attention``: the ``prefill_tc`` forward, ``decode_split``'s two
kernels, the ``simt`` forward, the backward's pre-pass, the ``simt``
backward's two kernels and every kernel of ``flash_backward_tc.cuh``: every
function; in ``ssd_scan``: every function): ``same``
(instruction for instruction), ``differs``, or the one tree it is in.
Exits 1 when a function of both trees differs.  It shows whether an edit
of a header left the other kernels as they were; it needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit).
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

MARKERS = ("prefill_tc_kernel", "dkdv_tc_kernel", "dkdv_tc2_kernel",
           "dq_tc_kernel", "reduce_tc_kernel")
# library: the markers of the functions compared ("" holds every one)
LIBRARIES = {
    "flash_attention": MARKERS + ("12split_kernel", "14combine_kernel",
                                  "12delta_kernel", "4simt12flash_kernel",
                                  "8backward11dkdv_kernel",
                                  "8backward9dq_kernel"),
    "ssd_scan": ("",),
}


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


def disassemble(csrc: Path, workdir: Path, library: str) -> str:
    lib = workdir / f"lib{library}.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                    str(csrc / f"{library}.cu")], check=True,
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
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        for library, markers in LIBRARIES.items():
            trees = {}
            for name, csrc in (("mine", CSRC), ("other", args.other_csrc)):
                workdir = Path(tmp) / library / name
                workdir.mkdir(parents=True)
                trees[name] = functions(disassemble(csrc, workdir, library))
            seen = set()
            for marker in markers:
                for rec in compare(trees["mine"], trees["other"], marker):
                    if rec["function"] not in seen:
                        seen.add(rec["function"])
                        records.append(dict(library=library, **rec))
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 1 if any(r["verdict"] == "differs" for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
