"""Registers and spills of the tc flash backward kernels at any (Dk, Dv).

The launcher instantiates ``csrc/flash_backward_tc.cuh`` at (64, 64),
(80, 80), (128, 128) and MLA's (192, 128).  This compiles, in a file of
its own with the port's ``nvcc`` flags, the kernels the launcher runs at
each pair given (``launch<Dk, Dv>``: ``dkdv_tc`` or, where one warpgroup
cannot hold dK and dV beside S and dP, ``dkdv_tc2``, then ``dq_tc``) and
the one-warpgroup ``dkdv_tc`` at every pair, and prints what ``ptxas -v``
says of each: whether a pair's accumulators fit without a spill.  Needs
``nvcc`` (the card's machine)::

    python3 tools/flash_bwd_tc_registers.py 192x128
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import nvcc  # noqa: E402

PAIRS = ((64, 64), (80, 80), (128, 128), (192, 128))
KERNELS = ("dkdv_tc2", "dkdv_tc", "dq_tc")


def probe(pairs) -> list:
    refs = "\n".join(
        f"  (void*)&flash::backward_tc::launch<{dk}, {dv}>,\n"
        f"  (void*)flash::backward_tc::dkdv_tc_kernel<{dk}, {dv}>,"
        for dk, dv in pairs)
    source = ('#include "flash_backward_tc.cuh"\n'
              f"extern \"C\" void* kernels[] = {{\n{refs}\n}};\n")
    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp) / "probe.cu"
        cu.write_text(source)
        flags = [f for f in nvcc.NVCC_FLAGS if f not in ("-shared",)]
        proc = subprocess.run(
            [nvcc._nvcc(), *flags, "-c", "-I", str(nvcc.CSRC), "-o",
             str(Path(tmp) / "probe.o"), str(cu)],
            capture_output=True, text=True, check=False)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(text)
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        kind = next((k for k in KERNELS if name and f"{k}_kernel" in name),
                    None)
        if m and kind:
            dims = re.search(r"ILi(\d+)ELi(\d+)E", name).groups()
            out.append(dict(kernel=kind, dk=int(dims[0]), dv=int(dims[1]),
                            registers=int(m.group(1)),
                            spill_stores=spills[0], spill_loads=spills[1]))
            name = None
    return out


def main(argv) -> int:
    pairs = [tuple(int(x) for x in a.split("x")) for a in argv] or PAIRS
    for rec in probe(pairs):
        print(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
