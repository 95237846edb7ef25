#!/usr/bin/env python3
"""What the compiler made of the kernel libraries: per kernel its SASS
instruction count and local-memory loads and stores, and, against another
build of the same library, whether each kernel's SASS is identical, or
identical but for the constant-bank offsets of its parameters (a kernel
whose parameter struct changed layout).

    python3 tools/kernel_sass.py build/tpuvae_torch/libstft_small-*.so
    python3 tools/kernel_sass.py NEW.so OLD.so    # e.g. OLD from a parent

Needs ``cuobjdump`` (``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``): run it
on the card's machine after a build.  Kernel names lose the anonymous
namespace's per-file tag, so two builds' kernels pair up.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "cuobjdump")


def functions(lib: str) -> dict[str, list[str]]:
    """Each kernel's SASS instructions, addresses and comments dropped."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs: dict[str, list[str]] = {}
    name = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name is not None and m:
            funcs[name].append(re.sub(r"\s+", " ", m.group(1)))
    return funcs


def _masked(ins: list[str]) -> list[str]:
    return [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][*]", i) for i in ins]


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    new = functions(sys.argv[1])
    old = functions(sys.argv[2]) if len(sys.argv) == 3 else {}
    for name, ins in new.items():
        ldl = sum(bool(re.search(r"(^|\s)LDL", i)) for i in ins)
        stl = sum(bool(re.search(r"(^|\s)STL", i)) for i in ins)
        line = f"{len(ins):6d} instr  LDL {ldl:3d}  STL {stl:3d}  {name}"
        if old:
            line += ("  identical" if old.get(name) == ins else
                     "  (not in old)" if name not in old else
                     "  identical but parameter offsets"
                     if _masked(old[name]) == _masked(ins) else "  DIFFERENT")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
