#!/usr/bin/env python3
"""What ptxas says of each kernel of a ``pasero_torch/csrc`` source: the
registers, spills and shared memory of every instance, and its notes (a
C75xx note names a wgmma that ptxas serialized).

    python -m pasero_torch.scripts.ptxas_report flash_bwd [flash_f32 ...]

Compiles each ``csrc/{name}.cu`` to a cubin with the build's flags and
``-Xptxas -v`` (nothing is loaded or run), and prints ptxas's lines with the
kernel names demangled. Needs nvcc (and cu++filt, beside it, for the
names).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import tempfile

from pasero_torch.ops import cuda_build


def demangler():
    """cu++filt beside nvcc, else c++filt, else None."""
    beside = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cu++filt")
    return beside if os.path.exists(beside) else shutil.which("c++filt")


def report(name: str) -> str:
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [cuda_build.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v",
               "-o", os.path.join(tmp, f"{name}.cubin"),
               os.path.join(cuda_build.CSRC, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}.cu:\n{text}")
    tool = demangler()
    if tool:
        names = sorted(set(re.findall(r"_Z\w+", text)))
        if names:
            plain = subprocess.run([tool], input="\n".join(names),
                                   capture_output=True, text=True).stdout
            # the longest first: a name may begin with a shorter one
            for mangled, readable in sorted(zip(names, plain.splitlines()),
                                            key=lambda p: -len(p[0])):
                text = text.replace(mangled, readable)
    return text


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("sources", nargs="+",
                        help="names of csrc/*.cu files, without .cu")
    args = parser.parse_args(argv)
    for name in args.sources:
        print(f"== {name}.cu")
        print(report(name))


if __name__ == "__main__":
    main()
