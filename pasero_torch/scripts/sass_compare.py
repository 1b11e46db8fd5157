#!/usr/bin/env python3
"""Whether a ``pasero_torch/csrc`` source compiles to the same SASS in two
checkouts: each kernel's instructions (``cuobjdump -sass`` of a cubin built
with the build's flags), paired by demangled name without parameters and
namespaces.

    python -m pasero_torch.scripts.sass_compare --a PARENT/pasero_torch/csrc \\
        --b pasero_torch/csrc fused_ce int8_matmul \\
        [--rename 'Int8Weight, =' --rename 'Store(?:Decode|Prompt)<(.+?)> ?>=\\1>']

``--rename PATTERN=REPLACEMENT`` (a regular expression, applied to the
names of --b's kernels) pairs kernels whose template arguments were renamed.
Per source it prints one JSON line: per kernel pair whether the text is
byte-equal, else how many instructions differ once the constant-bank
operands (c[0x0][...], the kernel parameters' offsets) are masked, and the
kernels either side lacks. Needs nvcc and cuobjdump (the card's machine).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import tempfile

from pasero_torch.ops import cuda_build
from pasero_torch.scripts.ptxas_report import demangler


def sass(csrc: str, name: str) -> dict:
    """{demangled kernel name: [instruction lines]} of csrc/{name}.cu."""
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    nvcc = cuda_build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, f"{name}.cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", cubin,
                        os.path.join(csrc, f"{name}.cu")], check=True,
                       capture_output=True, text=True)
        text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    kernels, current = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            current = kernels.setdefault(head.group(1), [])
        elif current is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            # the instruction without its address, its runs of spaces as one
            # (cuobjdump pads to the file's longest instruction); the
            # encoding stays
            current.append(" ".join(line.split()[1:]))
        elif current and re.fullmatch(r"\s*/\* 0x[0-9a-f]+ \*/\s*", line):
            current[-1] += " " + line.strip()   # the encoding's second half
    tool = demangler()
    if tool and kernels:
        names = list(kernels)
        plain = subprocess.run([tool], input="\n".join(names),
                               capture_output=True, text=True).stdout
        kernels = dict(zip(plain.splitlines(), kernels.values()))
    return kernels


MASK = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]|/\* 0x[0-9a-f]+ \*/")


def short(name: str) -> str:
    """A kernel's name without its parameter list, namespaces and casts."""
    name = re.sub(r"\((?:[^()]|\([^()]*\))*\)$", "", name.strip())
    return re.sub(r"\w+::|\((?:int|bool)\)", "", name)


def compare(a: dict, b: dict, renames: list) -> dict:
    a = {short(name): body for name, body in a.items()}
    renamed = {}
    for name, body in b.items():
        name = short(name)
        for pattern, repl in renames:
            name = re.sub(pattern, repl, name)
        renamed[name] = body
    out = {"pairs": {}, "only_a": sorted(set(a) - set(renamed)),
           "only_b": sorted(set(renamed) - set(a))}
    for name in sorted(set(a) & set(renamed)):
        x, y = a[name], renamed[name]
        if x == y:
            out["pairs"][name] = {"byte_equal": True, "instructions": len(x)}
            continue
        mx, my = [MASK.sub("", i) for i in x], [MASK.sub("", i) for i in y]
        differ = sum(p != q for p, q in zip(mx, my)) + abs(len(mx) - len(my))
        out["pairs"][name] = {"byte_equal": False, "instructions": [len(x), len(y)],
                              "differ_masked": differ}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--a", required=True, help="one checkout's csrc")
    parser.add_argument("--b", default=cuda_build.CSRC,
                        help="the other's (default: this checkout's)")
    parser.add_argument("--rename", action="append", default=[],
                        help="PATTERN=REPLACEMENT for --b's kernel names")
    parser.add_argument("sources", nargs="+", help="csrc/*.cu names, no .cu")
    args = parser.parse_args(argv)
    renames = [tuple(r.split("=", 1)) for r in args.rename]
    for name in args.sources:
        result = compare(sass(args.a, name), sass(args.b, name), renames)
        equal = sum(p["byte_equal"] for p in result["pairs"].values())
        print(json.dumps({"source": name, "pairs": len(result["pairs"]),
                          "byte_equal": equal, **result}))


if __name__ == "__main__":
    main()
