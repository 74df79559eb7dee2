"""Compare the floating-point instructions of one kernel in two versions of
a CUDA source, as ``ops/cuda_build.py`` compiles them.

A kernel that must keep its bits (``csrc/frame_layout.cu``'s serial design,
held to the plain version bit for bit) may be restructured, its steps moved
into helpers, only if the compiled arithmetic stays what it was. This
compiles each source to PTX with the build's flags (``-fmad=false`` where
the build gives it), takes every ``.entry`` whose name contains the
kernel's name (``--before-kernel`` names it in the first source where it
was named otherwise; entries pair by their template arguments), and counts
its floating-point instructions by opcode (``add.rn.f64``, ``div.rn.f32``,
``fma.rn.f64``, ``cvt.rmi.f64.f64``, ...; loads, stores and moves left
out): the same counts mean the same roundings, none contracted and none
added; a difference names the opcodes that changed. Run from the
repository's root, e.g. against an unpacked parent commit:

    python3 -m mba_vo_tpu_torch.experiments.ptx_ops \\
        build/parent/mba_vo_tpu_torch/csrc/frame_layout.cu \\
        mba_vo_tpu_torch/csrc/frame_layout.cu --kernel frame_layout_serial_kernel \\
        --before-kernel frame_layout_kernel

Needs ``nvcc`` (``CUDA_HOME``), no GPU; exits 1 where the counts differ.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Counter, Dict

# an instruction on floating-point operands: its opcode ends in, or carries,
# a .f32 or .f64 type (loads, stores and moves, which round nothing, left out)
_MOVES = ("ld.", "st.", "mov.")
_FP = re.compile(r"^\s*(?:@!?%p\d+\s+)?([a-z][a-z0-9]*(?:\.[a-z0-9]+)*\.f(?:32|64)"
                 r"(?:\.[a-z0-9]+)*)\s", re.M)


def ptx(source: Path, name: str) -> str:
    """The PTX of ``source`` with the build's flags for the library
    ``name``."""
    from ..ops import cuda_build

    drop = {"-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"}
    flags = [f for f in cuda_build.nvcc_flags() if f not in drop]
    flags += cuda_build.SOURCE_FLAGS.get(name, [])
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / f"{name}.ptx"
        subprocess.run([cuda_build._nvcc(), *flags, "-ptx", "-I", str(source.parent), "-o",
                        str(out), str(source)], check=True, capture_output=True, text=True)
        return out.read_text()


def entries(text: str, kernel: str) -> Dict[str, Counter]:
    """The floating-point opcode counts of each ``.entry`` of ``text`` whose
    mangled name contains ``kernel``, by its template arguments (``IfE``,
    ``IdE``, ...)."""
    found: Dict[str, Counter] = {}
    for m in re.finditer(r"\.entry\s+(\S+)\s*\(", text):
        at = m.group(1).find(kernel)
        if at < 0:
            continue
        rest = m.group(1)[at + len(kernel):]
        key = f"{kernel}{rest[:rest.find('E') + 1] if rest.startswith('I') else ''}"
        start = text.index("{", m.end())
        depth, i = 0, start
        while True:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                break
            i += 1
        found[key] = collections.Counter(
            op for op in _FP.findall(text[start:i]) if not op.startswith(_MOVES))
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path)
    ap.add_argument("--kernel", required=True, help="a part of the kernel's name")
    ap.add_argument("--before-kernel", help="its name in the first source (--kernel)")
    args = ap.parse_args(argv)
    name = args.after.stem
    before = args.before_kernel or args.kernel
    got = [{k.replace(before, args.kernel, 1): v
            for k, v in entries(ptx(args.before, name), before).items()},
           entries(ptx(args.after, name), args.kernel)]
    if not got[0] or set(got[0]) != set(got[1]):
        print(f"ptx_ops: entries differ: {sorted(got[0])} against {sorted(got[1])}")
        return 1
    same = True
    for entry in sorted(got[0]):
        a, b = got[0][entry], got[1][entry]
        diff = {op: (a[op], b[op]) for op in sorted(set(a) | set(b)) if a[op] != b[op]}
        same &= not diff
        print(f"{entry}: {sum(a.values())} floating-point instructions before, "
              f"{sum(b.values())} after; "
              + ("every opcode's count equal" if not diff else
                 "differ: " + ", ".join(f"{op} {x} -> {y}" for op, (x, y) in diff.items()))
              + " (" + ", ".join(f"{op} {n}" for op, n in sorted(b.items())) + ")")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
