"""Count what the compiler made of kernels B1 and B4's shared core.

    python3 -m statmc_tpu_torch.sass_count [sass.txt]

Disassembles the kernels' library with ``cuobjdump -sass`` (building it
first if needed; or reads a dump given as the argument) and, for the
kernels ``fused_intersect`` and ``twolevel_walk``, prints each innermost
loop that holds FFMA chains, with its instruction count by kind.  Those
are the core's steps (csrc/plucker.cuh:step4), one loop per instantiation
for NA = 1..4 ray slots: 4 triangles x NA rays per trip, so the counts
divided by 4 * NA are instructions per (ray, triangle) pair.  A step's
loop holds both the common path (no pair of the step passes the screen)
and the lazy branch (exact inside test, plane forms, division, update),
so the instructions up to the first branch behind the FFMA chains, which
is the "any pair through the screen?" test, are printed apart as the
common path.
"""
from __future__ import annotations

import collections
import glob
import os
import re
import subprocess
import sys

KERNELS = ("fused_intersect", "twolevel_walk")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)"
                    r"\s*([^;]*);")
_KINDS = ("FFMA", "FMUL", "LDS", "FMNMX", "FSETP", "BRA")


def disassemble() -> str:
    from . import cuda_build

    cuda_build.library()
    so = max(glob.glob(os.path.join(cuda_build._BUILD, "*.so")),
             key=os.path.getmtime)
    exe = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    return subprocess.run([exe, "-sass", so], capture_output=True, text=True,
                          check=True).stdout


def functions(sass: str) -> dict:
    """{kernel: [(address, opcode, operands)]} for the sm_90a code."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = next((k for k in KERNELS if k + "_kernel" in line), None)
            if cur is not None:
                out[cur] = []
            continue
        m = _INSTR.search(line)
        if cur is not None and m:
            out[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def _kinds(instrs) -> dict:
    c = collections.Counter()
    for _, op, _ in instrs:
        c[next((k for k in _KINDS if op.startswith(k)), "other")] += 1
    return c


def _fmt(c, per) -> str:
    n = sum(c.values())
    parts = [f"{n} instructions ({n / per:.2f} a pair)"]
    parts += [f"{k} {c[k]} ({c[k] / per:.2f})" for k in (*_KINDS, "other")
              if c[k]]
    return ", ".join(parts)


def report(name, instrs) -> None:
    print(f"{name}: {len(instrs)} instructions in the kernel, "
          f"{_kinds(instrs)['FFMA']} FFMA")
    addr = {a: i for i, (a, _, _) in enumerate(instrs)}
    loops = []
    for i, (a, op, args) in enumerate(instrs):
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) in addr:
            j = addr[int(m.group(1), 16)]
            if j <= i:
                loops.append((j, i))
    # The step loops: the innermost loops that hold FFMA chains, one per
    # instantiation of the core (NA = 1..NR ray slots).
    inner = [(j, i) for j, i in loops
             if not any((a, b) != (j, i) and j <= a and b <= i
                        for a, b in loops)]
    for j, i in inner:
        body = instrs[j:i + 1]
        ffma = _kinds(body)["FFMA"]
        if ffma < 72:
            continue
        # 18 FFMA a pair in the chains; the lazy branch holds the rest.
        na = max(1, min(4, round(ffma / 120)))
        per = 4 * na
        seen, end = 0, len(body) - 1
        for k, (_, op, _) in enumerate(body):
            seen += op.startswith("FFMA")
            if seen >= per * 18 and op.startswith("BRA"):
                end = k
                break
        print(f"  step loop {body[0][0]:#06x}-{body[-1][0]:#06x}, {na} ray "
              f"slots x 4 triangles = {per} pairs a trip: "
              + _fmt(_kinds(body), per))
        print(f"    common path, to the branch at {body[end][0]:#06x}: "
              + _fmt(_kinds(body[:end + 1]), per))


def main(argv) -> int:
    sass = open(argv[0]).read() if argv else disassemble()
    for name, instrs in functions(sass).items():
        report(name, instrs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
