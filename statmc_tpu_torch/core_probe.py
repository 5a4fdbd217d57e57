"""Timing-only probes of kernels B1 and B4's shared core: where does the
time of csrc/plucker.cuh's step go?

    python3 -m statmc_tpu_torch.core_probe [probe ...]

For each probe (all of PROBES by default) the package and chip_smoke.py
are copied to build/probe/<name>/, the probe's textual substitutions are
applied to the copy's csrc/plucker.cuh, and ``chip_smoke.py --kernels``
runs there, so every probe is built, run and timed exactly like the real
kernels, at the same shapes, on the same card, within one call.  A
probe's kernels give WRONG results by construction (that is the point:
work is left out), so the copy's comparisons print instead of raising.
Only the ``kernel ... ms`` figures of the B1 and B4 lines mean anything.

Probes:
  as_is          no substitution: the reference time within this call.
  common         the lazy branch (exact inside test, plane forms,
                 division, update) is never taken: the time of the common
                 path alone.
  common_6_loads `common`, and a step makes 6 of its 18 shared loads (w1
                 and w2 pair w0's coefficients with rotated features, so
                 the 288 FMAs stay): how much do the loads cost?
  common_no_alu  the screen's min and compares, which run on the
                 half-rate ALU pipe, become 3 adds a pair on the FMA
                 pipe, and the branch is never taken: how much does the
                 ALU pipe cost?
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
_NEVER = ("  if (!any) return;",
          "  if (!any || R.best_t[0] != 12345.0f) return;")
_SCREEN_START, _SCREEN_END = "  float4 q[NA];", "  if (!any) return;"
_ADDS = """  float4 q[NA];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    q[j] = w[j][0];
    sum += (w[j][0].x + w[j][1].x) + w[j][2].x;
    sum += (w[j][0].y + w[j][1].y) + w[j][2].y;
    sum += (w[j][0].z + w[j][1].z) + w[j][2].z;
    sum += (w[j][0].w + w[j][1].w) + w[j][2].w;
  }
  const bool any = sum == 12345.0f;
"""
PROBES = {
    "as_is": [],
    "common": [_NEVER],
    "common_6_loads": [
        _NEVER,
        ("      const float4 a = tile[(e * 6 + k) * kRow4 + c4];",
         "      const float4 a = tile[k * kRow4 + c4];"),
        ("        const float f = R.f[j][k];",
         "        const float f = R.f[j][(k + e) % 6];")],
    "common_no_alu": "screen",
}


def _apply(src: str, probe) -> str:
    if probe == "screen":
        i, j = src.index(_SCREEN_START), src.index(_SCREEN_END)
        return src[:i] + _ADDS + src[j:]
    for old, new in probe:
        if old not in src:
            raise RuntimeError(f"core_probe: {old!r} is not in plucker.cuh")
        src = src.replace(old, new)
    return src


def run(name: str) -> None:
    dst = os.path.join(_ROOT, "build", "probe", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(dst, "statmc_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    core = os.path.join(dst, "statmc_tpu_torch", "csrc", "plucker.cuh")
    with open(core) as f:
        src = f.read()
    with open(core, "w") as f:
        f.write(_apply(src, PROBES[name]))
    with open(os.path.join(_ROOT, "chip_smoke.py")) as f:
        smoke = f.read()
    with open(os.path.join(dst, "chip_smoke.py"), "w") as f:
        f.write(smoke.replace("raise AssertionError(", "print("))
    out = subprocess.run([sys.executable, "chip_smoke.py", "--kernels"],
                         cwd=dst, capture_output=True, text=True)
    print(f"== probe {name}: exit code {out.returncode}", flush=True)
    for line in out.stdout.splitlines():
        m = re.match(r"(B[14] \w+): .*?kernel ([0-9.]+) ms", line)
        if m:
            print(f"{m.group(1)}: kernel {m.group(2)} ms", flush=True)
    if out.returncode != 0:
        print(out.stdout[-2000:], out.stderr[-2000:], flush=True)


def main(argv) -> int:
    for name in argv or list(PROBES):
        run(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
