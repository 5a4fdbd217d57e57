# Copied from statmc_tpu/tools/cyhair2pbrt.py (numpy host code; the usage line and
# the reference's path rewritten, behaviour unchanged).
"""cyhair2pbrt: CyHair (.hair) -> pbrt curve-shape converter.

Re-derivation of the reference tool (the reference's src/tools/
cyhair2pbrt.cpp): parses the HAIR binary format (128-byte header,
optional per-strand segment counts, per-point positions / thickness),
converts each strand's Catmull-Rom polyline to cubic Bezier segments,
and emits `Shape "curve" "string type" ["cylinder"]` blocks.

Usage: python -m statmc_tpu_torch.tools.cyhair2pbrt in.hair out.pbrt \
           [max_strands] [thickness]
"""
from __future__ import annotations

import struct
import sys

import numpy as np

_HAS_SEGMENTS = 1
_HAS_POINTS = 2
_HAS_THICKNESS = 4


def read_cyhair(path: str):
    """Returns (strands, thickness): lists of [n,3] / [n] arrays."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"HAIR":
        raise ValueError(f"{path}: not a CyHair file")
    n_strands, n_points, flags, d_segments = struct.unpack_from(
        "<IIII", data, 4)
    d_thickness, _d_transp = struct.unpack_from("<ff", data, 20)
    off = 128
    if flags & _HAS_SEGMENTS:
        segments = np.frombuffer(data, "<u2", n_strands, off).astype(int)
        off += 2 * n_strands
    else:
        segments = np.full(n_strands, d_segments, int)
    if not flags & _HAS_POINTS:
        raise ValueError("CyHair file without points")
    pts = np.frombuffer(data, "<f4", n_points * 3, off).reshape(-1, 3)
    off += 12 * n_points
    if flags & _HAS_THICKNESS:
        thick = np.frombuffer(data, "<f4", n_points, off)
    else:
        thick = np.full(n_points, d_thickness, np.float32)

    strands, radii = [], []
    p = 0
    for s in range(n_strands):
        n = segments[s] + 1
        strands.append(pts[p:p + n])
        radii.append(thick[p:p + n])
        p += n
    return strands, radii


def catmull_rom_to_bezier(pts):
    """Polyline -> list of cubic Bezier control quads (the reference's
    ToCubicBezierCurves tangent construction: c1 = p1 + (p2-p0)/6)."""
    n = len(pts)
    if n < 2:
        return []
    out = []
    for i in range(n - 1):
        p1, p2 = pts[i], pts[i + 1]
        p0 = pts[i - 1] if i > 0 else p1
        p3 = pts[i + 2] if i + 2 < n else p2
        c1 = p1 + (p2 - p0) / 6.0
        c2 = p2 - (p3 - p1) / 6.0
        out.append(np.stack([p1, c1, c2, p2]))
    return out


def convert(in_path: str, out_path: str, max_strands: int = -1,
            thickness: float = 1.0) -> int:
    strands, radii = read_cyhair(in_path)
    if max_strands > 0:
        strands = strands[:max_strands]
        radii = radii[:max_strands]
    n_curves = 0
    f = sys.stdout if out_path == "-" else open(out_path, "w")
    try:
        f.write(f"# generated by cyhair2pbrt from {in_path}\n")
        for pts, rad in zip(strands, radii):
            beziers = catmull_rom_to_bezier(np.asarray(pts, np.float64))
            nb = len(beziers)
            for i, bz in enumerate(beziers):
                w0 = float(rad[i]) * thickness
                w1 = float(rad[min(i + 1, len(rad) - 1)]) * thickness
                ctrl = " ".join(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g}"
                                for p in bz)
                f.write('Shape "curve" "string type" ["cylinder"] '
                        f'"point P" [{ctrl}] '
                        f'"float width0" [{w0:.6g}] '
                        f'"float width1" [{w1:.6g}]\n')
                n_curves += 1
    finally:
        if f is not sys.stdout:
            f.close()
    return n_curves


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: cyhair2pbrt [CyHair filename] [pbrt output "
              "filename] (max strands) (thickness)", file=sys.stderr)
        return 1
    max_strands = int(argv[2]) if len(argv) > 2 else -1
    thickness = float(argv[3]) if len(argv) > 3 else 1.0
    n = convert(argv[0], argv[1], max_strands, thickness)
    print(f"wrote {n} curve segments", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
