# Copied from statmc_tpu/tools/imgtool.py (numpy host code; the usage line and
# the reference's path rewritten, behaviour unchanged).
"""imgtool: image utilities matching the reference tool's commands.

Python equivalent of the reference's src/tools/imgtool.cpp (subcommands
dispatched at imgtool.cpp:770-780): assemble, cat, convert, diff, info,
makesky.  Formats ride the framework's own IO (io/pfm.py, io/exr.py,
io/image.py).  makesky implements the Hosek-Wilkie model's *shape* via
a Preetham-style analytic sky (the reference links the ArHosekSkyModel
C library, src/ext/ArHosekSkyModel.c; the coefficient tables are not
reproduced -- documented deviation, same CLI).

Usage: python -m statmc_tpu_torch.tools.imgtool <command> [options] <files>
"""
from __future__ import annotations

import os
import sys

import numpy as np


def _read(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        from ..io.pfm import read_pfm

        return read_pfm(path)
    if ext == ".exr":
        from ..io.exr import read_exr

        return read_exr(path)
    from ..io.image import read_image

    return read_image(path)


def _write(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        from ..io.pfm import write_pfm

        write_pfm(path, img)
    elif ext == ".exr":
        from ..io.exr import write_exr

        write_exr(path, img)
    else:
        from ..io.image import write_png

        write_png(path, img)


def cmd_info(args: list[str]) -> int:
    for path in args:
        img = _read(path)
        y = 0.212671 * img[..., 0] + 0.715160 * img[..., 1] \
            + 0.072169 * img[..., 2]
        print(f"{path}:")
        print(f"  resolution {img.shape[1]} x {img.shape[0]}")
        print(f"  luminance avg {y.mean():.6g}, min {y.min():.6g}, "
              f"max {y.max():.6g}")
        print(f"  non-finite pixels: {int((~np.isfinite(img)).sum())}")
    return 0


def cmd_convert(args: list[str]) -> int:
    scale = 1.0
    tonemap = False
    files = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--scale":
            i += 1
            scale = float(args[i])
        elif a == "--tonemap":
            tonemap = True
        else:
            files.append(a)
        i += 1
    if len(files) != 2:
        print("usage: imgtool convert [--scale s] [--tonemap] in out",
              file=sys.stderr)
        return 1
    img = _read(files[0]) * scale
    if tonemap:
        img = img / (1.0 + img)  # simple Reinhard
    _write(files[1], img)
    return 0


def cmd_diff(args: list[str]) -> int:
    outfile = None
    tol = 0.0
    files = []
    i = 0
    while i < len(args):
        a = args[i]
        if a in ("--outfile", "-o"):
            i += 1
            outfile = args[i]
        elif a in ("--difftol", "-d"):
            i += 1
            tol = float(args[i])
        else:
            files.append(a)
        i += 1
    if len(files) != 2:
        print("usage: imgtool diff [--outfile f] [--difftol pct] a b",
              file=sys.stderr)
        return 1
    a = _read(files[0])
    b = _read(files[1])
    if a.shape != b.shape:
        print(f"imgtool: resolution mismatch {a.shape} vs {b.shape}",
              file=sys.stderr)
        return 1
    d = a - b
    # imgtool.cpp diff: mean squared error + relative sum difference.
    mse = float((d * d).mean())
    suma, sumb = float(a.sum()), float(b.sum())
    rel = (suma - sumb) / ((suma + sumb) / 2) * 100 if suma + sumb else 0.0
    print(f"images differ: MSE = {mse:.6g}, dsum = {rel:+.4f}%")
    if outfile:
        _write(outfile, np.abs(d))
    return 0 if abs(rel) <= tol else 1


def cmd_assemble(args: list[str]) -> int:
    """Assemble cropped renders into one image (pbrt --cropwindow
    outputs; imgtool.cpp:assemble).  Non-zero pixels win."""
    outfile = None
    files = []
    i = 0
    while i < len(args):
        if args[i] == "--outfile":
            i += 1
            outfile = args[i]
        else:
            files.append(args[i])
        i += 1
    if not outfile or not files:
        print("usage: imgtool assemble --outfile out in1 in2 ...",
              file=sys.stderr)
        return 1
    acc = None
    for path in files:
        img = _read(path)
        if acc is None:
            acc = np.zeros_like(img)
        mask = np.any(img != 0, axis=-1, keepdims=True)
        acc = np.where(mask, img, acc)
    _write(outfile, acc)
    return 0


def cmd_cat(args: list[str]) -> int:
    for path in args:
        img = _read(path)
        for y in range(img.shape[0]):
            for x in range(img.shape[1]):
                r, g, b = img[y, x][:3]
                print(f"({x}, {y}): ({r:.6g}, {g:.6g}, {b:.6g})")
    return 0


def cmd_makesky(args: list[str]) -> int:
    albedo, elevation, turbidity, res = 0.5, 10.0, 3.0, 2048
    outfile = "sky.pfm"
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--albedo":
            i += 1
            albedo = float(args[i])
        elif a == "--elevation":
            i += 1
            elevation = float(args[i])
        elif a == "--turbidity":
            i += 1
            turbidity = float(args[i])
        elif a == "--resolution":
            i += 1
            res = int(args[i])
        elif a == "--outfile":
            i += 1
            outfile = args[i]
        i += 1
    # Equal-area octahedral-ish latlong env map of an analytic clear sky.
    h, w = res, res
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    theta = v * np.pi
    phi = u * 2 * np.pi
    sun_theta = np.radians(90.0 - elevation)
    sun = np.array([np.sin(sun_theta), 0.0, np.cos(sun_theta)])
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                  np.cos(theta)], -1)
    cos_g = np.clip(d @ sun, -1, 1)
    gamma = np.arccos(cos_g)
    cz = np.clip(d[..., 2], 1e-3, 1.0)
    # Perez-style luminance (Preetham A..E for clear sky, scaled by T).
    t = turbidity
    a_, b_, c_, d_, e_ = (0.178 * t - 1.46, -0.355 * t + 0.43,
                          -0.023 * t + 0.30, 0.12 * t - 0.67,
                          -0.067 * t + 0.35)
    lum = (1 + a_ * np.exp(b_ / cz)) * (
        1 + c_ * np.exp(d_ * gamma) + e_ * cos_g**2)
    lum = np.maximum(lum, 0.0)
    # Blue-tinted sky + warm circumsolar region + ground albedo floor.
    sky = lum[..., None] * np.array([0.25, 0.45, 1.0])
    sun_disc = np.exp(-(gamma / 0.02) ** 2)[..., None] * np.array(
        [500.0, 450.0, 400.0])
    img = sky + sun_disc
    img = np.where((d[..., 2] < 0)[..., None],
                   albedo * img.mean() * np.ones(3), img)
    _write(outfile, img.astype(np.float32))
    return 0


COMMANDS = {
    "assemble": cmd_assemble,
    "cat": cmd_cat,
    "convert": cmd_convert,
    "diff": cmd_diff,
    "info": cmd_info,
    "makesky": cmd_makesky,
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print("usage: imgtool <assemble|cat|convert|diff|info|makesky> ...",
              file=sys.stderr)
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
