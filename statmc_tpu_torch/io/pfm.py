# Copied from statmc_tpu/io/pfm.py (numpy host code; imports rewritten, behaviour unchanged).
"""PFM (Portable Float Map) read/write.

PFM is the reference's interchange + checkpoint format: every statistics
buffer is written as `<stem>-<spp>-<name>.pfm`
(src/statistics/buffer.cpp:40-53 via cv::imwrite, and
src/core/imageio.cpp:357+ for the core reader).  We keep the format
bit-compatible so reference tooling can consume our buffers and vice
versa.

Conventions (matching both pbrt and OpenCV writers):
* header: "PF" (3-channel) or "Pf" (1-channel), then "width height",
  then scale; negative scale => little-endian.
* raster is stored bottom-to-top.
"""
from __future__ import annotations

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """Returns float32 array [H, W, 3] or [H, W] (top-down row order)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().split()
        while dims and dims[0].startswith(b"#"):
            dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * channels * 4), dtype=dtype)
        data = data.astype(np.float32)
        if abs(scale) not in (0.0, 1.0):
            data = data * abs(scale)
        if channels == 3:
            img = data.reshape(h, w, 3)
        else:
            img = data.reshape(h, w)
        return img[::-1].copy()  # bottom-up -> top-down


def write_pfm(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] or [H, W] float32, top-down row order."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 3 and img.shape[2] == 3:
        header = b"PF"
    elif img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 1):
        header = b"Pf"
        img = img.reshape(img.shape[0], img.shape[1])
    else:
        raise ValueError(f"write_pfm: unsupported shape {img.shape}")
    h, w = img.shape[0], img.shape[1]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())
