# Copied from statmc_tpu/io/image.py (numpy host code; behaviour unchanged).
"""Image readers: TGA and PNG (pure numpy, no external deps).

Replaces the reference's lodepng/targa readers (src/ext/lodepng,
src/ext/targa used by src/core/imageio.cpp).  Returns float32 [H,W,3]
linear RGB; 8-bit LDR inputs are inverse-gamma corrected with pbrt's
sRGB curve (imageio.cpp gamma handling).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(
        x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4
    ).astype(np.float32)


def read_image(path: str) -> np.ndarray:
    p = path.lower()
    if p.endswith(".tga"):
        return read_tga(path)
    if p.endswith(".png"):
        return read_png(path)
    if p.endswith(".pfm"):
        from .pfm import read_pfm

        img = read_pfm(path)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img
    if p.endswith(".exr"):
        from .exr import read_exr

        return read_exr(path)
    raise ValueError(f"unsupported image format: {path}")


def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.read(18)
        id_len, cmap_type, img_type = header[0], header[1], header[2]
        w = struct.unpack("<H", header[12:14])[0]
        h = struct.unpack("<H", header[14:16])[0]
        bpp = header[16]
        descriptor = header[17]
        f.read(id_len)
        if cmap_type != 0:
            raise ValueError(f"{path}: colormapped TGA unsupported")
        nch = bpp // 8
        if img_type == 2:  # uncompressed true-color
            data = np.frombuffer(f.read(w * h * nch), np.uint8)
        elif img_type == 3:  # uncompressed grayscale
            data = np.frombuffer(f.read(w * h * nch), np.uint8)
        elif img_type in (10, 11):  # RLE
            raw = f.read()
            out = np.empty(w * h * nch, np.uint8)
            si = di = 0
            total = w * h * nch
            while di < total:
                pk = raw[si]
                si += 1
                count = (pk & 0x7F) + 1
                if pk & 0x80:
                    px = raw[si : si + nch]
                    si += nch
                    out[di : di + count * nch] = np.tile(
                        np.frombuffer(px, np.uint8), count
                    )
                else:
                    nb = count * nch
                    out[di : di + nb] = np.frombuffer(
                        raw[si : si + nb], np.uint8
                    )
                    si += nb
                di += count * nch
            data = out
        else:
            raise ValueError(f"{path}: TGA type {img_type} unsupported")
        img = data.reshape(h, w, nch).astype(np.float32) / 255.0
        if nch >= 3:
            img = img[..., [2, 1, 0]]  # BGR(A) -> RGB
        else:
            img = np.repeat(img[..., :1], 3, axis=-1)
        if not (descriptor & 0x20):  # origin bottom-left
            img = img[::-1]
        return srgb_to_linear(img[..., :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        sig = f.read(8)
        if sig != b"\x89PNG\r\n\x1a\n":
            raise ValueError(f"{path}: not a PNG")
        w = h = bit_depth = color_type = None
        idat = b""
        palette = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            length, ctype = struct.unpack(">I4s", chunk)
            data = f.read(length)
            f.read(4)  # crc
            if ctype == b"IHDR":
                w, h, bit_depth, color_type, comp, filt, interlace = (
                    struct.unpack(">IIBBBBB", data)
                )
                if interlace:
                    raise ValueError(f"{path}: interlaced PNG unsupported")
            elif ctype == b"PLTE":
                palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
            elif ctype == b"IDAT":
                idat += data
            elif ctype == b"IEND":
                break
        raw = zlib.decompress(idat)
        nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
        if bit_depth == 8:
            bpp = nch
            dt = np.uint8
            maxv = 255.0
        elif bit_depth == 16:
            bpp = nch * 2
            dt = ">u2"
            maxv = 65535.0
        else:
            raise ValueError(f"{path}: bit depth {bit_depth} unsupported")
        stride = w * bpp
        img = np.empty((h, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        pos = 0
        for y in range(h):
            ft = raw[pos]
            pos += 1
            line = np.frombuffer(raw[pos : pos + stride], np.uint8).copy()
            pos += stride
            if ft == 0:
                pass
            elif ft == 1:  # Sub
                for i in range(bpp, stride):
                    line[i] = (line[i] + line[i - bpp]) & 0xFF
            elif ft == 2:  # Up
                line = (line.astype(np.int32) + prev) % 256
                line = line.astype(np.uint8)
            elif ft == 3:  # Average
                for i in range(stride):
                    a = line[i - bpp] if i >= bpp else 0
                    line[i] = (line[i] + ((int(a) + int(prev[i])) >> 1)) & 0xFF
            elif ft == 4:  # Paeth
                for i in range(stride):
                    a = int(line[i - bpp]) if i >= bpp else 0
                    b = int(prev[i])
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    pp = a + b - c
                    pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                    pr = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c
                    )
                    line[i] = (line[i] + pr) & 0xFF
            else:
                raise ValueError(f"{path}: unknown PNG filter {ft}")
            img[y] = line
            prev = line
        arr = img.reshape(h, -1).view(dt).reshape(h, w, nch).astype(
            np.float32) / maxv
        if color_type == 3:
            if palette is None:
                raise ValueError(f"{path}: paletted PNG without PLTE")
            idx = (arr[..., 0] * maxv).astype(np.int32)
            arr = palette[idx].astype(np.float32) / 255.0
        elif nch == 1:
            arr = np.repeat(arr, 3, axis=-1)
        elif nch == 2:
            arr = np.repeat(arr[..., :1], 3, axis=-1)
        elif nch == 4:
            arr = arr[..., :3]
        return srgb_to_linear(arr[..., :3])


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1 / 2.4) - 0.055)


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal RGB8 PNG writer (sRGB-encoded); inverse of read_png's
    happy path.  Replaces the reference's lodepng output
    (core/imageio.cpp WriteImage -> lodepng for .png)."""
    import struct
    import zlib

    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    h, w = img.shape[:2]
    u8 = (linear_to_srgb(img[..., :3]) * 255.0 + 0.5).astype(np.uint8)
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
