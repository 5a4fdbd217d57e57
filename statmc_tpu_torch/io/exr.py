# Copied from statmc_tpu/io/exr.py (numpy host code; behaviour unchanged).
"""Minimal OpenEXR scanline codec (pure numpy).

Replaces the reference's bundled OpenEXR (src/ext/openexr used by
src/core/imageio.cpp:ReadImageEXR/WriteImageEXR) for the common subset
pbrt assets use: single-part scanline images, HALF or FLOAT channels,
NO/ZIP/ZIPS compression, RGB(A)/Y channel sets.  Writes uncompressed
FLOAT RGB.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2


def write_exr(path: str, img: np.ndarray) -> None:
    """img: [H,W,3] float32 -> uncompressed FLOAT RGB EXR."""
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(data)) + data)

    chans = b""
    for c in (b"B", b"G", b"R"):
        chans += c + b"\0" + struct.pack("<iBBBBii", _PT_FLOAT, 0, 0, 0, 0,
                                         1, 1)
    chans += b"\0"
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = b""
    header += attr("channels", "chlist", chans)
    header += attr("compression", "compression", b"\0")
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        # Scanline offset table.
        data_start = f.tell() + 8 * H
        line_size = 8 + W * 4 * 3
        offsets = [data_start + i * line_size for i in range(H)]
        f.write(struct.pack(f"<{H}q", *offsets))
        for y in range(H):
            f.write(struct.pack("<ii", y, W * 4 * 3))
            # Channels in alphabetical order: B, G, R.
            for c in (2, 1, 0):
                f.write(np.ascontiguousarray(img[y, :, c], "<f4").tobytes())


def _exr_reconstruct(data: bytes) -> np.ndarray:
    """EXR ZIP post-decompress reconstruction: undo the byte-delta
    predictor (t[i] = t[i-1] + raw[i] - 128 mod 256) then de-interleave
    (first half = even output bytes, second half = odd)."""
    raw = np.frombuffer(data, np.uint8).astype(np.int64)
    deltas = raw.copy()
    deltas[1:] -= 128
    out = np.cumsum(deltas) & 0xFF
    n = out.shape[0]
    half = (n + 1) // 2
    res = np.empty(n, np.uint8)
    res[0::2] = out[:half].astype(np.uint8)
    res[1::2] = out[half:].astype(np.uint8)
    return res


def read_exr(path: str) -> np.ndarray:
    """Returns float32 [H,W,3] (Y replicated; extra channels dropped)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:
            raise ValueError(f"{path}: tiled EXR unsupported")

        def read_cstr():
            out = b""
            while True:
                ch = f.read(1)
                if ch in (b"\0", b""):
                    return out.decode()
                out += ch

        channels = []
        compression = 0
        data_window = None
        while True:
            name = read_cstr()
            if not name:
                break
            typ = read_cstr()
            size = struct.unpack("<i", f.read(4))[0]
            data = f.read(size)
            if name == "channels":
                pos = 0
                while data[pos] != 0:
                    end = data.index(b"\0", pos)
                    cname = data[pos:end].decode()
                    ptype = struct.unpack("<i", data[end + 1 : end + 5])[0]
                    channels.append((cname, ptype))
                    pos = end + 1 + 16
            elif name == "compression":
                compression = data[0]
            elif name == "dataWindow":
                data_window = struct.unpack("<iiii", data)
        x0, y0, x1, y1 = data_window
        W, H = x1 - x0 + 1, y1 - y0 + 1
        if compression not in (0, 2, 3):  # NONE, ZIPS, ZIP
            raise ValueError(
                f"{path}: compression {compression} unsupported (use "
                "none/zip/zips)"
            )
        lines_per_block = {0: 1, 2: 1, 3: 16}[compression]
        n_blocks = (H + lines_per_block - 1) // lines_per_block
        f.read(8 * n_blocks)  # offset table

        pixel_size = sum(2 if pt == _PT_HALF else 4 for _, pt in channels)
        planes = {c: np.zeros((H, W), np.float32) for c, _ in channels}
        for _ in range(n_blocks):
            y, size = struct.unpack("<ii", f.read(8))
            raw = f.read(size)
            nrows = min(lines_per_block, H - (y - y0))
            expect = nrows * W * pixel_size
            if compression in (2, 3):
                raw = zlib.decompress(raw)
                if len(raw) == expect:
                    raw = _exr_reconstruct(raw).tobytes()
            pos = 0
            for row in range(nrows):
                for cname, ptype in channels:
                    nbytes = W * (2 if ptype == _PT_HALF else 4)
                    chunk = raw[pos : pos + nbytes]
                    pos += nbytes
                    if ptype == _PT_HALF:
                        vals = np.frombuffer(chunk, "<f2").astype(np.float32)
                    elif ptype == _PT_FLOAT:
                        vals = np.frombuffer(chunk, "<f4").astype(np.float32)
                    else:
                        vals = np.frombuffer(chunk, "<u4").astype(np.float32)
                    planes[cname][y - y0 + row] = vals
        if all(c in planes for c in "RGB"):
            return np.stack([planes["R"], planes["G"], planes["B"]], -1)
        if "Y" in planes:
            return np.repeat(planes["Y"][..., None], 3, -1)
        first = next(iter(planes.values()))
        return np.repeat(first[..., None], 3, -1)
