# Copied from statmc_tpu/io/display.py (socket + numpy host code; behaviour unchanged).
"""tev image-viewer display-server client.

Implements the tev TCP wire protocol exactly as the reference's vendored
pbrt-v4 client does (src/display/pbrt/util/display.cpp):
length-prefixed little-endian packets with directives CreateImage(4) /
UpdateImage(3) / OpenImage(0) / ReloadImage(1) / CloseImage(2), image
updates sent as per-channel tiles (128x128 here as there,
display.cpp:239).  This is the framework's live observability UI for
remote jobs: any regex-selected buffer streams to a tev instance.

Failures degrade gracefully (reconnect on next send), matching
display.cpp:371-388.
"""
from __future__ import annotations

import socket
import struct

import numpy as np

TILE = 128


class TevClient:
    def __init__(self, address: str):
        """address: "host:port" (the --displayserver CLI format)."""
        host, port = address.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.sock: socket.socket | None = None

    def connect(self) -> bool:
        try:
            self.sock = socket.create_connection(
                (self.host, self.port), timeout=2.0
            )
            return True
        except OSError:
            self.sock = None
            return False

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None

    def _send(self, payload: bytes) -> bool:
        if self.sock is None and not self.connect():
            return False
        msg = struct.pack("<I", len(payload) + 4) + payload
        try:
            self.sock.sendall(msg)
            return True
        except OSError:
            self.close()
            return False

    def create_image(self, name: str, width: int, height: int,
                     channels: list[str]) -> bool:
        # directive 4: CreateImage (display.cpp:SendOpenImage payload).
        p = bytearray()
        p += struct.pack("<B", 4)
        p += struct.pack("<B", 1)  # grabFocus
        p += name.encode() + b"\0"
        p += struct.pack("<ii", width, height)
        p += struct.pack("<i", len(channels))
        for c in channels:
            p += c.encode() + b"\0"
        return self._send(bytes(p))

    def update_image(self, name: str, img: np.ndarray,
                     channel_names: list[str] | None = None) -> bool:
        """img: [H,W] or [H,W,C] float32; sends 128x128 tiles/channel
        (directive 3: UpdateImage)."""
        if img.ndim == 2:
            img = img[..., None]
        H, W, C = img.shape
        names = channel_names or (
            ["R", "G", "B"][:C] if C in (1, 3) else
            [f"ch{i}" for i in range(C)]
        )
        if C == 1:
            names = ["R"]
        if not self.create_image(name, W, H, names):
            return False
        ok = True
        for c in range(C):
            for y0 in range(0, H, TILE):
                for x0 in range(0, W, TILE):
                    th = min(TILE, H - y0)
                    tw = min(TILE, W - x0)
                    tile = np.ascontiguousarray(
                        img[y0 : y0 + th, x0 : x0 + tw, c], np.float32
                    )
                    p = bytearray()
                    p += struct.pack("<B", 3)  # UpdateImage
                    p += struct.pack("<B", 0)  # grabFocus
                    p += name.encode() + b"\0"
                    p += names[c].encode() + b"\0"
                    p += struct.pack("<iiii", x0, y0, tw, th)
                    p += tile.tobytes()
                    ok = self._send(bytes(p)) and ok
        return ok

    def display_buffers(self, title: str, buffers: dict[str, np.ndarray]
                        ) -> bool:
        """Merge named buffers into one multi-channel tev image, like
        OutputBufferSelection::Display (buffer.cpp:55-71; 100-channel cap).
        """
        chans: list[tuple[str, np.ndarray]] = []
        for name, arr in buffers.items():
            if arr.ndim == 2:
                chans.append((name, arr))
            else:
                for i, suffix in enumerate("RGB"[: arr.shape[2]]):
                    chans.append((f"{name}.{suffix}", arr[..., i]))
            if len(chans) >= 100:
                break
        chans = chans[:100]
        if not chans:
            return False
        H, W = chans[0][1].shape
        if not self.create_image(title, W, H, [c[0] for c in chans]):
            return False
        ok = True
        for cname, plane in chans:
            for y0 in range(0, H, TILE):
                for x0 in range(0, W, TILE):
                    th = min(TILE, H - y0)
                    tw = min(TILE, W - x0)
                    tile = np.ascontiguousarray(
                        plane[y0 : y0 + th, x0 : x0 + tw], np.float32
                    )
                    p = bytearray()
                    p += struct.pack("<B", 3)
                    p += struct.pack("<B", 0)
                    p += title.encode() + b"\0"
                    p += cname.encode() + b"\0"
                    p += struct.pack("<iiii", x0, y0, tw, th)
                    p += tile.tobytes()
                    ok = self._send(bytes(p)) and ok
        return ok
