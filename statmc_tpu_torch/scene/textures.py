# Copied from statmc_tpu/scene/textures.py:38-254 (the numpy table builder;
# tables stay numpy, image loading is not ported).
"""Texture table builder (host side).

The slice renders no textures: ``driver.prepare`` raises
NotImplementedError for a scene whose materials reference one.  The
builder still runs so the scene tables keep the JAX package's layout.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

TEX_NONE = -1
MAX_MIP = 12  # mip chain cap (4096x4096 fully reduced)
# Kinds for evaluated textures.
KIND_IMAGE = 0
KIND_CHECKER = 1
KIND_SCALE = 2  # child0 * p0 (constant rgb scale)
KIND_FBM = 3
KIND_WRINKLED = 4
KIND_WINDY = 5
KIND_MARBLE = 6
KIND_DOTS = 7
KIND_UV = 8
KIND_BILERP = 9
KIND_MIX = 10  # lerp(child0, child1, par[0])
KIND_CONSTANT = 11


class TextureTable(NamedTuple):
    atlas: Any  # [T,3] flat texels of all images
    tex_offset: Any  # [N] first texel index
    tex_width: Any  # [N]
    tex_height: Any  # [N]
    tex_kind: Any  # [N]
    tex_p0: Any  # [N,3] kind-specific rgb (checker tex1, const, v00...)
    tex_p1: Any  # [N,3] kind-specific rgb (checker tex2, v01...)
    tex_p2: Any  # [N,3] bilerp v10 / dots inside
    tex_p3: Any  # [N,3] bilerp v11 / dots outside
    tex_uvscale: Any  # [N,2] uscale, vscale
    tex_par: Any  # [N,4] octaves, omega/roughness, scale, variation
    tex_child: Any  # [N,2] child texture ids for scale/mix (-1 none)
    tex_mip_offset: Any  # [N,MAX_MIP] per-level atlas offsets
    tex_mip_w: Any  # [N,MAX_MIP]
    tex_mip_h: Any  # [N,MAX_MIP]
    tex_n_mips: Any  # [N]
    has_children: bool  # static: any scale/mix rows present
    # Static tuple of the texture kinds present (sorted ints); survives
    # the table becoming a jit argument (driver.split_device_args) so
    # kind gating stays a compile-time decision.  None on tables built
    # by hand (helpers fall back to evaluating every kind).
    kinds_static: Any = None

    @staticmethod
    def empty():
        return TextureTable(
            atlas=np.zeros((1, 3), np.float32),
            tex_offset=np.zeros((1,), np.int32),
            tex_width=np.ones((1,), np.int32),
            tex_height=np.ones((1,), np.int32),
            tex_kind=np.zeros((1,), np.int32),
            tex_p0=np.ones((1, 3), np.float32),
            tex_p1=np.zeros((1, 3), np.float32),
            tex_p2=np.zeros((1, 3), np.float32),
            tex_p3=np.zeros((1, 3), np.float32),
            tex_uvscale=np.ones((1, 2), np.float32),
            tex_par=np.zeros((1, 4), np.float32),
            tex_child=-np.ones((1, 2), np.int32),
            tex_mip_offset=np.zeros((1, MAX_MIP), np.int32),
            tex_mip_w=np.ones((1, MAX_MIP), np.int32),
            tex_mip_h=np.ones((1, MAX_MIP), np.int32),
            tex_n_mips=np.ones((1,), np.int32),
            has_children=False,
            kinds_static=(KIND_CONSTANT,),
        )


class TextureTableBuilder:
    def __init__(self):
        self.texels: list[np.ndarray] = []
        self.rows: list[dict] = []
        self._cache: dict[str, int] = {}

    def _row(self, kind, **kw) -> int:
        row = dict(
            offset=0, width=1, height=1, kind=kind,
            p0=np.ones(3, np.float32), p1=np.zeros(3, np.float32),
            p2=np.zeros(3, np.float32), p3=np.zeros(3, np.float32),
            uv=np.ones(2, np.float32),
            par=np.zeros(4, np.float32),
            child=np.array([-1, -1], np.int32),
            mip_offset=np.zeros(MAX_MIP, np.int32),
            mip_w=np.ones(MAX_MIP, np.int32),
            mip_h=np.ones(MAX_MIP, np.int32),
            n_mips=1,
        )
        row.update(kw)
        self.rows.append(row)
        return len(self.rows) - 1

    def add_image(self, path: str, uscale=1.0, vscale=1.0) -> int:
        raise NotImplementedError(
            "image textures are not ported yet (ROADMAP.md queue A, "
            f"'Textures'): {path}")

    def add_checker(self, rgb1, rgb2, uscale=1.0, vscale=1.0) -> int:
        return self._row(
            KIND_CHECKER, p0=np.asarray(rgb1, np.float32),
            p1=np.asarray(rgb2, np.float32),
            uv=np.array([uscale, vscale], np.float32),
        )

    def add_constant(self, rgb) -> int:
        return self._row(KIND_CONSTANT, p0=np.asarray(rgb, np.float32))

    def add_noise(self, kind, octaves=8, omega=0.5, scale=1.0,
                  variation=0.2) -> int:
        return self._row(
            kind,
            par=np.array([octaves, omega, scale, variation], np.float32),
        )

    def add_dots(self, inside, outside, uscale=1.0, vscale=1.0) -> int:
        return self._row(
            KIND_DOTS, p2=np.asarray(inside, np.float32),
            p3=np.asarray(outside, np.float32),
            uv=np.array([uscale, vscale], np.float32),
        )

    def add_uv(self, uscale=1.0, vscale=1.0) -> int:
        return self._row(
            KIND_UV, uv=np.array([uscale, vscale], np.float32)
        )

    def add_bilerp(self, v00, v01, v10, v11) -> int:
        return self._row(
            KIND_BILERP, p0=np.asarray(v00, np.float32),
            p1=np.asarray(v01, np.float32), p2=np.asarray(v10, np.float32),
            p3=np.asarray(v11, np.float32),
        )

    def add_scale(self, child: int, scale_rgb) -> int:
        return self._row(
            KIND_SCALE, p0=np.asarray(scale_rgb, np.float32),
            child=np.array([child, -1], np.int32),
        )

    def add_mix(self, child0: int, child1: int, amount: float,
                c0_rgb=None, c1_rgb=None) -> int:
        """Mix of two operands; texture children take precedence over
        constant rgb fallbacks (textures/mix.cpp)."""
        return self._row(
            KIND_MIX,
            p0=np.asarray(c0_rgb if c0_rgb is not None else (0, 0, 0),
                          np.float32),
            p1=np.asarray(c1_rgb if c1_rgb is not None else (1, 1, 1),
                          np.float32),
            par=np.array([amount, 0, 0, 0], np.float32),
            child=np.array([child0, child1], np.int32),
        )

    def build(self) -> TextureTable:
        if not self.rows:
            return TextureTable.empty()
        atlas = (np.concatenate(self.texels, 0) if self.texels
                 else np.zeros((1, 3), np.float32))
        return TextureTable(
            atlas=np.asarray(atlas),
            tex_offset=np.asarray([r["offset"] for r in self.rows],
                                   np.int32),
            tex_width=np.asarray([r["width"] for r in self.rows], np.int32),
            tex_height=np.asarray([r["height"] for r in self.rows],
                                   np.int32),
            tex_kind=np.asarray([r["kind"] for r in self.rows], np.int32),
            tex_p0=np.asarray(np.stack([r["p0"] for r in self.rows])),
            tex_p1=np.asarray(np.stack([r["p1"] for r in self.rows])),
            tex_p2=np.asarray(np.stack([r["p2"] for r in self.rows])),
            tex_p3=np.asarray(np.stack([r["p3"] for r in self.rows])),
            tex_uvscale=np.asarray(np.stack([r["uv"] for r in self.rows])),
            tex_par=np.asarray(np.stack([r["par"] for r in self.rows])),
            tex_child=np.asarray(np.stack([r["child"] for r in self.rows])),
            tex_mip_offset=np.asarray(
                np.stack([r["mip_offset"] for r in self.rows])),
            tex_mip_w=np.asarray(np.stack([r["mip_w"] for r in self.rows])),
            tex_mip_h=np.asarray(np.stack([r["mip_h"] for r in self.rows])),
            tex_n_mips=np.asarray([r["n_mips"] for r in self.rows],
                                   np.int32),
            has_children=any(
                r["kind"] in (KIND_SCALE, KIND_MIX) for r in self.rows
            ),
            kinds_static=tuple(sorted({r["kind"] for r in self.rows})),
        )
