# Copied from statmc_tpu/scene/textures.py:38-254 (the numpy table
# builder, add_image's MIP pyramid included); the lookups of :261-620 are
# ported to torch below.
"""Texture system: image atlas + procedural textures over ray lanes.

Every image texture is packed into one flat texel atlas with a box-
filtered power-of-two MIP pyramid (``add_image``); lookups are batched
bilinear gathers over lanes.  Procedural textures evaluate branchlessly
across all lanes and are selected per lane by kind: checkerboard, uv,
bilerp, dots (2-D mappings), fbm, wrinkled, windy, marble (3-D gradient
noise with the JAX package's arithmetic lattice hash), plus scale/mix
combinators over one level of child textures and folded constants.

The tables are built in numpy and lifted to tensors by ``to_device``;
``kinds_static`` stays a Python tuple, so which kinds a lookup evaluates
is decided on the host.  The lookups compute the JAX package's values
lane for lane; where the JAX code repeats one computation over several
inputs (the 8 lattice corners of a noise sample, the octaves of fbm, the
8 EWA taps, the 2 MIP levels and 4 texels of a trilinear tap) the port
stacks the inputs and runs the computation once, so each of those costs
one set of kernel launches instead of one per input.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import spans
from ..core import math as cm

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
    # Static tuple of the texture kinds present (sorted ints): which kinds
    # a lookup evaluates is a host decision.  None on tables built by hand
    # (lookups then evaluate every kind).
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

    def to_device(self, device="cpu") -> "TextureTable":
        """numpy (or tensors) -> tensors on `device`; the static fields
        stay Python values."""
        return TextureTable(*[
            torch.as_tensor(x, device=device)
            if isinstance(x, (np.ndarray, torch.Tensor)) else x
            for x in self])


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
        key = f"img:{path}:{uscale}:{vscale}"
        if key in self._cache:
            return self._cache[key]
        from ..io.image import read_image

        try:
            img = read_image(path)
        except (OSError, ValueError):
            return TEX_NONE
        # MIP pyramid (core/mipmap.h): box-filtered power-of-two chain,
        # all levels appended to the flat atlas; trilinear lookups blend
        # two levels by the ray-cone footprint (sample_texture).
        levels = [img.astype(np.float32)]
        while min(levels[-1].shape[0], levels[-1].shape[1]) > 1:
            src = levels[-1]
            h2, w2 = max(src.shape[0] // 2, 1), max(src.shape[1] // 2, 1)
            src = src[: h2 * 2, : w2 * 2]
            down = 0.25 * (src[0::2, 0::2] + src[1::2, 0::2]
                           + src[0::2, 1::2] + src[1::2, 1::2])
            levels.append(down)
        levels = levels[:MAX_MIP]
        mo = np.zeros((MAX_MIP,), np.int32)
        mw = np.ones((MAX_MIP,), np.int32)
        mh = np.ones((MAX_MIP,), np.int32)
        for li, lvl in enumerate(levels):
            mo[li] = sum(t.shape[0] for t in self.texels)
            mw[li] = lvl.shape[1]
            mh[li] = lvl.shape[0]
            self.texels.append(lvl.reshape(-1, 3))
        mo[len(levels):] = mo[len(levels) - 1]
        mw[len(levels):] = mw[len(levels) - 1]
        mh[len(levels):] = mh[len(levels) - 1]
        tid = self._row(
            KIND_IMAGE, offset=int(mo[0]), width=img.shape[1],
            height=img.shape[0], uv=np.array([uscale, vscale], np.float32),
            mip_offset=mo, mip_w=mw, mip_h=mh, n_mips=len(levels),
        )
        self._cache[key] = tid
        return tid

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


# ---------------------------------------------------------------------------
# Gradient noise (core/texture.cpp:Noise/FBm/Turbulence, arithmetic hash).

_MASK = 0xFFFFFFFF
# The 8 lattice corners of a noise cell, in the JAX package's order
# (w000, w100, w010, w110, w001, w101, w011, w111).
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64)
_CORNERS_T = tuple(map(tuple, _CORNERS.T.tolist()))  # for core/math.py:const


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) on int64, without overflow:
    the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _hash3(ix, iy, iz):
    """The JAX package's uint32 lattice hash on int64 lanes: the indices
    wrap mod 2^32 as its astype(uint32) does, every product is masked to
    32 bits and the shifts are logical.  Returns int64 in [0, 16)."""
    ux, uy, uz = (x.long() & _MASK for x in (ix, iy, iz))
    h = (_mul32(ux, 0x27D4EB2D) ^ _mul32(uy, 0x165667B1)
         ^ _mul32(uz, 0x9E3779B9))
    h = h ^ (h >> 15)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return h & 15


def _grad(h, dx, dy, dz):
    """pbrt Grad (texture.cpp:446): 16 gradient directions by hash."""
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return u + v


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def noise3(px, py, pz):
    """Band-limited gradient noise in [-1, 1]; inputs any shape.  The 8
    corners' hashes and gradients run as one stacked computation."""
    ix, iy, iz = torch.floor(px), torch.floor(py), torch.floor(pz)
    d = torch.stack([px - ix, py - iy, pz - iz])  # [3, ...]
    i = torch.stack([ix, iy, iz]).long()
    off = cm.const(_CORNERS_T, px.device, torch.int64).reshape(
        (3, 8) + (1,) * px.dim())
    ci = i[:, None] + off  # [3, 8, ...]
    cd = d[:, None] - off.to(d.dtype)
    g = _grad(_hash3(ci[0], ci[1], ci[2]), cd[0], cd[1], cd[2])  # [8, ...]
    wx, wy, wz = _noise_weight(d)
    x00 = g[0] + wx * (g[1] - g[0])
    x10 = g[2] + wx * (g[3] - g[2])
    x01 = g[4] + wx * (g[5] - g[4])
    x11 = g[6] + wx * (g[7] - g[6])
    y0 = x00 + wy * (x10 - x00)
    y1 = x01 + wy * (x11 - x01)
    return y0 + wz * (y1 - y0)


def noise_p(p):
    return noise3(p[..., 0], p[..., 1], p[..., 2])


_MAX_OCTAVES = 8


def _octave_points(p, n: int):
    """[n, ..., 3]: p scaled by each octave's frequency (1.99^i, rounded
    to float32 as the JAX package's Python-float factor is)."""
    lam, lams = 1.0, []
    for _ in range(n):
        lams.append(lam)
        lam = lam * 1.99
    scale = cm.const(tuple(lams), p.device, p.dtype)
    return p[None] * scale.reshape((n,) + (1,) * p.dim())


def _sum_octaves(nv, omega, octaves, turb: bool):
    """FBm (turb=False) or Turbulence over the noise of each octave,
    nv [n, ...]: the JAX package's loop, term by term.  omega and octaves
    are per-lane tensors or Python numbers."""
    total = torch.zeros_like(nv[0])
    o = 1.0
    for i in range(nv.shape[0]):
        contrib = o * (torch.abs(nv[i]) if turb else nv[i])
        if torch.is_tensor(octaves):
            total = total + torch.where(i < octaves, contrib, 0.0)
        elif i < octaves:
            total = total + contrib
        o = o * omega
    return total


def fbm(p, omega, octaves):
    """texture.cpp:FBm without differentials: fixed octave count."""
    n = _MAX_OCTAVES if torch.is_tensor(octaves) else min(int(octaves),
                                                          _MAX_OCTAVES)
    return _sum_octaves(noise_p(_octave_points(p, n)), omega, octaves, False)


def turbulence(p, omega, octaves):
    n = _MAX_OCTAVES if torch.is_tensor(octaves) else min(int(octaves),
                                                          _MAX_OCTAVES)
    return _sum_octaves(noise_p(_octave_points(p, n)), omega, octaves, True)


# Marble spline colors (textures/marble.cpp:Evaluate).
_MARBLE_C = np.array([
    [.58, .58, .6], [.58, .58, .6], [.58, .58, .6],
    [.5, .5, .5], [.6, .59, .58], [.58, .58, .6],
    [.58, .58, .6], [.2, .2, .33], [.58, .58, .6],
], np.float32)
_MARBLE_C_ROWS = tuple(map(tuple, _MARBLE_C.tolist()))


def _marble_color(marble):
    """marble.cpp's spline of the marble coordinate."""
    t = 0.5 + 0.5 * torch.sin(marble)
    nseg = _MARBLE_C.shape[0] - 3
    first = torch.clamp(torch.floor(t * nseg).to(torch.int64), 0, nseg - 1)
    tt = t * nseg - first.to(t.dtype)
    c = cm.const(_MARBLE_C_ROWS, t.device)
    c0, c1, c2, c3 = (c[first + k] for k in range(4))
    # Bezier via de Casteljau (marble.cpp:60-67), scaled by 1.5.
    tt = tt[..., None]
    s0 = (1 - tt) * c0 + tt * c1
    s1 = (1 - tt) * c1 + tt * c2
    s2 = (1 - tt) * c2 + tt * c3
    s0 = (1 - tt) * s0 + tt * s1
    s1 = (1 - tt) * s1 + tt * s2
    return 1.5 * ((1 - tt) * s0 + tt * s1)


def _marble(p, octaves, omega, scale, variation):
    ps = p * scale[..., None]
    return _marble_color(ps[..., 1] + variation * fbm(ps, omega, octaves))


def _dots(uvs, inside, outside):
    """textures/dots.cpp: noise-placed dots in uv cells (its three noise
    samples as one stacked call)."""
    s, t = uvs[..., 0], uvs[..., 1]
    s_cell = torch.floor(s + 0.5)
    t_cell = torch.floor(t + 0.5)
    z = torch.full_like(s_cell, 0.5)
    n = noise3(torch.stack([s_cell + 0.5, s_cell + 1.5, t_cell + 4.5]),
               torch.stack([t_cell + 0.5, t_cell + 2.8, s_cell + 9.2]),
               torch.stack([z, z, z]))
    have_dot = n[0] > 0
    radius = 0.35
    max_shift = 0.5 - radius
    s_center = s_cell + max_shift * n[1]
    t_center = t_cell + max_shift * n[2]
    ds = s - s_center
    dt = t - t_center
    in_dot = have_dot & (ds * ds + dt * dt < radius * radius)
    return torch.where(in_dot[..., None], inside, outside)


# ---------------------------------------------------------------------------
# Image lookups: bilinear, trilinear (MIP), EWA-equivalent anisotropic.


def _bilinear_level(table: TextureTable, tid, uvs, level):
    """Bilinear sample of one mip level per lane (wrap addressing); tid
    and level broadcast against uvs' leading dimensions.  The 4 texels
    are one gather."""
    w = table.tex_mip_w[tid, level].long()
    h = table.tex_mip_h[tid, level].long()
    off = table.tex_mip_offset[tid, level].long()
    u = uvs[..., 0] * w.to(uvs.dtype) - 0.5
    # pbrt flips v for images (imagemap.cpp: (1-t)).
    v = (1.0 - uvs[..., 1]) * h.to(uvs.dtype) - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    # Texels (u0, v0), (u0 + 1, v0), (u0, v0 + 1), (u0 + 1, v0 + 1).
    iu = torch.stack([u0, u0 + 1, u0, u0 + 1]).long()
    iv = torch.stack([v0, v0, v0 + 1, v0 + 1]).long()
    iu = torch.remainder(iu, torch.clamp(w, min=1))
    iv = torch.remainder(iv, torch.clamp(h, min=1))
    t = table.atlas[off + iv * w + iu]  # [4, ..., 3]
    return (t[0] * ((1 - fu) * (1 - fv))[..., None]
            + t[1] * (fu * (1 - fv))[..., None]
            + t[2] * ((1 - fu) * fv)[..., None]
            + t[3] * (fu * fv)[..., None])


EWA_TAPS = 8       # taps along the major axis
EWA_MAX_ANISO = 8  # mipmap.h MaxAnisotropy default
# Gaussian-spaced tap offsets in [-1, 1] along the major axis, and their
# normalized alpha = 2 Gaussian weights (mipmap.h:EWA), in float32.
_EWA_TS = ((np.arange(EWA_TAPS, dtype=np.float32) + np.float32(0.5))
           / np.float32(EWA_TAPS) * np.float32(2.0) - np.float32(1.0))
_EWA_WTS = np.exp(np.float32(-2.0) * _EWA_TS * _EWA_TS)
_EWA_WTS = _EWA_WTS / _EWA_WTS.sum(dtype=np.float32)
_EWA_TS_VALUES = tuple(_EWA_TS.tolist())


def has_image_textures(table: TextureTable) -> bool:
    """Host check: can the table hold image rows?  Gates the per-hit
    anisotropic footprint (render/intersect.py)."""
    return table.kinds_static is None or KIND_IMAGE in table.kinds_static


def _trilinear(table: TextureTable, tid, uvs, minor):
    """Two-level mip blend at footprint `minor` (uv units); the two
    levels are one stacked bilinear lookup."""
    w = table.tex_width[tid]
    h = table.tex_height[tid]
    res = torch.maximum(w, h).to(uvs.dtype)
    top = table.tex_n_mips[tid] - 1
    lod = torch.log2(torch.clamp(minor * res, min=1e-6))
    lod = torch.minimum(torch.clamp(lod, min=0.0), top.to(uvs.dtype))
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.minimum(l0 + 1, top.long())
    fl = (lod - l0.to(uvs.dtype))[..., None]
    # Levels [2, (1,) * extra leading dims of uvs, ...lod's shape].
    lv = torch.stack([l0, l1]).reshape(
        (2,) + (1,) * (uvs.dim() - 1 - lod.dim()) + tuple(lod.shape))
    b = _bilinear_level(table, tid, uvs, lv)
    return (1.0 - fl) * b[0] + fl * b[1]


def _ewa_lookup(table: TextureTable, tid, uvs, duv_major, duv_minor):
    """Anisotropic footprint filtering (core/mipmap.h:EWA equivalent):
    EWA_TAPS Gaussian-weighted trilinear taps spaced along the major
    axis, each filtered at the minor-axis width, the eccentricity clamped
    at EWA_MAX_ANISO.  The taps are one stacked trilinear lookup, summed
    in tap order.  duv_major/duv_minor: [R,2] uv-space footprint axes."""
    maj = torch.linalg.vector_norm(duv_major, dim=-1)
    mino = torch.linalg.vector_norm(duv_minor, dim=-1)
    swap = mino > maj
    maj2 = torch.where(swap, mino, maj)
    min2 = torch.where(swap, maj, mino)
    dmaj = torch.where(swap[..., None], duv_minor, duv_major)
    min2 = torch.maximum(min2, maj2 / EWA_MAX_ANISO)
    ts = cm.const(_EWA_TS_VALUES, uvs.device).reshape(
        (EWA_TAPS,) + (1,) * uvs.dim())
    vals = _trilinear(table, tid, uvs[None] + dmaj[None] * ts, min2)
    out = 0.0
    for k in range(EWA_TAPS):
        out = out + float(_EWA_WTS[k]) * vals[k]
    return out


# ---------------------------------------------------------------------------
# Per-lane evaluation.


def _kinds_present(table: TextureTable):
    """The kinds a lookup must evaluate (None: all of them)."""
    return None if table.kinds_static is None else set(table.kinds_static)


def _base_value(table: TextureTable, tid, kind, uvs, p, uv_fp=None,
                uv_axes=None):
    """Evaluate the non-combinator kinds present in the table for every
    lane and select by kind.  A kind absent from the table is not
    evaluated: no lane can select it, so every lane's value is the one
    the JAX package's full evaluation selects.

    uv_fp: optional [R] uv-space footprint (ray-cone width) driving the
    trilinear mip blend (core/mipmap.h:Lookup width path).
    uv_axes: optional [R,2,2] anisotropic footprint (major/minor uv
    axes); when given, image lanes use the EWA-equivalent path."""
    kinds = _kinds_present(table)

    def present(k):
        return kinds is None or k in kinds

    par = table.tex_par[tid]
    octaves = par[..., 0]
    omega = par[..., 1]

    if not present(KIND_IMAGE):
        out = torch.zeros(uvs.shape[:-1] + (3,), device=uvs.device)
    elif uv_axes is not None:
        # The axes already include the uvscale factor (sample_texture).
        out = _ewa_lookup(table, tid, uvs, uv_axes[..., 0, :],
                          uv_axes[..., 1, :])
    elif uv_fp is None:
        out = _bilinear_level(table, tid, uvs, torch.zeros_like(tid))
    else:
        # mipmap.h: trilinear blend of the two bracketing levels.
        out = _trilinear(table, tid, uvs, uv_fp)

    def select(k, value):
        return torch.where((kind == k)[..., None], value, out)

    if present(KIND_CHECKER):
        # Checkerboard (textures/checkerboard.cpp 2D mode).
        cu = torch.floor(uvs[..., 0]).to(torch.int64)
        cv = torch.floor(uvs[..., 1]).to(torch.int64)
        even = torch.remainder(cu + cv, 2) == 0
        out = select(KIND_CHECKER, torch.where(
            even[..., None], table.tex_p0[tid], table.tex_p1[tid]))
    if present(KIND_CONSTANT):
        out = select(KIND_CONSTANT, table.tex_p0[tid])
    if present(KIND_UV) or present(KIND_BILERP):
        fuv = torch.remainder(uvs, 1.0)
    if present(KIND_UV):
        out = select(KIND_UV, torch.cat(
            [fuv, torch.zeros_like(fuv[..., :1])], -1))
    if present(KIND_BILERP):
        fu_b, fv_b = fuv[..., 0:1], fuv[..., 1:2]
        out = select(KIND_BILERP,
                     (1 - fu_b) * (1 - fv_b) * table.tex_p0[tid]
                     + (1 - fu_b) * fv_b * table.tex_p1[tid]
                     + fu_b * (1 - fv_b) * table.tex_p2[tid]
                     + fu_b * fv_b * table.tex_p3[tid])
    if present(KIND_DOTS):
        out = select(KIND_DOTS,
                     _dots(uvs, table.tex_p2[tid], table.tex_p3[tid]))

    # 3-D noise kinds: every octave point set they need is noised in one
    # stacked call -- fbm, wrinkled and windy's wave share the octaves
    # of p, windy's wind takes 3 octaves of 0.1 p, marble 8 of p * scale.
    sets = []
    if present(KIND_FBM) or present(KIND_WRINKLED):
        sets.append(("p", _MAX_OCTAVES, p))
    elif present(KIND_WINDY):
        sets.append(("p", 6, p))
    if present(KIND_WINDY):
        sets.append(("wind", 3, 0.1 * p))
    if present(KIND_MARBLE):
        ps = p * par[..., 2][..., None]
        sets.append(("marble", _MAX_OCTAVES, ps))
    if sets:
        nv = noise_p(torch.cat([_octave_points(q, n) for _, n, q in sets]))
        noise, at = {}, 0
        for name, n, _ in sets:
            noise[name] = nv[at:at + n]
            at += n
    if present(KIND_FBM):
        out = select(KIND_FBM, _sum_octaves(noise["p"], omega, octaves,
                                            False)[..., None])
    if present(KIND_WRINKLED):
        out = select(KIND_WRINKLED, _sum_octaves(noise["p"], omega, octaves,
                                                 True)[..., None])
    if present(KIND_WINDY):
        wind = _sum_octaves(noise["wind"], 0.5, 3, False)
        wave = _sum_octaves(noise["p"][:6], 0.5, 6, False)
        out = select(KIND_WINDY, (torch.abs(wind) * wave)[..., None])
    if present(KIND_MARBLE):
        fb = _sum_octaves(noise["marble"], omega, octaves, False)
        out = select(KIND_MARBLE,
                     _marble_color(ps[..., 1] + par[..., 3] * fb))
    return out


def sample_texture(table: TextureTable, tex_id, uv, p=None, uv_fp=None,
                   uv_axes=None):
    """Texture sample per lane: tex_id [R] (>=0), uv [R,2], p [R,3]
    world position for 3-D noise textures, uv_fp [R] ray-cone footprint
    in uv units for the mip blend, uv_axes [R,2,2] optional anisotropic
    footprint (major/minor uv axes) enabling the EWA-equivalent filter.

    Lanes with tex_id < 0 return 1.0 (callers multiply by a base color).
    Runs in a ``textures.sample_texture`` span (spans.py).
    """
    with spans.span("textures.sample_texture"):
        return _sample_texture(table, tex_id, uv, p, uv_fp, uv_axes)


def _sample_texture(table, tex_id, uv, p, uv_fp, uv_axes):
    if p is None:
        p = torch.zeros(uv.shape[:-1] + (3,), device=uv.device)
    tid = torch.clamp(tex_id, min=0).long()
    kind = table.tex_kind[tid]
    uvs = uv * table.tex_uvscale[tid]
    axes_tid = (uv_axes * table.tex_uvscale[tid][..., None, :]
                if uv_axes is not None else None)
    out = _base_value(table, tid, kind, uvs, p, uv_fp, axes_tid)

    if table.has_children:
        # One combinator level: scale / mix evaluate their children
        # (themselves base textures) and blend.
        child = table.tex_child[tid]
        c0 = torch.clamp(child[..., 0], min=0).long()
        c1 = torch.clamp(child[..., 1], min=0).long()
        vals = []
        for c in (c0, c1):
            ax = (uv_axes * table.tex_uvscale[c][..., None, :]
                  if uv_axes is not None else None)
            vals.append(_base_value(table, c, table.tex_kind[c],
                                    uv * table.tex_uvscale[c], p, uv_fp, ax))
        p0 = table.tex_p0[tid]
        v0 = torch.where((child[..., 0] >= 0)[..., None], vals[0], p0)
        v1 = torch.where((child[..., 1] >= 0)[..., None], vals[1],
                         table.tex_p1[tid])
        amt = table.tex_par[tid][..., 0:1]
        out = torch.where((kind == KIND_SCALE)[..., None], v0 * p0, out)
        out = torch.where((kind == KIND_MIX)[..., None],
                          (1.0 - amt) * v0 + amt * v1, out)

    return torch.where((tex_id < 0)[..., None], 1.0, out)
