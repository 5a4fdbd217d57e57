"""Light sampling distributions (port of statmc_tpu/render/lightdistrib.py).

uniform / power are host numpy.  spatial runs the reference's voxel
importance estimate (SpatialLightDistribution::ComputeDistribution,
lightdistrib.cpp:235-295): per voxel, 128 Halton-placed points sample
every light through ``lights.sample_li`` (on tensors) and accumulate
luminance(Li)/pdf; the dense [V, L] table is precomputed and voxel
lookups become a gather.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import math as cm
from ..scene import build as sb

SPATIAL_MAX_VOXELS = 16
SPATIAL_N_SAMPLES = 128  # per-voxel estimation points (lightdistrib.cpp:255)
SPATIAL_MAX_LIGHTS = 2048


class LightDistribution(NamedTuple):
    cdf: Any  # [V, L] per-voxel (V=1 for uniform/power)
    pmf: Any  # [V, L]
    grid_res: Any  # (nx, ny, nz) or None
    world_lo: Any  # [3]
    world_inv_extent: Any  # [3]

    def to(self, device) -> "LightDistribution":
        return self._replace(cdf=self.cdf.to(device), pmf=self.pmf.to(device),
                             world_lo=self.world_lo.to(device),
                             world_inv_extent=self.world_inv_extent.to(device))


def _light_power(scene_np: sb.SceneTables) -> np.ndarray:
    kind = np.asarray(scene_np.light_kind)
    L = np.asarray(scene_np.light_L)
    area = np.asarray(scene_np.light_area)
    wr = float(scene_np.world_radius)
    lum = L @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    power = np.zeros(kind.shape[0], np.float32)
    for k in (sb.LIGHT_AREA_TRI, sb.LIGHT_AREA_SPH):
        power[kind == k] = lum[kind == k] * area[kind == k] * np.pi
    power[kind == sb.LIGHT_POINT] = 4.0 * np.pi * lum[kind == sb.LIGHT_POINT]
    # Image-modulated point lights: 4pi I is the upper bound pbrt also
    # uses before image averaging (goniometric.cpp:Power ~ average).
    power[kind == sb.LIGHT_GONIO] = 4.0 * np.pi * lum[kind == sb.LIGHT_GONIO]
    power[kind == sb.LIGHT_PROJ] = 2.0 * np.pi * lum[kind == sb.LIGHT_PROJ]
    power[kind == sb.LIGHT_SPOT] = 2.0 * np.pi * lum[kind == sb.LIGHT_SPOT]
    # An environment-mapped infinite light's L is 1 (scene/build.py folds
    # L * scale into the map), so its row is pi r^2 like a constant one's.
    for k in (sb.LIGHT_DISTANT, sb.LIGHT_INFINITE):
        power[kind == k] = np.pi * wr * wr * lum[kind == k]
    return power


def _radical_inverse(base: int, n: int) -> np.ndarray:
    """RadicalInverse(base, i) for i in [0, n) (core/lowdiscrepancy.h)."""
    out = np.zeros(n, np.float64)
    i = np.arange(n, dtype=np.int64)
    inv_base = 1.0 / base
    f = inv_base
    while i.max(initial=0) > 0:
        out += (i % base) * f
        i //= base
        f *= inv_base
    return out.astype(np.float32)


def _dist(pmf: np.ndarray, grid_res=None, lo=None, inv_ext=None
          ) -> LightDistribution:
    pmf = pmf[None] if pmf.ndim == 1 else pmf
    cdf = np.cumsum(pmf, axis=-1).astype(np.float32)
    cdf[..., -1] = 1.0
    return LightDistribution(
        cdf=torch.as_tensor(cdf),
        pmf=torch.as_tensor(pmf.astype(np.float32)),
        grid_res=grid_res,
        world_lo=torch.as_tensor(lo if lo is not None
                                 else np.zeros(3, np.float32)),
        world_inv_extent=torch.as_tensor(inv_ext if inv_ext is not None
                                         else np.ones(3, np.float32)),
    )


def make_distribution(scene_np: sb.SceneTables, strategy: str = "power",
                      device="cpu") -> LightDistribution:
    """Build the distribution from host tables; the spatial voxel pass
    runs on `device`.  The result's tensors live on `device`."""
    nl = int(np.asarray(scene_np.light_kind).shape[0])
    if nl == 0:
        return _dist(np.ones((1,), np.float32)).to(device)
    if strategy == "uniform":
        return _dist(np.full(nl, 1.0 / nl, np.float32)).to(device)

    p = _light_power(scene_np)
    tot = p.sum()
    power_pmf = (p / tot if tot > 0 else np.full(nl, 1.0 / nl)
                 ).astype(np.float32)
    if strategy != "spatial" or nl > SPATIAL_MAX_LIGHTS:
        return _dist(power_pmf).to(device)

    pts = []
    if np.asarray(scene_np.tri_p0).shape[0]:
        p0 = np.asarray(scene_np.tri_p0)
        pts += [p0, p0 + np.asarray(scene_np.tri_e1),
                p0 + np.asarray(scene_np.tri_e2)]
    if np.asarray(scene_np.sph_center).shape[0]:
        c = np.asarray(scene_np.sph_center)
        rr = np.asarray(scene_np.sph_radius)[:, None]
        pts += [c - rr, c + rr]
    if not pts:
        return _dist(power_pmf).to(device)
    allp = np.concatenate(pts, 0)
    lo = allp.min(0).astype(np.float32)
    hi = allp.max(0).astype(np.float32)
    diag = np.maximum(hi - lo, 1e-6)
    bmax = float(diag.max())
    nv = np.maximum(1, np.round(diag / bmax * SPATIAL_MAX_VOXELS).astype(int))
    V = int(nv[0] * nv[1] * nv[2])

    S = SPATIAL_N_SAMPLES
    u3 = np.stack([_radical_inverse(2, S), _radical_inverse(3, S),
                   _radical_inverse(5, S)], -1)
    u2 = np.stack([_radical_inverse(7, S), _radical_inverse(11, S)], -1)
    ix, iy, iz = np.meshgrid(np.arange(nv[0]), np.arange(nv[1]),
                             np.arange(nv[2]), indexing="ij")
    corner01 = np.stack([ix, iy, iz], -1).reshape(-1, 3) / nv
    po = (corner01[:, None, :] + u3[None, :, :] / nv) * diag + lo  # [V,S,3]

    from . import lights as LT

    scene = scene_np.to_device(device)
    y_w = torch.tensor([0.212671, 0.715160, 0.072169], device=device)
    u2_t = torch.as_tensor(u2, device=device)
    lid_all = torch.arange(nl, dtype=torch.int32, device=device)

    def chunk_contrib(po_c):
        """po_c: [Vc, S, 3] -> [Vc, L] summed luminance(Li)/pdf."""
        Vc = po_c.shape[0]
        p_flat = po_c[:, :, None, :].expand(Vc, S, nl, 3).reshape(-1, 3)
        lid = lid_all[None, None].expand(Vc, S, nl).reshape(-1)
        uu = u2_t[None, :, None, :].expand(Vc, S, nl, 2).reshape(-1, 2)
        ls = LT.sample_li(scene, lid, p_flat, torch.zeros_like(p_flat), uu)
        y = ls.li @ y_w
        c = torch.where(ls.pdf > 0, y / torch.clamp(ls.pdf, min=1e-30), 0.0)
        return torch.sum(c.reshape(Vc, S, nl), dim=1)

    CH = max(1, (1 << 20) // max(S * nl, 1))
    contrib = np.zeros((V, nl), np.float32)
    po_t = torch.as_tensor(po.astype(np.float32), device=device)
    for v0 in range(0, V, CH):
        v1 = min(v0 + CH, V)
        contrib[v0:v1] = chunk_contrib(po_t[v0:v1]).cpu().numpy()

    # Minimum-weight floor (lightdistrib.cpp:283-292).
    avg = contrib.sum(-1, keepdims=True) / (S * nl)
    min_c = np.where(avg > 0, 1e-3 * avg, 1.0)
    contrib = np.maximum(contrib, min_c)
    pmf = contrib / contrib.sum(-1, keepdims=True)
    return _dist(pmf, tuple(int(x) for x in nv), lo,
                 (1.0 / diag).astype(np.float32)).to(device)


def sample_light_id(dist: LightDistribution, u, p=None):
    """Draw a light id per lane: (id [R] int32, pmf [R])."""
    if dist.grid_res is None or p is None:
        cdf = dist.cdf[0]
        idx = torch.searchsorted(cdf, u.contiguous(), right=True)
        idx = torch.clamp(idx, max=cdf.shape[0] - 1)
        return idx.to(torch.int32), dist.pmf[0][idx]
    nx, ny, nz = dist.grid_res
    res = cm.const((float(nx), float(ny), float(nz)), p.device)
    cap = cm.const((nx - 1, ny - 1, nz - 1), p.device, torch.int32)
    g = ((p - dist.world_lo) * dist.world_inv_extent * res).to(torch.int32)
    g = torch.minimum(torch.clamp(g, min=0), cap).long()
    v = (g[..., 0] * ny + g[..., 1]) * nz + g[..., 2]
    cdf_rows = dist.cdf[v]  # [R, L]
    idx = torch.searchsorted(cdf_rows, u[:, None].contiguous(), right=True)
    idx = torch.clamp(idx, max=dist.cdf.shape[1] - 1)
    pmf = torch.gather(dist.pmf[v], 1, idx)[:, 0]
    return idx[:, 0].to(torch.int32), pmf
