"""Directional-albedo lookup tables (port of
statmc_tpu/render/albedo_lut.py).

Two tiers, as in the JAX package:

1. The reference's nine precomputed family tables (FAMILY_AXES, after
   precomputealbedo/main.cpp:78-128): `precompute_family_nd` fills an
   N-D grid of normalized coordinates by Monte Carlo, `LookupTable`
   interpolates it multilinearly over its 2^N corners (lut.h:163-272).
   `python -m statmc_tpu_torch.tools.precomputealbedo` builds and checks
   them.
2. Per-material curves for the bounce-0 albedo G-buffer: the reference
   bakes every constant-texture dimension out at material construction
   (material.cpp:134-255), so each material reduces to a 1-D curve over
   cos(theta_o) (`precompute_material_curves`, `albedo_from_curves`).

Both estimate rho(wo) by Monte Carlo over the BSDF sampler with the JAX
package's threefry streams.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import math as cm
from ..core import rng
from ..scene import build as sb
from . import bsdf as B


class LookupTable(NamedTuple):
    """Flattened N-D table with per-dim sizes (lut.h:163)."""
    data: Any  # [prod(sizes)] or [prod(sizes), C] tensor
    sizes: tuple  # per-dim sample counts

    def lookup(self, coords):
        """Multilinear interpolation: coords [..., N] normalized to
        [0, 1] per dimension -> [...] or [..., C]."""
        n = len(self.sizes)
        idx0, fracs = [], []
        for d in range(n):
            x = torch.clamp(coords[..., d], 0.0, 1.0) * (self.sizes[d] - 1)
            i0 = torch.clamp(torch.floor(x).long(), 0,
                             self.sizes[d] - 2 if self.sizes[d] > 1 else 0)
            idx0.append(i0)
            fracs.append(x - i0.to(torch.float32))
        strides, s = [], 1
        for d in reversed(range(n)):
            strides.insert(0, s)
            s *= self.sizes[d]
        out = None
        for corner in range(1 << n):
            flat, w = 0, None
            for d in range(n):
                hi = (corner >> d) & 1
                step = hi if self.sizes[d] > 1 else 0
                flat = flat + (idx0[d] + step) * strides[d]
                wd = fracs[d] if hi else 1.0 - fracs[d]
                w = wd if w is None else w * wd
            val = self.data[flat]
            if val.dim() > flat.dim():
                w = w[..., None]
            out = val * w if out is None else out + val * w
        return out


def _mc_albedo(mat_lanes: B.MaterialLanes, cos_thetas, n_samples: int, key,
               chunk: int = 64, full_sphere=None):
    """rho(wo) = E[f |cos wi| / pdf] per lane, over the reflection side,
    or over the whole sphere on the lanes of the [G] bool mask
    full_sphere (hair fibres scatter through TT/TRT).

    Draw i uses fold_in(key, i) exactly as the JAX fori_loop does; the
    samples are evaluated in batches of `chunk` draws and summed in draw
    order, so the sum matches the sequential loop's rounding."""
    G = cos_thetas.shape[0]
    dev = cos_thetas.device
    st = cm.sqrt(torch.clamp(1.0 - cos_thetas ** 2, min=0.0))
    wo = torch.stack([st, torch.zeros_like(st), cos_thetas], dim=-1)
    acc = torch.zeros((G, 3), device=dev)
    for i0 in range(0, n_samples, chunk):
        n = min(chunk, n_samples - i0)
        keys = rng.fold_in(key.expand(n, 2),
                           torch.arange(i0, i0 + n, device=dev))
        u2 = rng.uniform(keys, (G, 2)).reshape(n * G, 2)
        uc = rng.uniform(rng.fold_in(keys, 1), (G,)).reshape(n * G)
        lanes = B.MaterialLanes(*[
            None if x is None else x.repeat((n,) + (1,) * (x.dim() - 1))
            for x in mat_lanes])
        smp = B.sample(lanes, wo.repeat(n, 1), u2, uc)
        w = smp.f * torch.abs(smp.wi[..., 2:3]) / torch.clamp(
            smp.pdf, min=1e-9)[..., None]
        w = torch.where(torch.isfinite(w), w, 0.0)
        keep = smp.wi[..., 2:3] > 0
        if full_sphere is not None:
            keep = keep | full_sphere.repeat(n)[:, None]
        w = torch.where(keep, w, 0.0).reshape(n, G, 3)
        for j in range(n):
            acc = acc + w[j]
    return acc / n_samples


# ---------------------------------------------------------------------------
# Full N-D family tables.  Axis 0 is cos(theta_o) in [CosEpsilon, 1] in every
# family; the spectral axes are swept achromatically (material.cpp
# LUT_SET_INDICES_SPECTRUM queries them per channel).
# ---------------------------------------------------------------------------

TROWBRIDGE_ALPHA_MIN = 0.0472695  # core/pbrt.h:233
TROWBRIDGE_ALPHA_MAX = 1.62142    # core/pbrt.h:234
_COS_EPS = 1e-4
_EPS = 1e-4

# family -> [(axis name, lo, hi[, gamma])]: texel i of n sits at
# lo + (i/(n-1))**gamma * (hi - lo).  The reference's grids are uniform; the
# JAX package warps metal's and hair's to concentrate texels where the
# albedo curves (conductor Fresnel near eta ~ 0, grazing cos_theta).
FAMILY_AXES = {
    "matte": [("cos_theta", _COS_EPS, 1.0), ("sigma", 0.0, 90.0)],
    "mirror": [("cos_theta", _COS_EPS, 1.0), ("kr", 0.0, 1.0)],
    "metal": [("cos_theta", _COS_EPS, 1.0, 2.0), ("eta", _EPS, 7.14),
              ("k", _EPS, 8.62, 2.0),
              ("rough_u", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
              ("rough_v", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX)],
    "plastic": [("cos_theta", _COS_EPS, 1.0), ("kd", 0.0, 1.0),
                ("ks", 0.0, 1.0),
                ("rough", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX)],
    "substrate": [("cos_theta", _COS_EPS, 1.0), ("kd", 0.0, 1.0),
                  ("ks", 0.0, 1.0),
                  ("rough_u", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
                  ("rough_v", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX)],
    "translucent": [("cos_theta", _COS_EPS, 1.0), ("kd", 0.0, 1.0),
                    ("ks", 0.0, 1.0),
                    ("rough", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
                    ("kr", 0.0, 1.0), ("kt", 0.0, 1.0)],
    "glass": [("cos_theta", _COS_EPS, 1.0), ("kr", 0.0, 1.0),
              ("kt", 0.0, 1.0),
              ("rough_u", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
              ("rough_v", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
              ("eta", 1.0 + _EPS, 2.42)],
    "uber": [("cos_theta", _COS_EPS, 1.0), ("kd", 0.0, 1.0),
             ("ks", 0.0, 1.0), ("kr", 0.0, 1.0), ("kt", 0.0, 1.0),
             ("rough_u", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
             ("rough_v", TROWBRIDGE_ALPHA_MIN, TROWBRIDGE_ALPHA_MAX),
             ("eta", 1.0 + _EPS, 2.42)],
    "hair": [("cos_theta", _COS_EPS, 1.0, 2.0), ("sigma_a", _EPS, 1.0, 2.0),
             ("beta_m", _EPS, 1.0), ("beta_n", _EPS, 1.0, 2.0)],
}

# The reference leaves disney, fourier, kdsubsurface and subsurface out of
# the precompute (unbounded parameter scales, main.cpp:339-344).
_FAMILY_MAT = {
    "matte": sb.MAT_MATTE, "mirror": sb.MAT_MIRROR, "metal": sb.MAT_METAL,
    "plastic": sb.MAT_PLASTIC, "substrate": sb.MAT_SUBSTRATE,
    "translucent": sb.MAT_TRANSLUCENT, "glass": sb.MAT_GLASS,
    "uber": sb.MAT_UBER, "hair": sb.MAT_HAIR,
}


def _family_mat_type(family: str) -> int:
    return _FAMILY_MAT[family]


def default_sizes(family: str) -> tuple:
    """8 texels an axis (main.cpp:48 LutWidth); uber 4 (the reference
    downloads its 8^8 table), metal (16, 16, 8, 8, 8): the conductor
    Fresnel pivots around (eta ~ 1, k ~ 0) and at grazing cos_theta."""
    if family == "metal":
        return (16, 16, 8, 8, 8)
    return (4 if family == "uber" else 8,) * len(FAMILY_AXES[family])


def grid_coords(sizes) -> np.ndarray:
    """The table's texel coordinates [prod(sizes), N] float32, in the
    table's flat order (meshgrid "ij")."""
    grids = [np.linspace(0.0, 1.0, s) if s > 1 else np.array([0.0])
             for s in sizes]
    mesh = np.meshgrid(*grids, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], -1).astype(np.float32)


def _lanes_from_coords(family: str, coords):
    """Normalized [G, N] coords -> (MaterialLanes [G], cos_theta [G]), the
    reference's grid-point materials (main.cpp:404-480).  Lanes are built
    by field name.  Hair takes the repurposed slots of scene/build.py
    MAT_HAIR: sigma_a rides kt, beta_m sigma, beta_n rough_u, alpha (2
    degrees) rough_v; eta 1.55, h = 0."""
    G, dev = coords.shape[0], coords.device
    vals = {}
    for i, ax in enumerate(FAMILY_AXES[family]):
        name, lo, hi = ax[0], ax[1], ax[2]
        gamma = ax[3] if len(ax) > 3 else 1.0
        u = coords[..., i] ** gamma if gamma != 1.0 else coords[..., i]
        vals[name] = lo + u * (hi - lo)

    def spec(name, default):
        if name in vals:
            return vals[name][..., None].expand(G, 3)
        return torch.full((G, 3), default, device=dev)

    def scal(name, default):
        if name in vals:
            return vals[name]
        return torch.full((G,), default, device=dev)

    if "rough" in vals:
        rough_u = rough_v = vals["rough"]
    else:
        rough_u = scal("rough_u", 0.0)
        rough_v = vals.get("rough_v", rough_u)
    hair_h = None
    sigma = scal("sigma", 0.0)
    eta = spec("eta", 1.5)
    kt = spec("kt", 0.0)
    if family == "hair":
        hair_h = torch.zeros((G,), device=dev)
        kt = spec("sigma_a", 0.0)
        sigma = scal("beta_m", 0.3)
        rough_u = scal("beta_n", 0.3)
        rough_v = torch.full((G,), 2.0, device=dev)
        eta = torch.full((G, 3), 1.55, device=dev)
    lanes = B.MaterialLanes(
        mat_type=torch.full((G,), _family_mat_type(family), dtype=torch.int32,
                            device=dev),
        kd=spec("kd", 1.0 if family == "matte" else 0.0),
        ks=spec("ks", 0.0), kr=spec("kr", 0.0), kt=kt, eta=eta,
        k=spec("k", 0.0), rough_u=rough_u, rough_v=rough_v, sigma=sigma,
        hair_h=hair_h)
    return lanes, vals["cos_theta"]


# Lanes of one bsdf.sample call in mc_albedo_at: 64 draws of a chunk of
# 32,768 texels, more draws at a time for fewer texels.
LANES = 1 << 21


def mc_albedo_at(family: str, coords, n_samples: int = 1024, seed: int = 0):
    """Fresh MC albedo at normalized coords [G, N] -> [G], on their
    device; hair over the whole sphere.  The draws go LANES lanes at a
    time, summed in draw order, so the result does not depend on it."""
    lanes, cos = _lanes_from_coords(family, coords)
    sphere = (torch.ones_like(cos, dtype=torch.bool) if family == "hair"
              else None)
    chunk = max(1, min(n_samples, LANES // max(cos.shape[0], 1)))
    out = _mc_albedo(lanes, cos, n_samples,
                     rng.base_key(seed, device=coords.device), chunk=chunk,
                     full_sphere=sphere)
    return out[..., 0]


def precompute_family_nd(family: str, sizes=None, n_samples: int = 1024,
                         seed: int = 0, chunk: int = 1 << 15,
                         device="cuda") -> LookupTable:
    """The N-D albedo table of one family on `device`, `chunk` texels at
    a time (default_sizes unless `sizes` is given)."""
    sizes = tuple(sizes) if sizes else default_sizes(family)
    if len(sizes) != len(FAMILY_AXES[family]):
        raise ValueError(f"{family}: {len(FAMILY_AXES[family])} axes, "
                         f"sizes {sizes}")
    coords = torch.as_tensor(grid_coords(sizes), device=device)
    out = torch.cat([mc_albedo_at(family, coords[s0:s0 + chunk], n_samples,
                                  seed)
                     for s0 in range(0, coords.shape[0], chunk)])
    return LookupTable(data=out, sizes=sizes)


def precompute_family(family: str, sizes=(16, 16), n_samples: int = 1024,
                      seed: int = 0, eta=None, k=None, device="cuda"
                      ) -> LookupTable:
    """The legacy (cos_theta, param2) table at unit Kd/Ks: param2 is sigma
    in [0, 90] degrees for matte, alpha in [0.01, 1] for metal, substrate
    and plastic; cos_theta at texel centres."""
    n_cos, n_p2 = sizes
    cos = (np.arange(n_cos) + 0.5) / n_cos
    if family == "matte":
        p2 = np.linspace(0.0, 90.0, n_p2)
    elif family in ("metal", "substrate", "plastic"):
        p2 = np.linspace(0.01, 1.0, n_p2)
    else:
        raise ValueError(f"unknown albedo family {family!r}")
    cc, pp = np.meshgrid(cos, p2, indexing="ij")
    G = cc.size

    def full3(v, default):
        v = default if v is None else v
        return torch.as_tensor(v, dtype=torch.float32,
                               device=device).expand(G, 3).contiguous()

    ones = torch.ones((G, 3), device=device)
    zeros = torch.zeros((G, 3), device=device)
    p2 = torch.as_tensor(pp.reshape(-1), dtype=torch.float32, device=device)
    zero = torch.zeros((G,), device=device)
    matte = family == "matte"
    lanes = B.MaterialLanes(
        mat_type=torch.full((G,), _family_mat_type(family), dtype=torch.int32,
                            device=device),
        kd=ones, ks=zeros if matte else ones, kr=zeros, kt=zeros,
        eta=full3(eta, 1.5), k=full3(k, 0.0),
        rough_u=zero if matte else p2, rough_v=zero if matte else p2,
        sigma=p2 if matte else zero)
    vals = _mc_albedo(
        lanes, torch.as_tensor(cc.reshape(-1), dtype=torch.float32,
                               device=device),
        n_samples, rng.base_key(seed, device=device))[..., 0]
    return LookupTable(data=vals, sizes=(n_cos, n_p2))


def precompute_material_curves(scene: sb.SceneTables, n_cos: int = 16,
                               n_samples: int = 512, seed: int = 3):
    """(lut_d [M, n_cos, 3], lut_rest [M, n_cos, 3]) on the scene's
    device: albedo(cos) ~= kd * lut_d[mat](cos) + lut_rest[mat](cos)."""
    dev = scene.mat_type.device
    M = int(scene.mat_type.shape[0])
    cos = torch.as_tensor((np.arange(n_cos) + 0.5) / n_cos,
                          dtype=torch.float32, device=dev)
    G = M * n_cos

    def tile(x):
        return torch.repeat_interleave(x, n_cos, dim=0)

    ones3 = torch.ones((G, 3), device=dev)
    zeros3 = torch.zeros((G, 3), device=dev)
    # Hair rows take the Marschner model at h = 0 (sigma_a rides the kt
    # slot) over the whole sphere, the analogue of the reference's hair
    # albedo LUT (materials/hair.cpp:171); hairless scenes run none of it.
    has_hair = bool(torch.any(scene.mat_type == sb.MAT_HAIR))
    base = B.MaterialLanes(
        mat_type=tile(scene.mat_type), kd=ones3, ks=zeros3, kr=zeros3,
        kt=zeros3, eta=tile(scene.mat_eta), k=tile(scene.mat_k),
        rough_u=tile(scene.mat_rough_u), rough_v=tile(scene.mat_rough_v),
        sigma=tile(scene.mat_sigma),
        hair_h=torch.zeros((G,), device=dev) if has_hair else None)
    rest = base._replace(kd=zeros3, ks=tile(scene.mat_ks),
                         kr=tile(scene.mat_kr), kt=tile(scene.mat_kt))
    cc = cos.repeat(M)
    key = rng.base_key(seed, device=dev)
    sphere = (base.mat_type == sb.MAT_HAIR) if has_hair else None
    lut_d = _mc_albedo(base, cc, n_samples, key,
                       full_sphere=sphere).reshape(M, n_cos, 3)
    lut_rest = _mc_albedo(rest, cc, n_samples, rng.fold_in(key, 1),
                          full_sphere=sphere).reshape(M, n_cos, 3)
    # Only Kd-proportional families keep the kd * lut_d decomposition
    # (hair's full-sphere albedo lives in lut_rest).
    t = scene.mat_type
    kd_linear = ((t == sb.MAT_MATTE) | (t == sb.MAT_PLASTIC)
                 | (t == sb.MAT_UBER) | (t == sb.MAT_SUBSTRATE)
                 | (t == sb.MAT_TRANSLUCENT) | (t == sb.MAT_DISNEY))
    lut_d = torch.where(kd_linear[:, None, None], lut_d, 0.0)
    return lut_d, lut_rest


def albedo_from_curves(lut_d, lut_rest, mat_id, kd, cos_o):
    """Query the reduced curves per lane: [R,3] albedo."""
    n_cos = lut_d.shape[1]
    x = torch.clamp(torch.abs(cos_o), 0.0, 1.0) * n_cos - 0.5
    i0 = torch.clamp(torch.floor(x).to(torch.int32), 0, n_cos - 2)
    f = torch.clamp(x - i0.to(torch.float32), 0.0, 1.0)[..., None]
    m, i0 = mat_id.long(), i0.long()
    d = lut_d[m, i0] * (1 - f) + lut_d[m, i0 + 1] * f
    rr = lut_rest[m, i0] * (1 - f) + lut_rest[m, i0 + 1] * f
    return torch.clamp(kd * d + rr, 0.0, 1.0)
