# Copied from statmc_tpu/scene/build.py (numpy side: build_scene,
# SceneTables, _material_row, the BSSRDF, media and Fourier table
# stacking); to_device returns torch tensors.
"""SceneDescription -> SoA scene tables (host numpy, then tensors).

Copied from the JAX package with its behaviour unchanged: the
participating media tables (MakeMedium, api.cpp:693-738), each shape's
MediumInterface, the camera's medium and the FourierBSDF tables are
built here as there.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Any, NamedTuple

import numpy as np
import torch

log = logging.getLogger("statmc_tpu_torch.scene")


class MissingAssetError(FileNotFoundError):
    """A scene references geometry/texture files that do not exist."""

from ..core import math as cm
from .api import MaterialDesc, SceneDescription, ShapeDesc
from .params import ParamSet
from .ply import read_ply

# Material type enum (scene tables + BSDF dispatch).
MAT_NONE = 0
MAT_MATTE = 1
MAT_PLASTIC = 2
MAT_METAL = 3
MAT_GLASS = 4
MAT_MIRROR = 5
MAT_SUBSTRATE = 6
MAT_UBER = 7
MAT_TRANSLUCENT = 8
MAT_DISNEY = 9
MAT_HAIR = 10
MAT_FOURIER = 11
MAT_KDSUBSURFACE = 12
MAT_SUBSURFACE = 13

_MAT_ENUM = {
    "none": MAT_NONE,
    "": MAT_NONE,
    "matte": MAT_MATTE,
    "plastic": MAT_PLASTIC,
    "metal": MAT_METAL,
    "glass": MAT_GLASS,
    "mirror": MAT_MIRROR,
    "substrate": MAT_SUBSTRATE,
    "uber": MAT_UBER,
    "translucent": MAT_TRANSLUCENT,
    "disney": MAT_DISNEY,
    "hair": MAT_HAIR,
    "fourier": MAT_FOURIER,
    "kdsubsurface": MAT_KDSUBSURFACE,
    "subsurface": MAT_SUBSURFACE,
    # "mix" is folded at build time (parameter-space lerp of the two
    # named children, materials/mixmat.cpp approximated; exact when the
    # children share a family).
}

# Light kind enum.
LIGHT_AREA_TRI = 0  # diffuse area light over a triangle range
LIGHT_AREA_SPH = 1  # diffuse area light on a sphere
LIGHT_POINT = 2
LIGHT_DISTANT = 3
LIGHT_INFINITE = 4
LIGHT_SPOT = 5
LIGHT_GONIO = 6  # goniophotometric: point light x directional image
LIGHT_PROJ = 7  # projection: point light x projected image

# pbrt's default metal: copper (materials/metal.cpp defaults).
_COPPER_ETA = np.array([0.2004376970, 0.9240539266, 1.1022119522], np.float32)
_COPPER_K = np.array([3.9129485033, 2.4528477015, 2.1421879552], np.float32)


class SceneTables(NamedTuple):
    """Host-side numpy tables; `to_device` lifts them to tensors."""
    # Triangles
    tri_p0: Any
    tri_e1: Any
    tri_e2: Any
    tri_n0: Any
    tri_n1: Any
    tri_n2: Any
    tri_uv0: Any
    tri_uv1: Any
    tri_uv2: Any
    tri_mat: Any
    tri_light: Any  # area-light id or -1
    tri_has_normals: Any  # bool per tri
    # Spheres
    sph_center: Any
    sph_radius: Any
    sph_mat: Any
    sph_light: Any
    sph_flip: Any  # [S] +1/-1 (ReverseOrientation, core/shape.cpp:49)
    # Materials
    mat_type: Any
    mat_kd: Any
    mat_ks: Any
    mat_kr: Any
    mat_kt: Any
    mat_eta: Any
    mat_k: Any
    mat_rough_u: Any
    mat_rough_v: Any
    mat_sigma: Any
    mat_kd_tex: Any  # [M] texture id for Kd or -1
    textures: Any  # TextureTable
    # Lights
    light_kind: Any  # [L]
    light_L: Any  # [L,3]
    light_prim: Any  # [L] sphere id (AREA_SPH) or triangle id (AREA_TRI)
    light_prim_count: Any  # [L]
    light_pos: Any  # [L,3] point/spot position or distant direction
    light_aux: Any  # [L,3] spot direction
    light_params: Any  # [L,2] spot cos angles
    light_area: Any  # [L] surface area (area lights)
    light_w2l: Any  # [L,9] world-to-light rotation (gonio/projection)
    light_tex: Any  # [L] modulation texture id or -1 (gonio/projection)
    # Environment map (first infinite light with an image; 1x1 else)
    env_map: Any  # [He,We,3] radiance texels (already scaled by L*scale)
    env_marginal_cdf: Any  # [He] row-marginal CDF over luminance*sin(theta)
    env_cond_cdf: Any  # [He,We] per-row conditional CDF
    env_pdf_uv: Any  # [He,We] pdf over (u,v) in [0,1]^2
    env_world_to_light: Any  # [4,4]
    env_light_id: int  # light id using the map, or -1
    # World bound
    world_center: Any
    world_radius: Any
    # BSSRDF tables (render/sss.py SSSTables; None when the scene has no
    # subsurface materials) and each material's table index or -1.
    sss: Any = None
    mat_sss_id: Any = None  # [M]
    # Participating media (volpath; render/volume.py; src/core/medium.h,
    # src/media/homogeneous.cpp:44-77, src/media/grid.cpp:47-115).
    # med_grid packs every grid medium's density into one zero-padded
    # [M, Dz, Dy, Dx] block (homogeneous rows hold 1 voxel of 1.0);
    # med_w2m maps world points into the [0,1]^3 density space (inverse
    # of CTM * Translate(p0) * Scale(p1-p0)).
    med_sigma_a: Any = None  # [M,3]
    med_sigma_s: Any = None  # [M,3]
    med_g: Any = None  # [M] Henyey-Greenstein asymmetry
    med_kind: Any = None  # [M] 0 = homogeneous, 1 = grid
    med_w2m: Any = None  # [M,4,4] world -> density space
    med_grid: Any = None  # [M,Dz,Dy,Dx]
    med_nxyz: Any = None  # [M,3] each grid's true (nx, ny, nz)
    med_inv_maxd: Any = None  # [M] 1 / max(density) (grid tracking)
    med_sigt0: Any = None  # [M] scalar sigma_t (grid; channel 0)
    tri_med_in: Any = None  # [T] medium id inside (-1 vacuum)
    tri_med_out: Any = None  # [T]
    sph_med_in: Any = None  # [S]
    sph_med_out: Any = None  # [S]
    cam_medium: int = -1  # medium id camera rays start in
    # FourierBSDF tables (render/fourier.py FourierTables; None when the
    # scene has no readable .bsdf file) and each material's table or -1.
    fourier: Any = None
    mat_fourier_id: Any = None  # [M]
    # Host flags (statmc_tpu/scene/build.py SceneFlags): they gate the
    # texture lookups, the image-light block, the hair model with its
    # tangent and the BSSRDF transport.
    has_textures: bool = False  # any material with a Kd texture row
    has_image_lights: bool = False  # any goniometric/projection light
    has_hair: bool = False  # any Material "hair" row
    has_sss: bool = False  # any subsurface table (sss is not None)

    @property
    def has_media(self) -> bool:
        return self.med_kind is not None and self.med_kind.shape[0] > 0

    @property
    def has_grid_media(self) -> bool:
        return self.has_media and bool((self.med_kind == 1).any())

    def to_device(self, device="cpu") -> "SceneTables":
        """numpy -> tensors on `device` (f32 floats, int32 ids, bool
        flags); world_radius becomes a Python float, env_light_id an
        int, and the texture table's arrays tensors."""
        def conv(x):
            if isinstance(x, np.ndarray):
                return torch.tensor(x, device=device)
            return x

        return SceneTables(*[conv(x) for x in self])._replace(
            world_radius=float(self.world_radius),
            env_light_id=int(self.env_light_id),
            cam_medium=int(self.cam_medium),
            textures=self.textures.to_device(device),
            sss=None if self.sss is None else self.sss.to_device(device),
            fourier=(None if self.fourier is None
                     else self.fourier.to_device(device)))


def scene_has_hair(scene) -> bool:
    """Does any material row use the Marschner hair model
    (render/hair.py)?  Gates the dpdu tangent and the hair lobes, so a
    hairless scene runs neither."""
    return bool(scene.has_hair)


def _material_row(md: MaterialDesc | None, textures) -> dict:
    """Extract one material's parameter slots (constant textures resolved).

    Texture-valued parameters fall back to a mid-gray constant when the
    image file is unavailable (scene assets are downloaded separately in
    the reference too: scripts/_download-scenes.sh).
    """
    row = dict(
        mat_type=MAT_MATTE,
        kd=np.array([0.5, 0.5, 0.5], np.float32),
        ks=np.array([0.0, 0.0, 0.0], np.float32),
        kr=np.array([0.0, 0.0, 0.0], np.float32),
        kt=np.array([0.0, 0.0, 0.0], np.float32),
        eta=np.array([1.5, 1.5, 1.5], np.float32),
        k=np.zeros(3, np.float32),
        rough_u=0.0,
        rough_v=0.0,
        sigma=0.0,
        kd_tex_name=None,
        fourier_file=None,
    )
    if md is None:
        row["mat_type"] = MAT_NONE
        return row
    mtype = _MAT_ENUM.get(md.mat_type, MAT_MATTE)
    row["mat_type"] = mtype
    p = md.params

    def spectrum(name, default):
        v = p.find_spectrum(name)
        if v is not None:
            return np.asarray(v, np.float32)
        if p.type_of(name) == "texture":
            tex = textures.get(p.find_one(name))
            if tex is not None and tex.tex_class == "constant":
                tv = tex.params.find_spectrum("value")
                if tv is not None:
                    return np.asarray(tv, np.float32)
            if name == "Kd":
                row["kd_tex_name"] = p.find_one(name)
                return np.array([1.0, 1.0, 1.0], np.float32)
            return np.array([0.5, 0.5, 0.5], np.float32)
        return np.asarray(default, np.float32)

    def scalar(name, default):
        v = p.find_one(name)
        if isinstance(v, (int, float)):
            return float(v)
        return float(default)

    if mtype == MAT_MATTE:
        row["kd"] = spectrum("Kd", [0.5, 0.5, 0.5])
        row["sigma"] = scalar("sigma", 0.0)
    elif mtype == MAT_PLASTIC:
        row["kd"] = spectrum("Kd", [0.25, 0.25, 0.25])
        row["ks"] = spectrum("Ks", [0.25, 0.25, 0.25])
        rough = scalar("roughness", 0.1)
        row["rough_u"] = row["rough_v"] = rough
        if p.find_one("remaproughness", True):
            row["rough_u"] = row["rough_v"] = _remap_roughness(rough)
    elif mtype == MAT_METAL:
        row["eta"] = spectrum("eta", _COPPER_ETA)
        row["k"] = spectrum("k", _COPPER_K)
        rough = scalar("roughness", 0.01)
        ru = scalar("uroughness", rough)
        rv = scalar("vroughness", rough)
        if p.find_one("remaproughness", True):
            ru, rv = _remap_roughness(ru), _remap_roughness(rv)
        row["rough_u"], row["rough_v"] = ru, rv
    elif mtype == MAT_GLASS:
        row["kr"] = spectrum("Kr", [1.0, 1.0, 1.0])
        row["kt"] = spectrum("Kt", [1.0, 1.0, 1.0])
        ior = scalar("index", scalar("eta", 1.5))
        row["eta"] = np.full(3, ior, np.float32)
        ru = scalar("uroughness", scalar("roughness", 0.0))
        rv = scalar("vroughness", scalar("roughness", 0.0))
        if p.find_one("remaproughness", True) and (ru > 0 or rv > 0):
            ru, rv = _remap_roughness(ru), _remap_roughness(rv)
        row["rough_u"], row["rough_v"] = ru, rv
    elif mtype == MAT_MIRROR:
        row["kr"] = spectrum("Kr", [0.9, 0.9, 0.9])
    elif mtype == MAT_SUBSTRATE:
        row["kd"] = spectrum("Kd", [0.5, 0.5, 0.5])
        row["ks"] = spectrum("Ks", [0.5, 0.5, 0.5])
        ru = scalar("uroughness", 0.1)
        rv = scalar("vroughness", 0.1)
        if p.find_one("remaproughness", True):
            ru, rv = _remap_roughness(ru), _remap_roughness(rv)
        row["rough_u"], row["rough_v"] = ru, rv
    elif mtype in (MAT_UBER, MAT_TRANSLUCENT, MAT_DISNEY):
        row["kd"] = spectrum("Kd", [0.25, 0.25, 0.25])
        row["ks"] = spectrum("Ks", [0.25, 0.25, 0.25])
        row["kr"] = spectrum("Kr", [0.0, 0.0, 0.0])
        row["kt"] = spectrum("Kt", [0.0, 0.0, 0.0])
        rough = scalar("roughness", 0.1)
        row["rough_u"] = row["rough_v"] = (
            _remap_roughness(rough) if p.find_one("remaproughness", True) else rough
        )
        if mtype == MAT_DISNEY:
            row["kd"] = spectrum("color", [0.5, 0.5, 0.5])
            # Disney metallic rides the (otherwise unused) sigma slot.
            row["sigma"] = scalar("metallic", 0.0)
            rough = scalar("roughness", 0.5)
            # Disney roughness is perceptual: alpha = roughness^2.
            row["rough_u"] = row["rough_v"] = max(rough * rough, 1e-3)
    elif mtype == MAT_HAIR:
        # materials/hair.cpp:160-230 parameter priority: sigma_a >
        # color (SigmaAFromReflectance) > eumelanin/pheomelanin
        # concentrations.  The full Marschner model (render/hair.py)
        # reads its parameters from repurposed material slots: kt =
        # sigma_a, sigma = beta_m, rough_u = beta_n, rough_v = alpha
        # (degrees); kd keeps an approximate reflectance for the
        # G-buffer albedo feature.
        from ..render import hair as hair_mod

        bm = scalar("beta_m", 0.3)
        bn = scalar("beta_n", 0.3)
        sig = p.find_spectrum("sigma_a")
        col = p.find_spectrum("color")
        if sig is None:
            if col is not None:
                sig = np.asarray(hair_mod.sigma_a_from_reflectance(
                    np.asarray(col, np.float32), bn), np.float32)
            else:
                eum = scalar("eumelanin", 1.3)
                pheo = scalar("pheomelanin", 0.0)
                sig = np.asarray(hair_mod.sigma_a_from_concentration(
                    eum, pheo), np.float32)
        sig = np.asarray(sig, np.float32).reshape(3)
        if col is None:
            col = np.exp(-sig * 1.5)
        row["kd"] = np.asarray(col, np.float32)
        row["kt"] = sig
        row["eta"] = np.full(3, scalar("eta", 1.55), np.float32)
        row["sigma"] = float(np.clip(bm, 1e-3, 1.0))
        row["rough_u"] = float(np.clip(bn, 1e-3, 1.0))
        row["rough_v"] = scalar("alpha", 2.0)
    elif mtype == MAT_FOURIER:
        # The .bsdf table (materials/fourier.cpp:244 FindFilename) is
        # read in build_scene into stacked device tables
        # (render/fourier.py); the substrate-like lobe pair below stays
        # as (a) the sampling proposal for fourier lanes and (b) the
        # eval fallback when the file is missing/unreadable.
        row["fourier_file"] = p.find_one("bsdffile")
        row["kd"] = np.array([0.5, 0.5, 0.5], np.float32)
        row["ks"] = np.array([0.3, 0.3, 0.3], np.float32)
        row["rough_u"] = row["rough_v"] = 0.05
    elif mtype == MAT_KDSUBSURFACE:
        # kdsubsurface: the surface BSDF is the Kr/Kt dielectric
        # interface (FresnelSpecular when smooth,
        # materials/kdsubsurface.cpp:70-74); (sigma_a, sigma_s) derive
        # from Kd + mfp via SubsurfaceFromDiffuse at table-stack time
        # (build_scene), feeding the device Sample_Sp transport
        # (render/sss.py).
        row["kd"] = spectrum("Kd", [0.5, 0.5, 0.5])
        row["kr"] = spectrum("Kr", [1.0, 1.0, 1.0])
        row["kt"] = spectrum("Kt", [1.0, 1.0, 1.0])
        eta = scalar("eta", 1.33)
        row["eta"] = np.full(3, eta, np.float32)
        rough = scalar("uroughness", scalar("vroughness", 0.0))
        # Rough interfaces keep the smooth FresnelSpecular lobe pair (a
        # documented simplification: pbrt swaps in microfacet versions,
        # kdsubsurface.cpp:76-100; roughness 0 is the default and every
        # bundled scene's setting).
        row["rough_u"] = row["rough_v"] = rough
        row["sss"] = dict(
            kind="kd", kd=row["kd"],
            mfp=spectrum("mfp", [1.0, 1.0, 1.0]) * scalar("scale", 1.0),
            g=scalar("g", 0.0), eta=eta)
    elif mtype == MAT_SUBSURFACE:
        # subsurface: scaled (sigma_a, sigma_s) drive the beam-diffusion
        # profile directly (materials/subsurface.cpp:104-108); Kd keeps
        # the single-scattering albedo as the G-buffer feature value.
        sc = scalar("scale", 1.0)
        ss = spectrum("sigma_s", [2.55, 3.21, 3.77]) * sc
        sa = spectrum("sigma_a", [0.0011, 0.0024, 0.014]) * sc
        row["kd"] = (ss / np.maximum(ss + sa, 1e-6)).astype(np.float32)
        row["kr"] = spectrum("Kr", [1.0, 1.0, 1.0])
        row["kt"] = spectrum("Kt", [1.0, 1.0, 1.0])
        eta = scalar("eta", 1.33)
        row["eta"] = np.full(3, eta, np.float32)
        rough = scalar("uroughness", scalar("vroughness", 0.0))
        row["rough_u"] = row["rough_v"] = rough
        row["sss"] = dict(kind="direct", sigma_a=sa, sigma_s=ss,
                          g=scalar("g", 0.0), eta=eta)
    return row


def _mix_rows(r1: dict, r2: dict, amount: np.ndarray) -> dict:
    """Fold a mix material: parameter-space lerp of the children
    (materials/mixmat.cpp scales child BxDFs by amt / (1-amt); a lerp of
    parameter rows is exact for same-family children and a documented
    approximation across families -- the dominant child's type wins)."""
    a = float(np.mean(amount))
    dom = r1 if a >= 0.5 else r2
    out = dict(dom)
    w1, w2 = a, 1.0 - a
    for key in ("kd", "ks", "kr", "kt", "eta", "k"):
        out[key] = (w1 * np.asarray(r1[key], np.float32)
                    + w2 * np.asarray(r2[key], np.float32))
    for key in ("rough_u", "rough_v", "sigma"):
        out[key] = w1 * float(r1[key]) + w2 * float(r2[key])
    # A textured Kd must survive the fold (the scalar lerp above only
    # blends the constant fallback colors): prefer the dominant child's
    # texture, else inherit the other child's rather than dropping it.
    other = r2 if a >= 0.5 else r1
    out["kd_tex_name"] = dom.get("kd_tex_name") or other.get("kd_tex_name")
    return out


def _remap_roughness(rough: float) -> float:
    """pbrt TrowbridgeReitzDistribution::RoughnessToAlpha
    (core/microfacet.h)."""
    rough = max(rough, 1e-3)
    x = np.log(rough)
    return float(
        1.62142 + 0.819955 * x + 0.1734 * x * x
        + 0.0171201 * x**3 + 0.000640711 * x**4
    )


def build_scene(desc: SceneDescription,
                strict: bool | None = None) -> SceneTables:
    """strict=True (or env STATMC_STRICT_ASSETS=1) raises
    MissingAssetError when a referenced PLY/texture file is absent;
    the default warns LOUDLY and drops the asset.  A scene that
    "builds" with 2 triangles because its models/ directory is not
    mounted must never pass silently (it would make every render or
    perf claim against it vacuous)."""
    from .textures import TEX_NONE, TextureTableBuilder

    if strict is None:
        strict = os.environ.get("STATMC_STRICT_ASSETS", "") not in ("", "0")
    missing_assets: list[str] = []
    tex_builder = TextureTableBuilder()

    def resolve_texture(tex_name) -> int:
        """Texture name -> atlas id (imagemap/checkerboard; -1 else)."""
        td = desc.textures.get(tex_name)
        if td is None:
            return TEX_NONE
        us = float(td.params.find_one("uscale", 1.0) or 1.0)
        vs = float(td.params.find_one("vscale", 1.0) or 1.0)
        if td.tex_class == "imagemap":
            fn = td.params.find_one("filename")
            if fn is None:
                return TEX_NONE
            path = fn if os.path.isabs(fn) else os.path.join(td.cwd, fn)
            if not os.path.exists(path):
                missing_assets.append(path)
                return TEX_NONE
            return tex_builder.add_image(path, us, vs)
        if td.tex_class == "checkerboard":
            t1 = td.params.find_spectrum("tex1", np.ones(3, np.float32))
            t2 = td.params.find_spectrum("tex2", np.zeros(3, np.float32))
            return tex_builder.add_checker(t1, t2, us, vs)
        if td.tex_class == "constant":
            v = td.params.find_spectrum("value", np.ones(3, np.float32))
            return tex_builder.add_constant(v)
        if td.tex_class == "scale":
            # scale = tex1 * tex2 (textures/scale.cpp); a textured
            # operand becomes the child, constant operands fold.
            t1 = td.params.find_one("tex1")
            t2 = td.params.find_one("tex2")
            if isinstance(t1, str):
                child = resolve_texture(t1)
                s = (td.params.find_spectrum("tex2", None)
                     if not isinstance(t2, str) else None)
                s = s if s is not None else np.ones(3, np.float32)
                return tex_builder.add_scale(child, s)
            if isinstance(t2, str):
                child = resolve_texture(t2)
                s = td.params.find_spectrum("tex1", np.ones(3, np.float32))
                return tex_builder.add_scale(child, s)
            s1 = td.params.find_spectrum("tex1", np.ones(3, np.float32))
            s2 = td.params.find_spectrum("tex2", np.ones(3, np.float32))
            return tex_builder.add_constant(s1 * s2)
        if td.tex_class == "mix":
            t1 = td.params.find_one("tex1")
            t2 = td.params.find_one("tex2")
            amt = float(td.params.find_one("amount", 0.5))
            c0 = resolve_texture(t1) if isinstance(t1, str) else -1
            c1 = resolve_texture(t2) if isinstance(t2, str) else -1
            r0 = (td.params.find_spectrum("tex1", np.zeros(3, np.float32))
                  if c0 < 0 else None)
            r1 = (td.params.find_spectrum("tex2", np.ones(3, np.float32))
                  if c1 < 0 else None)
            return tex_builder.add_mix(c0, c1, amt, r0, r1)
        if td.tex_class in ("fbm", "wrinkled", "windy", "marble"):
            from .textures import (KIND_FBM, KIND_MARBLE, KIND_WINDY,
                                   KIND_WRINKLED)

            kind = {"fbm": KIND_FBM, "wrinkled": KIND_WRINKLED,
                    "windy": KIND_WINDY, "marble": KIND_MARBLE}[td.tex_class]
            return tex_builder.add_noise(
                kind,
                octaves=int(td.params.find_one("octaves", 8)),
                omega=float(td.params.find_one("roughness", 0.5)),
                scale=float(td.params.find_one("scale", 1.0)),
                variation=float(td.params.find_one("variation", 0.2)),
            )
        if td.tex_class == "dots":
            inside = td.params.find_spectrum("inside",
                                             np.ones(3, np.float32))
            outside = td.params.find_spectrum("outside",
                                              np.zeros(3, np.float32))
            return tex_builder.add_dots(inside, outside, us, vs)
        if td.tex_class == "uv":
            return tex_builder.add_uv(us, vs)
        if td.tex_class == "bilerp":
            v00 = td.params.find_spectrum("v00", np.zeros(3, np.float32))
            v01 = td.params.find_spectrum("v01", np.ones(3, np.float32))
            v10 = td.params.find_spectrum("v10", np.zeros(3, np.float32))
            v11 = td.params.find_spectrum("v11", np.ones(3, np.float32))
            return tex_builder.add_bilerp(v00, v01, v10, v11)
        return TEX_NONE

    tri_p, tri_n, tri_uv, tri_mat, tri_light, tri_hasn = [], [], [], [], [], []
    sph_c, sph_r, sph_mat, sph_light, sph_flip = [], [], [], [], []
    tri_med_in, tri_med_out, sph_med_in, sph_med_out = [], [], [], []
    # Medium ids by declaration order (-1 = vacuum / unknown name).
    med_names = list(desc.named_media.keys())
    med_id = {n: i for i, n in enumerate(med_names)}

    def medium_ref(name):
        return med_id.get(name, -1) if name else -1
    mat_rows: list[dict] = []
    mat_cache: dict[int, int] = {}
    lights: list[dict] = []

    def material_id(md: MaterialDesc | None) -> int:
        key = id(md)
        if key in mat_cache:
            return mat_cache[key]
        if md is not None and md.mat_type == "mix":
            n1 = md.params.find_one("namedmaterial1")
            n2 = md.params.find_one("namedmaterial2")
            amt = md.params.find_spectrum("amount",
                                          np.full(3, 0.5, np.float32))
            r1 = _material_row(desc.named_materials.get(n1), desc.textures)
            r2 = _material_row(desc.named_materials.get(n2), desc.textures)
            row = _mix_rows(r1, r2, amt)
        else:
            row = _material_row(md, desc.textures)
        mat_rows.append(row)
        mat_cache[key] = len(mat_rows) - 1
        return mat_cache[key]

    def add_area_light(params: ParamSet) -> int:
        L = params.find_spectrum("L", np.ones(3, np.float32))
        scale = params.find_one("scale", 1.0)
        if not isinstance(scale, (int, float)):
            scale = 1.0
        lights.append(
            dict(kind=-1, L=np.asarray(L, np.float32) * float(scale),
                 prim=0, count=0, pos=np.zeros(3, np.float32),
                 aux=np.zeros(3, np.float32), par=np.zeros(2, np.float32),
                 area=0.0, tris=[])
        )
        return len(lights) - 1

    for sd in desc.shapes:
        mid = material_id(sd.material)
        lid = add_area_light(sd.area_light) if sd.area_light is not None else -1
        m_in = medium_ref(sd.medium_in)
        m_out = medium_ref(sd.medium_out)
        if sd.shape_type not in ("sphere",):
            if sd.shape_type in ("trianglemesh", "plymesh"):
                mesh = _load_mesh(sd, missing_assets)
            else:
                # Every other pbrt shape plugin (disk/cylinder/cone/
                # paraboloid/hyperboloid/curve/heightfield/loopsubdiv/
                # nurbs) tessellates into the same flat triangle tables.
                from .tessellate import tessellate_shape

                mesh = tessellate_shape(sd)
            if mesh is None:
                continue
            P, N, UV, idx = mesh
            o2w = sd.object_to_world
            Pw = cm.np_transform_point(o2w, P)
            has_n = N is not None
            if has_n:
                inv = np.linalg.inv(o2w.astype(np.float64)).astype(np.float32)
                Nw = cm.np_transform_normal(inv, N)
                norms = np.linalg.norm(Nw, axis=-1, keepdims=True)
                Nw = Nw / np.maximum(norms, 1e-12)
            # ReverseOrientation ^ transformSwapsHandedness flips every
            # normal (core/shape.cpp:49).  Triangles encode the flip by
            # swapping winding (flips ng = e1 x e2) + negating shading
            # normals, so no per-tri sign column is needed downstream.
            flip = bool(sd.reverse_orientation) ^ bool(
                np.linalg.det(o2w[:3, :3].astype(np.float64)) < 0)
            nsgn = np.float32(-1.0 if flip else 1.0)
            start = len(tri_p)
            for f in idx:
                if flip:
                    f = (f[0], f[2], f[1])
                p0, p1, p2 = Pw[f[0]], Pw[f[1]], Pw[f[2]]
                tri_p.append((p0, p1, p2))
                if has_n:
                    tri_n.append((nsgn * Nw[f[0]], nsgn * Nw[f[1]],
                                  nsgn * Nw[f[2]]))
                else:
                    tri_n.append((np.zeros(3, np.float32),) * 3)
                if UV is not None:
                    tri_uv.append((UV[f[0]], UV[f[1]], UV[f[2]]))
                else:
                    tri_uv.append(
                        (np.array([0, 0], np.float32),
                         np.array([1, 0], np.float32),
                         np.array([1, 1], np.float32))
                    )
                tri_hasn.append(has_n)
                tri_mat.append(mid)
                tri_light.append(lid)
                tri_med_in.append(m_in)
                tri_med_out.append(m_out)
            if lid >= 0:
                # pbrt attaches one DiffuseAreaLight per Shape, and a
                # triangle mesh is a vector of Triangle shapes -> one
                # light per emissive triangle (core/api.cpp:
                # pbrtShape area-light loop).
                lights[lid]["kind"] = LIGHT_AREA_TRI
                lights[lid]["tris"] = list(range(start, len(tri_p)))
        elif sd.shape_type == "sphere":
            radius = sd.params.find_one("radius", 1.0)
            o2w = sd.object_to_world
            center = cm.np_transform_point(o2w, np.zeros(3, np.float32))
            # Uniform scale folds into radius; general ellipsoids are
            # out of scope (none of the reference scenes use them).
            sx = np.linalg.norm(o2w[:3, 0])
            sph_c.append(center.astype(np.float32))
            sph_r.append(float(radius) * float(sx))
            sph_mat.append(mid)
            sph_light.append(lid)
            sph_flip.append(-1.0 if (
                bool(sd.reverse_orientation)
                ^ bool(np.linalg.det(o2w[:3, :3].astype(np.float64)) < 0)
            ) else 1.0)
            sph_med_in.append(m_in)
            sph_med_out.append(m_out)
            if lid >= 0:
                lights[lid]["kind"] = LIGHT_AREA_SPH
                lights[lid]["prim"] = len(sph_c) - 1
                lights[lid]["area"] = 4.0 * np.pi * sph_r[-1] ** 2

    for ld in desc.lights:
        p = ld.params
        l2w = ld.light_to_world
        if ld.light_type == "point":
            I = p.find_spectrum("I", np.ones(3, np.float32))
            scale = p.find_spectrum("scale", np.ones(3, np.float32))
            frm = p.find_one("from")
            pos = np.asarray(frm, np.float32) if frm is not None else np.zeros(3, np.float32)
            pos = cm.np_transform_point(l2w, pos)
            lights.append(dict(kind=LIGHT_POINT, L=I * scale, prim=0, count=0,
                               pos=pos, aux=np.zeros(3, np.float32),
                               par=np.zeros(2, np.float32), area=0.0, tris=[]))
        elif ld.light_type == "distant":
            L = p.find_spectrum("L", np.ones(3, np.float32))
            scale = p.find_spectrum("scale", np.ones(3, np.float32))
            frm = p.find_one("from")
            to = p.find_one("to")
            frm = np.asarray(frm, np.float32) if frm is not None else np.zeros(3, np.float32)
            to = np.asarray(to, np.float32) if to is not None else np.array([0, 0, 1], np.float32)
            wlight = cm.np_transform_point(l2w, frm) - cm.np_transform_point(l2w, to)
            n = np.linalg.norm(wlight)
            wlight = wlight / max(n, 1e-12)  # direction TOWARD light
            lights.append(dict(kind=LIGHT_DISTANT, L=L * scale, prim=0, count=0,
                               pos=wlight.astype(np.float32),
                               aux=np.zeros(3, np.float32),
                               par=np.zeros(2, np.float32), area=0.0, tris=[]))
        elif ld.light_type == "infinite":
            L = p.find_spectrum("L", np.ones(3, np.float32))
            scale = p.find_spectrum("scale", np.ones(3, np.float32))
            mapname = p.find_one("mapname")
            rec = dict(kind=LIGHT_INFINITE, L=L * scale, prim=0,
                       count=0, pos=np.zeros(3, np.float32),
                       aux=np.zeros(3, np.float32),
                       par=np.zeros(2, np.float32), area=0.0, tris=[])
            if mapname:
                path = mapname if os.path.isabs(mapname) else os.path.join(
                    ld.cwd, mapname)
                if os.path.exists(path):
                    rec["env_path"] = path
                    rec["env_l2w"] = l2w
                else:
                    missing_assets.append(path)
            lights.append(rec)
        elif ld.light_type == "spot":
            I = p.find_spectrum("I", np.ones(3, np.float32))
            scale = p.find_spectrum("scale", np.ones(3, np.float32))
            frm = p.find_one("from")
            to = p.find_one("to")
            frm = np.asarray(frm, np.float32) if frm is not None else np.zeros(3, np.float32)
            to = np.asarray(to, np.float32) if to is not None else np.array([0, 0, 1], np.float32)
            pos = cm.np_transform_point(l2w, frm)
            dirn = cm.np_transform_point(l2w, to) - pos
            dirn = dirn / max(np.linalg.norm(dirn), 1e-12)
            cone = float(p.find_one("coneangle", 30.0))
            delta = float(p.find_one("conedeltaangle", 5.0))
            lights.append(dict(
                kind=LIGHT_SPOT, L=I * scale, prim=0, count=0, pos=pos,
                aux=dirn.astype(np.float32),
                par=np.array([np.cos(np.radians(cone)),
                              np.cos(np.radians(cone - delta))], np.float32),
                area=0.0, tris=[]))
        elif ld.light_type in ("goniometric", "projection"):
            # Point lights modulated by an image: by direction
            # (lights/goniometric.cpp) or through a projector frustum
            # (lights/projection.cpp).
            I = p.find_spectrum("I", np.ones(3, np.float32))
            scale = p.find_spectrum("scale", np.ones(3, np.float32))
            pos = cm.np_transform_point(l2w, np.zeros(3, np.float32))
            w2l = np.linalg.inv(l2w.astype(np.float64))[:3, :3]
            mapname = p.find_one("mapname")
            tex = -1
            aspect = 1.0
            if mapname is not None:
                path = (mapname if os.path.isabs(mapname)
                        else os.path.join(ld.cwd, mapname))
                tex = tex_builder.add_image(path)
                if tex >= 0:
                    row = tex_builder.rows[tex]
                    aspect = row["width"] / max(row["height"], 1)
            if ld.light_type == "goniometric":
                lights.append(dict(
                    kind=LIGHT_GONIO, L=I * scale, prim=0, count=0,
                    pos=pos, aux=np.zeros(3, np.float32),
                    par=np.zeros(2, np.float32), area=0.0, tris=[],
                    w2l=w2l.astype(np.float32).reshape(-1), tex=tex))
            else:
                fov = float(p.find_one("fov", 45.0))
                lights.append(dict(
                    kind=LIGHT_PROJ, L=I * scale, prim=0, count=0,
                    pos=pos, aux=np.zeros(3, np.float32),
                    par=np.array([np.tan(np.radians(fov) / 2), aspect],
                                 np.float32),
                    area=0.0, tris=[],
                    w2l=w2l.astype(np.float32).reshape(-1), tex=tex))
    # Explode mesh area lights into one light per triangle (pbrt
    # semantics) and drop records whose shapes were skipped.
    new_lights: list[dict] = []
    tri_light_new = list(tri_light)
    sph_remap: dict[int, int] = {}
    for old_id, l in enumerate(lights):
        if l["kind"] == LIGHT_AREA_TRI:
            for t in l["tris"]:
                nl = dict(l)
                nl["prim"] = t
                nl["count"] = 1
                nl["tris"] = []
                new_lights.append(nl)
                tri_light_new[t] = len(new_lights) - 1
        elif l["kind"] >= 0:
            new_lights.append(l)
            sph_remap[old_id] = len(new_lights) - 1
    lights = new_lights
    tri_light = tri_light_new
    sph_light = [sph_remap.get(l, -1) for l in sph_light]

    # Assemble triangle arrays.
    T = len(tri_p)
    if T:
        p0 = np.stack([t[0] for t in tri_p]).astype(np.float32)
        p1 = np.stack([t[1] for t in tri_p]).astype(np.float32)
        p2 = np.stack([t[2] for t in tri_p]).astype(np.float32)
        n0 = np.stack([t[0] for t in tri_n]).astype(np.float32)
        n1 = np.stack([t[1] for t in tri_n]).astype(np.float32)
        n2 = np.stack([t[2] for t in tri_n]).astype(np.float32)
        uv0 = np.stack([t[0] for t in tri_uv]).astype(np.float32)
        uv1 = np.stack([t[1] for t in tri_uv]).astype(np.float32)
        uv2 = np.stack([t[2] for t in tri_uv]).astype(np.float32)
    else:
        p0 = p1 = p2 = n0 = n1 = n2 = np.zeros((0, 3), np.float32)
        uv0 = uv1 = uv2 = np.zeros((0, 2), np.float32)

    # Per-triangle light areas (each emissive triangle is its own light).
    for l in lights:
        if l["kind"] == LIGHT_AREA_TRI:
            t = l["prim"]
            l["area"] = float(
                0.5 * np.linalg.norm(np.cross(p1[t] - p0[t], p2[t] - p0[t]))
            )

    # Environment map tables (InfiniteAreaLight, src/lights/infinite.cpp:
    # luminance*sin(theta)-weighted Distribution2D over the equirect map).
    env_map = np.zeros((1, 1, 3), np.float32)
    env_marg = np.ones((1,), np.float32)
    env_cond = np.ones((1, 1), np.float32)
    env_pdf = np.ones((1, 1), np.float32)
    env_w2l = np.eye(4, dtype=np.float32)
    env_lid = -1
    for li, l in enumerate(lights):
        if l["kind"] == LIGHT_INFINITE and "env_path" in l:
            from ..io.image import read_image

            try:
                img = read_image(l["env_path"]).astype(np.float32)
            except (OSError, ValueError):
                continue
            img = img * l["L"][None, None, :]
            He, We = img.shape[:2]
            lum = img @ np.array([0.212671, 0.715160, 0.072169], np.float32)
            theta = (np.arange(He) + 0.5) / He * np.pi
            w = lum * np.sin(theta)[:, None] + 1e-12
            marg = w.sum(axis=1)
            env_pdf = (w / w.sum() * (He * We)).astype(np.float32)  # pdf(u,v)
            env_marg = (np.cumsum(marg) / marg.sum()).astype(np.float32)
            env_cond = (np.cumsum(w, axis=1)
                        / w.sum(axis=1, keepdims=True)).astype(np.float32)
            env_map = img
            env_w2l = np.linalg.inv(
                l["env_l2w"].astype(np.float64)).astype(np.float32)
            env_lid = li
            l["L"] = np.ones(3, np.float32)  # folded into the map
            break

    if not mat_rows:
        mat_rows.append(_material_row(None, desc.textures))

    # Participating media tables (core/api.cpp:693-738 MakeMedium).
    M = len(med_names)
    med_sa = np.zeros((M, 3), np.float32)
    med_ss = np.zeros((M, 3), np.float32)
    med_g = np.zeros((M,), np.float32)
    med_kind = np.zeros((M,), np.int32)
    med_w2m = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    med_imd = np.ones((M,), np.float32)
    med_st0 = np.zeros((M,), np.float32)
    med_nxyz = np.ones((M, 3), np.int32)
    grids: list[np.ndarray] = []
    for i, n in enumerate(med_names):
        md = desc.named_media[n]
        p = md.params
        mtype = str(p.find_one("type", "homogeneous"))
        scale = float(p.find_one("scale", 1.0))
        sa = p.find_spectrum(
            "sigma_a", np.array([0.0011, 0.0024, 0.014], np.float32))
        ss = p.find_spectrum(
            "sigma_s", np.array([2.55, 3.21, 3.77], np.float32))
        med_sa[i] = np.asarray(sa, np.float32) * scale
        med_ss[i] = np.asarray(ss, np.float32) * scale
        med_g[i] = float(p.find_one("g", 0.0))
        if mtype == "heterogeneous":
            dens = p.find_floats("density")
            nx = int(p.find_one("nx", 1))
            ny = int(p.find_one("ny", 1))
            nz = int(p.find_one("nz", 1))
            if dens is None or dens.size != nx * ny * nz:
                raise ValueError(
                    f"medium {n!r}: density size != nx*ny*nz")
            g3 = np.asarray(dens, np.float32).reshape(nz, ny, nx)
            med_kind[i] = 1
            med_nxyz[i] = (nx, ny, nz)
            # Density space: medium2world * Translate(p0) * Scale(p1-p0)
            # maps [0,1]^3 onto the grid bounds (api.cpp:731-734).
            gp0 = p.find_floats("p0")
            gp1 = p.find_floats("p1")
            gp0 = (np.asarray(gp0, np.float32) if gp0 is not None
                   else np.zeros(3, np.float32))
            gp1 = (np.asarray(gp1, np.float32) if gp1 is not None
                   else np.ones(3, np.float32))
            d2m = np.eye(4, dtype=np.float32)
            d2m[:3, 3] = gp0
            d2m[0, 0], d2m[1, 1], d2m[2, 2] = gp1 - gp0
            m2w = md.medium_to_world.astype(np.float64) @ d2m.astype(
                np.float64)
            med_w2m[i] = np.linalg.inv(m2w).astype(np.float32)
            med_imd[i] = 1.0 / max(float(g3.max()), 1e-12)
            # Grid delta/ratio tracking needs a spectrally uniform
            # sigma_t (GridDensityMedium ctor asserts it); use channel 0.
            med_st0[i] = float(med_sa[i][0] + med_ss[i][0])
            grids.append(g3)
        else:
            grids.append(np.ones((1, 1, 1), np.float32))
    if M:
        Dz = max(g.shape[0] for g in grids)
        Dy = max(g.shape[1] for g in grids)
        Dx = max(g.shape[2] for g in grids)
        med_grid = np.zeros((M, Dz, Dy, Dx), np.float32)
        for i, g3 in enumerate(grids):
            med_grid[i, : g3.shape[0], : g3.shape[1], : g3.shape[2]] = g3
    else:
        med_grid = np.zeros((0, 1, 1, 1), np.float32)

    # Resolve material-texture references now (they land in mat_kd_tex
    # below) so missing texture files surface in the asset report.
    mat_kd_tex = np.asarray(
        [resolve_texture(r.get("kd_tex_name"))
         if r.get("kd_tex_name") else -1 for r in mat_rows], np.int32)

    # FourierBSDF tables (materials/fourier.cpp:116-206): read each
    # fourier material's .bsdf file into stacked tables
    # (render/fourier.py); unreadable/missing files keep the substrate
    # fallback (mat_fourier_id -1) and join the missing-asset report.
    fourier_tables = None
    mat_fourier_id = np.full((len(mat_rows),), -1, np.int32)
    if any(r.get("fourier_file") for r in mat_rows):
        from ..render.fourier import read_bsdf, stack_tables

        base_cwd = desc.shapes[0].cwd if desc.shapes else "."
        cache: dict[str, int] = {}
        files = []
        for mi_, r in enumerate(mat_rows):
            fn = r.get("fourier_file")
            if r["mat_type"] != MAT_FOURIER or not fn:
                continue
            path = fn if os.path.isabs(fn) else os.path.join(base_cwd, fn)
            if path not in cache:
                try:
                    files.append(read_bsdf(path))
                    cache[path] = len(files) - 1
                except (OSError, ValueError):
                    missing_assets.append(path)
                    cache[path] = -1
            mat_fourier_id[mi_] = cache[path]
        if files:
            fourier_tables = stack_tables(files)

    # Missing-asset report: a scene that "builds" with 2 triangles
    # because its models/ tree is absent must never pass silently.
    if missing_assets:
        uniq = sorted(set(missing_assets))
        head = "\n  ".join(uniq[:8])
        more = f"\n  ... and {len(uniq) - 8} more" if len(uniq) > 8 else ""
        msg = (
            f"scene references {len(uniq)} missing asset file(s) "
            f"(dropped; geometry/textures will be WRONG):\n  {head}{more}"
        )
        if strict:
            raise MissingAssetError(msg)
        log.warning(msg)
        print(f"WARNING: {msg}", file=sys.stderr)

    # BSSRDF tables (render/sss.py): one beam-diffusion profile per
    # subsurface material.  kdsubsurface rows first invert Kd + mfp into
    # (sigma_a, sigma_s) via SubsurfaceFromDiffuse
    # (materials/kdsubsurface.cpp:104-107); subsurface rows carry the
    # scaled coefficients directly (materials/subsurface.cpp:104-108).
    sss_tables = None
    mat_sss_id = np.full((len(mat_rows),), -1, np.int32)
    if any(r.get("sss") for r in mat_rows):
        from ..render.bssrdf import (compute_beam_diffusion_bssrdf,
                                     subsurface_from_diffuse)
        from ..render.sss import build_sss_tables

        prof_cache: dict = {}
        entries = []
        for mi_, r in enumerate(mat_rows):
            e = r.get("sss")
            if not e:
                continue
            gk = (round(float(e["g"]), 6), round(float(e["eta"]), 6))
            if e["kind"] == "kd":
                if gk not in prof_cache:
                    prof_cache[gk] = compute_beam_diffusion_bssrdf(
                        g=gk[0], eta=gk[1])
                sa, ss2 = subsurface_from_diffuse(
                    prof_cache[gk], e["kd"], e["mfp"])
                entries.append(dict(sigma_a=sa, sigma_s=ss2,
                                    g=e["g"], eta=e["eta"]))
            else:
                entries.append(dict(sigma_a=e["sigma_a"],
                                    sigma_s=e["sigma_s"],
                                    g=e["g"], eta=e["eta"]))
            mat_sss_id[mi_] = len(entries) - 1
        sss_tables = build_sss_tables(entries)

    # World bound.
    pts = [p0.reshape(-1, 3)] if T else []
    if sph_c:
        c = np.stack(sph_c)
        r = np.array(sph_r)[:, None]
        pts += [c - r, c + r]
    if T:
        pts += [p1, p2]
    allp = np.concatenate(pts, axis=0) if pts else np.zeros((1, 3), np.float32)
    lo, hi = allp.min(axis=0), allp.max(axis=0)
    wcenter = (lo + hi) / 2
    wradius = float(np.linalg.norm(hi - wcenter)) + 1e-3

    return SceneTables(
        tri_p0=p0, tri_e1=p1 - p0, tri_e2=p2 - p0,
        tri_n0=n0, tri_n1=n1, tri_n2=n2,
        tri_uv0=uv0, tri_uv1=uv1, tri_uv2=uv2,
        tri_mat=np.asarray(tri_mat, np.int32),
        tri_light=np.asarray(tri_light, np.int32),
        tri_has_normals=np.asarray(tri_hasn, bool),
        sph_center=(np.stack(sph_c).astype(np.float32) if sph_c
                    else np.zeros((0, 3), np.float32)),
        sph_radius=np.asarray(sph_r, np.float32),
        sph_mat=np.asarray(sph_mat, np.int32),
        sph_light=np.asarray(sph_light, np.int32),
        sph_flip=np.asarray(sph_flip, np.float32),
        mat_type=np.asarray([r["mat_type"] for r in mat_rows], np.int32),
        mat_kd=np.stack([r["kd"] for r in mat_rows]).astype(np.float32),
        mat_ks=np.stack([r["ks"] for r in mat_rows]).astype(np.float32),
        mat_kr=np.stack([r["kr"] for r in mat_rows]).astype(np.float32),
        mat_kt=np.stack([r["kt"] for r in mat_rows]).astype(np.float32),
        mat_eta=np.stack([r["eta"] for r in mat_rows]).astype(np.float32),
        mat_k=np.stack([r["k"] for r in mat_rows]).astype(np.float32),
        mat_rough_u=np.asarray([r["rough_u"] for r in mat_rows], np.float32),
        mat_rough_v=np.asarray([r["rough_v"] for r in mat_rows], np.float32),
        mat_sigma=np.asarray([r["sigma"] for r in mat_rows], np.float32),
        mat_kd_tex=mat_kd_tex,
        textures=tex_builder.build(),
        light_kind=(np.asarray([l["kind"] for l in lights], np.int32)
                    if lights else np.zeros((0,), np.int32)),
        light_L=(np.stack([l["L"] for l in lights]).astype(np.float32)
                 if lights else np.zeros((0, 3), np.float32)),
        light_prim=np.asarray([l["prim"] for l in lights], np.int32)
        if lights else np.zeros((0,), np.int32),
        light_prim_count=np.asarray([l["count"] for l in lights], np.int32)
        if lights else np.zeros((0,), np.int32),
        light_pos=(np.stack([l["pos"] for l in lights]).astype(np.float32)
                   if lights else np.zeros((0, 3), np.float32)),
        light_aux=(np.stack([l["aux"] for l in lights]).astype(np.float32)
                   if lights else np.zeros((0, 3), np.float32)),
        light_params=(np.stack([l["par"] for l in lights]).astype(np.float32)
                      if lights else np.zeros((0, 2), np.float32)),
        light_area=np.asarray([l["area"] for l in lights], np.float32)
        if lights else np.zeros((0,), np.float32),
        light_w2l=(np.stack([
            l.get("w2l", np.eye(3, dtype=np.float32).reshape(-1))
            for l in lights]).astype(np.float32)
            if lights else np.zeros((0, 9), np.float32)),
        light_tex=(np.asarray([l.get("tex", -1) for l in lights], np.int32)
                   if lights else np.zeros((0,), np.int32)),
        env_map=env_map,
        env_marginal_cdf=env_marg,
        env_cond_cdf=env_cond,
        env_pdf_uv=env_pdf,
        env_world_to_light=env_w2l,
        env_light_id=int(env_lid),
        world_center=wcenter.astype(np.float32),
        world_radius=np.float32(wradius),
        sss=sss_tables,
        mat_sss_id=mat_sss_id,
        med_sigma_a=med_sa,
        med_sigma_s=med_ss,
        med_g=med_g,
        med_kind=med_kind,
        med_w2m=med_w2m,
        med_grid=med_grid,
        med_nxyz=med_nxyz,
        med_inv_maxd=med_imd,
        med_sigt0=med_st0,
        tri_med_in=np.asarray(tri_med_in, np.int32),
        tri_med_out=np.asarray(tri_med_out, np.int32),
        sph_med_in=np.asarray(sph_med_in, np.int32),
        sph_med_out=np.asarray(sph_med_out, np.int32),
        cam_medium=medium_ref(desc.camera_medium),
        fourier=fourier_tables,
        mat_fourier_id=mat_fourier_id,
        has_textures=bool(np.any(mat_kd_tex >= 0)),
        has_image_lights=any(
            l["kind"] in (LIGHT_GONIO, LIGHT_PROJ) for l in lights),
        has_hair=any(r["mat_type"] == MAT_HAIR for r in mat_rows),
        has_sss=sss_tables is not None,
    )


def _load_mesh(sd: ShapeDesc, missing_assets: list | None = None):
    """Returns (P [V,3], N [V,3] | None, UV [V,2] | None, idx [F,3])."""
    if sd.shape_type == "trianglemesh":
        P = sd.params.find_floats("P")
        if P is None:
            return None
        P = P.reshape(-1, 3)
        idx = sd.params.find_ints("indices").reshape(-1, 3)
        N = sd.params.find_floats("N")
        N = N.reshape(-1, 3) if N is not None else None
        UV = sd.params.find_floats("uv")
        if UV is None:
            UV = sd.params.find_floats("st")
        UV = UV.reshape(-1, 2) if UV is not None else None
        return P, N, UV, idx
    if sd.shape_type == "plymesh":
        fn = sd.params.find_one("filename")
        if fn is None:
            return None
        path = fn if os.path.isabs(fn) else os.path.join(sd.cwd, fn)
        if not os.path.exists(path):
            if missing_assets is not None:
                missing_assets.append(path)
            return None
        return read_ply(path)
    return None