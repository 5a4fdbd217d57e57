"""Primitive intersection + hit assembly (port of
statmc_tpu/render/intersect.py).

Triangles go through the fused intersector (accel/fused.py, kernel B1)
or, above FUSED_MAX_TRIS, the two-level traversal (accel/twolevel.py,
kernels B3 and B4), or under `Accelerator "kdtree"` the kd-restart walk
(accel/kdtree.py, plain PyTorch); spheres are tested densely with the
quadric.  The
dpdu tangent is assembled for hair scenes (the Marschner frame measures
its angles against the curve axis) and for the exact lockstep replay,
whose BSDF frames follow pbrt's; the anisotropic uv footprint (uv_axes)
only for scenes with image textures, which filter through it.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import spans
from ..accel.fused import FusedTris, intersect_fused
from ..accel.kdtree import KdTreeTris, intersect_kdtree
from ..accel.twolevel import TwoLevelTris, intersect_twolevel
from ..core import math as cm
from ..scene.build import SceneTables, scene_has_hair
from ..scene.textures import has_image_textures

PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPH = 2


class Hit(NamedTuple):
    """SoA hit record for a ray batch."""
    t: Any  # [R] hit distance (t_max if miss)
    prim_kind: Any  # [R] PRIM_*
    prim_idx: Any  # [R]
    p: Any  # [R,3] hit point
    ng: Any  # [R,3] geometric normal
    ns: Any  # [R,3] shading normal
    uv: Any  # [R,2]
    mat_id: Any  # [R]
    light_id: Any  # [R] area-light id or -1
    uv_density: Any  # [R] sqrt(uv area / world area)
    tangent: Any = None  # [R,3] dpdu, only with want_tangent
    # [R,2,2] anisotropic uv footprint axes per unit ray-cone width
    # (major, minor), only for scenes with image textures (the EWA path,
    # scene/textures.py:_ewa_lookup); None otherwise.
    uv_axes: Any = None

    @property
    def found(self):
        return self.prim_kind != PRIM_NONE


def ray_spheres(o, d, center, radius, t_max):
    """Quadratic sphere test: rays [R,3] x spheres [S] -> (t, hit) [R,S].

    The dot products and the discriminant are rounded as the JAX
    package's compiled CPU code rounds them (fused multiply-adds): near a
    silhouette b*b - c cancels, and one rounding there moves t by far
    more than an ulp."""
    oc = o[:, None, :] - center[None]
    b = cm.dot_fused(oc, d[:, None, :])
    c = cm.fma(-radius[None], radius[None], cm.dot_fused(oc, oc))
    disc = cm.fma(b, b, -c)
    ok = disc >= 0.0
    sq = cm.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    eps = 1e-3
    t = torch.where(t0 > eps, t0, t1)
    hit = ok & (t > eps) & (t < t_max[:, None])
    return t, hit


def _assemble_hit(scene: SceneTables, o, d, t_best, kind, idx,
                  lean: bool = False, want_tangent: bool | None = None) -> Hit:
    """Gather hit attributes for the closest primitives.  lean=True skips
    the shading-only attributes (the BSDF-MIS light probe reads only
    found / light_id / ng / p); want_tangent adds the normalized dpdu
    (triangle.cpp:309), the x axis of pbrt's BSDF frame (None: for hair
    scenes only).  Scenes with image textures also get uv_axes (not for
    lean hits)."""
    R = o.shape[0]
    dev = o.device
    if want_tangent is None:
        want_tangent = scene_has_hair(scene)
    want_tangent = want_tangent and not lean
    want_axes = (not lean) and has_image_textures(scene.textures)
    tangent = None
    uv_axes = None
    tri_idx = torch.where(kind == PRIM_TRI, idx, 0).long()
    sph_idx = torch.where(kind == PRIM_SPH, idx, 0).long()
    # Scenes with media round the hit point as the JAX package's compiled
    # code does, o + t d contracted to an FMA: the transmittance walk's
    # next segment starts there, and where a null face lies on another
    # surface (a smoke box on the floor) an ulp of it decides which one
    # the walk hits.  Other scenes keep the plain sum.
    p = (cm.fma(t_best[:, None], d, o) if scene.has_media
         else o + t_best[:, None] * d)
    has_tris = scene.tri_p0.shape[0] > 0
    has_sph = scene.sph_center.shape[0] > 0

    if has_tris:
        p0, e1, e2 = (scene.tri_p0[tri_idx], scene.tri_e1[tri_idx],
                      scene.tri_e2[tri_idx])
        n0, n1, n2 = (scene.tri_n0[tri_idx], scene.tri_n1[tri_idx],
                      scene.tri_n2[tri_idx])
        hasn = scene.tri_has_normals[tri_idx]
        light_t = scene.tri_light[tri_idx]
        mat_t = (torch.zeros((R,), dtype=torch.int32, device=dev) if lean
                 else scene.tri_mat[tri_idx])
        ng_t = cm.normalize(cm.cross(e1, e2))
        # Hair scenes round the barycentrics' dot products as the JAX
        # package's compiled code does (dot_fused): across a hair ribbon a
        # few hundredths wide the solve is ill-conditioned, and the plain
        # sums move v, hence the Marschner offset h, by ~1e-5.  Other
        # scenes keep the plain sums.
        bdot = cm.dot_fused if scene_has_hair(scene) else cm.dot
        pvec = cm.cross(d, e2)
        det = bdot(e1, pvec)
        inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = o - p0
        u = bdot(tvec, pvec) * inv_det
        v = bdot(d, cm.cross(tvec, e1)) * inv_det
        w = 1.0 - u - v
        ns_t = cm.normalize(w[:, None] * n0 + u[:, None] * n1
                            + v[:, None] * n2)
        # pbrt orients ng toward the shading normal (triangle.cpp:372).
        ng_t = torch.where((hasn & (cm.dot(ng_t, ns_t) < 0.0))[:, None],
                           -ng_t, ng_t)
        ns_t = torch.where(hasn[:, None], ns_t, ng_t)
        if lean:
            uv_t = torch.zeros((R, 2), device=dev)
            dens_t = torch.zeros((R,), device=dev)
        else:
            uv0, uv1, uv2 = (scene.tri_uv0[tri_idx], scene.tri_uv1[tri_idx],
                             scene.tri_uv2[tri_idx])
            uv_t = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
            uv_area = torch.abs((uv1 - uv0)[:, 0] * (uv2 - uv0)[:, 1]
                                - (uv1 - uv0)[:, 1] * (uv2 - uv0)[:, 0])
            w_area = cm.length(cm.cross(e1, e2))
            dens_t = cm.sqrt(uv_area / torch.clamp(w_area, min=1e-12))
            if want_tangent:
                duv1, duv2 = uv1 - uv0, uv2 - uv0
                det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
                inv_uv = torch.where(torch.abs(det_uv) > 1e-12,
                                     1.0 / det_uv, 0.0)[:, None]
                tan_t = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv_uv
                degen = torch.sum(tan_t * tan_t, -1, keepdim=True) < 1e-16
                tan_t = cm.normalize(torch.where(degen, e1, tan_t))
            if want_axes:
                axes_t = _footprint_axes(d, ng_t, e1, e2, uv1 - uv0,
                                         uv2 - uv0)
    if has_sph:
        cen = scene.sph_center[sph_idx]
        dir_s = cm.normalize(p - cen)
        ng_s = dir_s * scene.sph_flip[sph_idx][:, None]
        ns_s = ng_s
        light_s = scene.sph_light[sph_idx]
        if lean:
            uv_s = torch.zeros((R, 2), device=dev)
            mat_s = torch.zeros((R,), dtype=torch.int32, device=dev)
            dens_s = torch.zeros((R,), device=dev)
        else:
            phi = torch.atan2(dir_s[..., 1], dir_s[..., 0])
            theta = torch.arccos(torch.clamp(dir_s[..., 2], -1.0, 1.0))
            uv_s = torch.stack([phi / (2 * math.pi) + 0.5, theta / math.pi],
                               dim=-1)
            mat_s = scene.sph_mat[sph_idx]
            rad = scene.sph_radius[sph_idx]
            dens_s = 1.0 / cm.sqrt(torch.clamp(
                4.0 * math.pi * rad * rad, min=1e-12))

    if has_tris and has_sph:
        is_t = (kind == PRIM_TRI)
        ng = torch.where(is_t[:, None], ng_t, ng_s)
        ns = torch.where(is_t[:, None], ns_t, ns_s)
        uv = torch.where(is_t[:, None], uv_t, uv_s)
        mat = torch.where(is_t, mat_t, mat_s)
        light = torch.where(is_t, light_t, light_s)
        dens = torch.where(is_t, dens_t, dens_s)
        if want_tangent:
            # Sphere dpdu: the d(phi) direction.
            tangent = torch.where(is_t[:, None], tan_t, torch.stack(
                [-dir_s[..., 1], dir_s[..., 0],
                 torch.zeros_like(dir_s[..., 0])], -1))
        if want_axes:
            # Spheres fall back to an isotropic footprint of uv_density.
            iso = dens_s[:, None, None] * torch.eye(2, device=dev)
            uv_axes = torch.where(is_t[:, None, None], axes_t, iso)
    elif has_tris:
        ng, ns, uv, mat, light, dens = ng_t, ns_t, uv_t, mat_t, light_t, dens_t
        if want_tangent:
            tangent = tan_t
        if want_axes:
            uv_axes = axes_t
    elif has_sph:
        ng, ns, uv, mat, light, dens = ng_s, ns_s, uv_s, mat_s, light_s, dens_s
    else:
        ng = ns = torch.zeros((R, 3), device=dev)
        uv = torch.zeros((R, 2), device=dev)
        mat = torch.zeros((R,), dtype=torch.int32, device=dev)
        light = torch.full((R,), -1, dtype=torch.int32, device=dev)
        dens = torch.zeros((R,), device=dev)

    miss = kind == PRIM_NONE
    return Hit(
        t=t_best, prim_kind=kind, prim_idx=idx, p=p,
        ng=torch.where(miss[:, None], 0.0, ng),
        ns=torch.where(miss[:, None], 0.0, ns),
        uv=uv,
        mat_id=torch.where(miss, 0, mat),
        light_id=torch.where(miss, -1, light),
        uv_density=torch.where(miss, 0.0, dens),
        tangent=tangent,
        uv_axes=uv_axes,
    )


def _footprint_axes(d, ng, e1, e2, duv1, duv2):
    """Anisotropic uv footprint per unit ray-cone width (mipmap.h:Lookup
    dst0/dst1 stand-in), [R,2,2] (major, minor): the cone's disc projects
    onto the surface as an ellipse whose major axis follows the view
    direction stretched by 1/cos."""
    def world_to_uv(wv):
        # Solve wv = s*e1 + t*e2 (in-plane least squares) -> uv
        # displacement s*duv1 + t*duv2.
        g11 = torch.sum(e1 * e1, -1)
        g12 = torch.sum(e1 * e2, -1)
        g22 = torch.sum(e2 * e2, -1)
        b1 = torch.sum(wv * e1, -1)
        b2 = torch.sum(wv * e2, -1)
        det = g11 * g22 - g12 * g12
        inv = torch.where(torch.abs(det) > 1e-20, 1.0 / det, 0.0)
        s_ = (g22 * b1 - g12 * b2) * inv
        t_ = (g11 * b2 - g12 * b1) * inv
        return s_[:, None] * duv1 + t_[:, None] * duv2

    cos_v = torch.abs(torch.sum(d * ng, -1))
    proj = d - torch.sum(d * ng, -1, keepdim=True) * ng
    plen = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
    mhat = torch.where(plen > 1e-6, proj / torch.clamp(plen, min=1e-12),
                       cm.normalize(e1))
    stretch = 1.0 / torch.clamp(cos_v, min=0.05)
    minor_w = cm.cross(ng, mhat)
    return torch.stack([world_to_uv(mhat) * stretch[:, None],
                        world_to_uv(minor_w)], dim=1)


def _closest_sphere(scene, o, d, t_best, kind, idx):
    t, hit = ray_spheres(o, d, scene.sph_center, scene.sph_radius, t_best)
    t = torch.where(hit, t, cm.INF)
    j = torch.argmin(t, dim=-1)
    tj = torch.gather(t, 1, j[:, None])[:, 0]
    better = tj < t_best
    return (torch.where(better, tj, t_best),
            torch.where(better, PRIM_SPH, kind),
            torch.where(better, j.to(torch.int32), idx))


def _intersect_tris(bvh, o, d, t_max):
    """Closest triangle hit (t, tri_id, hit) through the accelerator the
    driver chose for the scene (statmc_tpu's _bvh_intersect)."""
    if isinstance(bvh, TwoLevelTris):
        return intersect_twolevel(bvh, o, d, t_max)
    if isinstance(bvh, KdTreeTris):
        return intersect_kdtree(bvh, o, d, t_max)
    return intersect_fused(bvh, o, d, t_max)


def _count_lanes(kind: str, o, t_max):
    """While tracing: the counters intersect.<kind>.lanes (the call's
    rays) and .live (those with t_max > 0; dead lanes are queried with
    t_max = 0), the second summed on the device."""
    if spans.enabled():
        spans.count(f"intersect.{kind}.lanes", o.shape[0])
        live = t_max > 0
        spans.count(f"intersect.{kind}.live",
                    live if torch.is_tensor(live) else o.shape[0] * live)


@spans.spanned("intersect.closest")
def intersect_scene(scene: SceneTables, o, d, t_max,
                    bvh: FusedTris | TwoLevelTris | KdTreeTris | None,
                    lean: bool = False,
                    want_tangent: bool | None = None) -> Hit:
    """Closest hit: dense spheres, then triangles through B1, B3 + B4 or
    the kd walk.  bvh is None only for a scene without triangles."""
    _count_lanes("closest", o, t_max)
    R = o.shape[0]
    t_best = t_max
    kind = torch.zeros((R,), dtype=torch.int32, device=o.device)
    idx = torch.zeros((R,), dtype=torch.int32, device=o.device)
    if scene.sph_center.shape[0] > 0:
        t_best, kind, idx = _closest_sphere(scene, o, d, t_best, kind, idx)
    if scene.tri_p0.shape[0] > 0:
        tt, tid, found = _intersect_tris(bvh, o, d, t_best)
        better = found & (tt < t_best)
        t_best = torch.where(better, tt, t_best)
        kind = torch.where(better, PRIM_TRI, kind)
        idx = torch.where(better, tid, idx)
    return _assemble_hit(scene, o, d, t_best, kind, idx, lean=lean,
                         want_tangent=want_tangent)


@spans.spanned("intersect.occluded")
def occluded_scene(scene: SceneTables, o, d, t_max,
                   bvh: FusedTris | TwoLevelTris | KdTreeTris | None):
    """Any-hit (shadow) test via dense spheres + the triangle accelerator
    (a full closest hit, as in the JAX package)."""
    _count_lanes("occluded", o, t_max)
    blocked = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    if scene.sph_center.shape[0] > 0:
        _, hit = ray_spheres(o, d, scene.sph_center, scene.sph_radius, t_max)
        blocked |= torch.any(hit, dim=-1)
    if scene.tri_p0.shape[0] > 0:
        if isinstance(bvh, KdTreeTris):
            # The kd walk stops at its first hit, as in the JAX package;
            # the fused and two-level paths find the closest.
            _, _, found = intersect_kdtree(bvh, o, d, t_max, any_hit=True)
        else:
            _, _, found = _intersect_tris(bvh, o, d, t_max)
        blocked |= found
    return blocked
