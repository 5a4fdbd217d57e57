"""Light sampling over lanes (port of statmc_tpu/render/lights.py).

Every emissive triangle is its own light, spheres use cone sampling from
outside points, and all light kinds are evaluated branchlessly and
selected per lane with ``torch.where``.  Image-modulated lights and
environment maps are not ported (driver.prepare refuses them), so the
infinite light here is the constant one.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..core import math as cm
from ..scene import build as sb


def _light_rows(scene: sb.SceneTables, light_id):
    lid = light_id.long()
    return (scene.light_kind[lid], scene.light_L[lid],
            scene.light_prim[lid], scene.light_pos[lid],
            scene.light_aux[lid], scene.light_params[lid],
            scene.light_area[lid])


class LightSample(NamedTuple):
    wi: Any  # [R,3] world, unit, toward light
    pdf: Any  # [R] solid-angle pdf
    li: Any  # [R,3] radiance arriving if unoccluded
    p_light: Any  # [R,3] point on light
    dist: Any  # [R] distance to the light point
    is_delta: Any  # [R] delta light


def sample_li(scene: sb.SceneTables, light_id, ref_p, ref_ng, u2
              ) -> LightSample:
    """Sample one light per lane. light_id: [R] into the light tables."""
    kind, L, prim, pos, aux, par, area = _light_rows(scene, light_id)
    R = ref_p.shape[0]
    zeros_r = torch.zeros((R,), device=ref_p.device)

    # ---- AREA_TRI: uniform-area triangle sampling --------------------
    if scene.tri_p0.shape[0] > 0:
        tid = torch.where(kind == sb.LIGHT_AREA_TRI, prim, 0).long()
        p0, e1, e2 = scene.tri_p0[tid], scene.tri_e1[tid], scene.tri_e2[tid]
        su0 = cm.sqrt(torch.clamp(u2[..., 0], min=0.0))
        b0 = 1.0 - su0
        b1 = u2[..., 1] * su0
        p_tri = (p0 + b1[..., None] * e1
                 + (1.0 - b0 - b1)[..., None] * e2)
        n_tri = cm.normalize(cm.cross(e1, e2))
        wi_t = p_tri - ref_p
        d2_t = cm.length_squared(wi_t)
        dist_t = cm.sqrt(torch.clamp(d2_t, min=1e-20))
        wi_tn = wi_t / dist_t[..., None]
        cos_l = cm.absdot(n_tri, wi_tn)
        pdf_t = d2_t / torch.clamp(cos_l * area, min=1e-12)
        pdf_t = torch.where(cos_l > 1e-7, pdf_t, 0.0)
        li_t = torch.where((cm.dot(n_tri, -wi_tn) > 0)[..., None], L, 0.0)
    else:
        p_tri = torch.zeros_like(ref_p)
        wi_tn = torch.zeros_like(ref_p)
        dist_t = pdf_t = zeros_r
        li_t = torch.zeros_like(ref_p)

    # ---- AREA_SPH: cone sampling from outside (sphere.cpp:Sample) ----
    if scene.sph_center.shape[0] > 0:
        sid = torch.where(kind == sb.LIGHT_AREA_SPH, prim, 0).long()
        c, r = scene.sph_center[sid], scene.sph_radius[sid]
        to_c = c - ref_p
        dc2 = cm.length_squared(to_c)
        dc = cm.sqrt(torch.clamp(dc2, min=1e-20))
        inside = dc2 <= r * r * 1.0001
        w = to_c / dc[..., None]
        wx, wy = cm.coordinate_system(w)
        sin2_tmax = torch.clamp(r * r / dc2, 0.0, 1.0)
        cos_tmax = cm.sqrt(torch.clamp(1.0 - sin2_tmax, min=0.0))
        cos_t = (1.0 - u2[..., 0]) + u2[..., 0] * cos_tmax
        sin_t = cm.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = u2[..., 1] * 2.0 * math.pi
        ds = dc * cos_t - cm.sqrt(
            torch.clamp(r * r - dc2 * sin_t * sin_t, min=0.0))
        cos_alpha = (dc2 + r * r - ds * ds) / torch.clamp(2.0 * dc * r,
                                                           min=1e-12)
        sin_alpha = cm.sqrt(torch.clamp(1.0 - cos_alpha ** 2, min=0.0))
        n_sph = -(
            sin_alpha[..., None] * torch.cos(phi)[..., None] * wx
            + sin_alpha[..., None] * torch.sin(phi)[..., None] * wy
            + cos_alpha[..., None] * w
        )
        p_sph = c + r[..., None] * n_sph
        wi_s = cm.normalize(p_sph - ref_p)
        pdf_s = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_tmax), min=1e-9)
        u_sph = _uniform_sphere(u2)
        p_in = c + r[..., None] * u_sph
        wi_in = cm.normalize(p_in - ref_p)
        d2_in = cm.length_squared(p_in - ref_p)
        cos_in = cm.absdot(u_sph, wi_in)
        pdf_in = d2_in / torch.clamp(cos_in * 4.0 * math.pi * r * r,
                                     min=1e-12)
        wi_sn = torch.where(inside[..., None], wi_in, wi_s)
        p_sphere = torch.where(inside[..., None], p_in, p_sph)
        pdf_sp = torch.where(inside, pdf_in, pdf_s)
        n_at = torch.where(inside[..., None], u_sph, n_sph)
        n_at = n_at * scene.sph_flip[sid][..., None]
        li_s = torch.where((cm.dot(n_at, -wi_sn) > 0)[..., None], L, 0.0)
        dist_s = cm.length(p_sphere - ref_p)
    else:
        p_sphere = torch.zeros_like(ref_p)
        wi_sn = torch.zeros_like(ref_p)
        dist_s = pdf_sp = zeros_r
        li_s = torch.zeros_like(ref_p)

    # ---- POINT / SPOT -----------------------------------------------
    to_p = pos - ref_p
    d2_p = torch.clamp(cm.length_squared(to_p), min=1e-20)
    dist_p = cm.sqrt(d2_p)
    wi_p = to_p / dist_p[..., None]
    li_p = L / d2_p[..., None]
    cos_spot = cm.dot(-wi_p, aux)
    cos_falloff, cos_total = par[..., 1], par[..., 0]
    delta = torch.clamp(
        (cos_spot - cos_total) / torch.clamp(cos_falloff - cos_total,
                                             min=1e-9), 0.0, 1.0)
    falloff = torch.where(
        cos_spot < cos_total, 0.0,
        torch.where(cos_spot > cos_falloff, 1.0, (delta * delta) ** 2))
    li_spot = li_p * falloff[..., None]

    # ---- DISTANT -----------------------------------------------------
    wi_d = pos  # stored direction toward light
    li_d = L
    dist_d = torch.full((R,), 2.0, device=ref_p.device) * scene.world_radius

    # ---- INFINITE (constant) -----------------------------------------
    uu, vv = u2[..., 0], u2[..., 1]
    theta = vv * math.pi
    phi_i = uu * 2.0 * math.pi
    st = torch.sin(theta)
    wi_inf = cm.spherical_direction(st, torch.cos(theta), phi_i)
    pdf_inf = torch.where(
        st > 1e-7,
        1.0 / (2.0 * math.pi * math.pi * torch.clamp(st, min=1e-7)), 0.0)
    dist_inf = dist_d

    # ---- Select per kind --------------------------------------------
    is_tri = kind == sb.LIGHT_AREA_TRI
    is_sph = kind == sb.LIGHT_AREA_SPH
    is_pt = kind == sb.LIGHT_POINT
    is_spot = kind == sb.LIGHT_SPOT
    is_dist = kind == sb.LIGHT_DISTANT
    is_inf = kind == sb.LIGHT_INFINITE
    is_pointlike = is_pt | is_spot

    wi = torch.where(is_tri[..., None], wi_tn, 0.0)
    wi = torch.where(is_sph[..., None], wi_sn, wi)
    wi = torch.where(is_pointlike[..., None], wi_p, wi)
    wi = torch.where(is_dist[..., None], wi_d, wi)
    wi = torch.where(is_inf[..., None], wi_inf, wi)

    pdf = torch.where(is_tri, pdf_t, 0.0)
    pdf = torch.where(is_sph, pdf_sp, pdf)
    pdf = torch.where(is_pointlike | is_dist, 1.0, pdf)
    pdf = torch.where(is_inf, pdf_inf, pdf)

    li = torch.where(is_tri[..., None], li_t, 0.0)
    li = torch.where(is_sph[..., None], li_s, li)
    li = torch.where(is_pt[..., None], li_p, li)
    li = torch.where(is_spot[..., None], li_spot, li)
    li = torch.where(is_dist[..., None], li_d, li)
    li = torch.where(is_inf[..., None], L, li)

    dist = torch.where(is_tri, dist_t, 0.0)
    dist = torch.where(is_sph, dist_s, dist)
    dist = torch.where(is_pointlike, dist_p, dist)
    dist = torch.where(is_dist, dist_d, dist)
    dist = torch.where(is_inf, dist_inf, dist)

    p_l = torch.where(is_tri[..., None], p_tri, ref_p + wi * dist[..., None])
    p_l = torch.where(is_sph[..., None], p_sphere, p_l)

    return LightSample(wi=wi, pdf=pdf, li=li, p_light=p_l, dist=dist,
                       is_delta=is_pointlike | is_dist)


def _uniform_sphere(u2):
    z = 1.0 - 2.0 * u2[..., 0]
    r = cm.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def pdf_li(scene: sb.SceneTables, light_id, ref_p, wi, hit_p, hit_ng,
           hit_valid):
    """Solid-angle pdf of sampling `wi` from light `light_id` given that a
    BSDF-sampled ray hit it at hit_p (Light::Pdf_Li)."""
    kind, _, prim, _, _, _, area = _light_rows(scene, light_id)

    d2 = cm.length_squared(hit_p - ref_p)
    cos_l = cm.absdot(hit_ng, wi)
    pdf_area = torch.where(
        cos_l > 1e-7, d2 / torch.clamp(cos_l * area, min=1e-12), 0.0)

    if scene.sph_center.shape[0] > 0:
        sid = torch.where(kind == sb.LIGHT_AREA_SPH, prim, 0).long()
        c, r = scene.sph_center[sid], scene.sph_radius[sid]
        dc2 = cm.length_squared(c - ref_p)
        inside = dc2 <= r * r * 1.0001
        sin2_tmax = torch.clamp(r * r / torch.clamp(dc2, min=1e-20), 0.0, 1.0)
        cos_tmax = cm.sqrt(torch.clamp(1.0 - sin2_tmax, min=0.0))
        pdf_cone = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_tmax),
                                     min=1e-9)
        pdf_sph = torch.where(inside, pdf_area, pdf_cone)
    else:
        pdf_sph = torch.zeros_like(pdf_area)

    theta = torch.arccos(torch.clamp(wi[..., 2], -1.0, 1.0))
    st = torch.sin(theta)
    pdf_inf = torch.where(
        st > 1e-7,
        1.0 / (2.0 * math.pi * math.pi * torch.clamp(st, min=1e-7)), 0.0)

    pdf = torch.where(kind == sb.LIGHT_AREA_TRI, pdf_area, 0.0)
    pdf = torch.where(kind == sb.LIGHT_AREA_SPH, pdf_sph, pdf)
    pdf = torch.where(kind == sb.LIGHT_INFINITE, pdf_inf, pdf)
    return pdf


def escaped_radiance(scene: sb.SceneTables, d):
    """Sum of the (constant) infinite lights' Le for escaped rays."""
    out = torch.zeros(d.shape[:-1] + (3,), device=d.device)
    if scene.light_kind.shape[0] == 0:
        return out
    inf_mask = scene.light_kind == sb.LIGHT_INFINITE
    total = torch.sum(torch.where(inf_mask[:, None], scene.light_L, 0.0),
                      dim=0)
    return out + total


def area_light_le(scene: sb.SceneTables, light_id, ng, w):
    """Emitted radiance of an area light hit by a ray going `w` FROM the
    surface toward the viewer (DiffuseAreaLight::L)."""
    L = scene.light_L[torch.clamp(light_id, min=0).long()]
    emit = (light_id >= 0) & (cm.dot(ng, w) > 0)
    return torch.where(emit[..., None], L, 0.0)
