"""Light sampling over lanes (port of statmc_tpu/render/lights.py).

Every emissive triangle is its own light, spheres use cone sampling from
outside points, and all light kinds are evaluated branchlessly and
selected per lane with ``torch.where``.  The goniometric/projection block
runs only for scenes with such lights and the environment-map branches
only for a scene with a map (host decisions, as in the JAX package);
those run in ``lights.env_map`` spans (spans.py).

The environment map's conditional search does not gather a CDF row per
lane (2^20 lanes x a 2048-wide row would be 8.6 GB): every row's CDF
values, as int32 bit patterns (monotone for non-negative floats), are
offset by row * 2^31 into one sorted int64 table, so one searchsorted of
``bits(u) + vrow * 2^31`` finds the column with the comparisons the JAX
package's per-row search makes.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import spans
from ..core import math as cm
from ..scene import build as sb
from ..scene.textures import KIND_IMAGE, sample_texture


def _light_rows(scene: sb.SceneTables, light_id):
    lid = light_id.long()
    return (scene.light_kind[lid], scene.light_L[lid],
            scene.light_prim[lid], scene.light_pos[lid],
            scene.light_aux[lid], scene.light_params[lid],
            scene.light_area[lid])


def _env_sample(scene: sb.SceneTables, u2):
    """Importance-sample the environment map's Distribution2D: (row,
    column) per lane, equal to the JAX package's searchsorted (side
    "right") over the marginal CDF, then over the row's conditional CDF,
    each clamped to the last index."""
    He, We = scene.env_cond_cdf.shape
    marg = scene.env_marginal_cdf
    vrow = torch.clamp(torch.searchsorted(marg, u2[..., 1].contiguous(),
                                          right=True), max=He - 1)
    rows = torch.arange(He, dtype=torch.int64, device=u2.device) << 31
    keys = (scene.env_cond_cdf.view(torch.int32).long()
            + rows[:, None]).reshape(-1)
    u = torch.clamp(u2[..., 0], min=0.0) + 0.0  # -0.0 -> +0.0
    q = u.contiguous().view(torch.int32).long() + (vrow << 31)
    ucol = torch.searchsorted(keys, q, right=True) - vrow * We
    return vrow, torch.clamp(ucol, max=We - 1)


def _env_texel(scene: sb.SceneTables, w):
    """Equirect (row, column) of light-space direction w, and its theta
    (infinite.cpp:Le / Pdf_Li)."""
    theta = torch.arccos(torch.clamp(w[..., 2], -1.0, 1.0))
    phi = torch.atan2(w[..., 1], w[..., 0])
    uu = torch.remainder(phi / (2 * math.pi), 1.0)
    vv = torch.clamp(theta / math.pi, 0.0, 1.0 - 1e-6)
    He, We = scene.env_map.shape[:2]
    vrow = torch.clamp((vv * He).to(torch.int64), 0, He - 1)
    ucol = torch.clamp((uu * We).to(torch.int64), 0, We - 1)
    return vrow, ucol, theta


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

    # ---- GONIOMETRIC / PROJECTION (image-modulated point lights) -----
    # lights/goniometric.cpp:Scale and lights/projection.cpp:Projection:
    # the outgoing direction in light space indexes an intensity image.
    image_lights = scene.has_image_lights  # any goniometric/projection light
    if image_lights:
        lid = light_id.long()
        w2l = scene.light_w2l[lid].reshape((-1, 3, 3))
        tex_id = scene.light_tex[lid]
        w_out = torch.sum(w2l * (-wi_p)[:, None, :], dim=-1)
        # Goniometric: lights/goniometric.h:70-71 swaps (y, z) before
        # SphericalTheta/SphericalPhi; v is pre-flipped to undo the row
        # flip of sample_texture's imagemap path.
        theta = torch.arccos(torch.clamp(w_out[..., 1], -1.0, 1.0))
        phi_g = torch.atan2(w_out[..., 2], w_out[..., 0])
        phi_g = torch.where(phi_g < 0, phi_g + 2 * math.pi, phi_g)
        uv_g = torch.stack([phi_g / (2 * math.pi), 1.0 - theta / math.pi],
                           dim=-1)
        # Projection: perspective divide onto the fov screen window.
        tan_half = torch.clamp(par[..., 0], min=1e-6)
        aspect = torch.clamp(par[..., 1], min=1e-6)
        zl = w_out[..., 2]
        safe_z = torch.where(torch.abs(zl) > 1e-6, zl, 1.0)
        sx = w_out[..., 0] / (safe_z * tan_half)
        sy = w_out[..., 1] / (safe_z * tan_half)
        sw = torch.where(aspect > 1.0, aspect, 1.0)
        sh = torch.where(aspect > 1.0, 1.0, 1.0 / aspect)
        u_pr = (sx / sw + 1.0) * 0.5
        v_pr = (sy / sh + 1.0) * 0.5
        in_frustum = ((zl > 1e-3) & (u_pr >= 0) & (u_pr <= 1)
                      & (v_pr >= 0) & (v_pr <= 1))
        # Both lookups as one call over 2R lanes.  A light's texture is
        # always an image row (scene/build.py add_image), so the lookup
        # evaluates that kind alone: every lane's value is unchanged.
        images = scene.textures._replace(kinds_static=(KIND_IMAGE,),
                                         has_children=False)
        gain = sample_texture(
            images, torch.cat([tex_id, tex_id]),
            torch.cat([uv_g, torch.stack([u_pr, v_pr], dim=-1)]))
        has_tex = (tex_id >= 0)[..., None]
        li_gonio = li_p * torch.where(has_tex, gain[:R], 1.0)
        gain_p = torch.where(has_tex, gain[R:], 1.0)
        li_proj = li_p * torch.where(in_frustum[..., None], gain_p, 0.0)

    # ---- DISTANT -----------------------------------------------------
    wi_d = pos  # stored direction toward light
    li_d = L
    dist_d = torch.full((R,), 2.0, device=ref_p.device) * scene.world_radius

    # ---- INFINITE ----------------------------------------------------
    # pdf = map_pdf / (2 pi^2 sin(theta)) (lights/infinite.cpp:Sample_Li);
    # with an environment image the (u,v) draw importance-samples the
    # luminance*sin(theta) Distribution2D, else map_pdf = 1.
    has_env = scene.env_light_id >= 0
    if has_env:
        with spans.span("lights.env_map"):
            He, We = scene.env_map.shape[:2]
            vrow, ucol = _env_sample(scene, u2)
            uu = (ucol.to(torch.float32) + 0.5) / We
            vv = (vrow.to(torch.float32) + 0.5) / He
            map_pdf = scene.env_pdf_uv[vrow, ucol]
            li_inf = scene.env_map[vrow, ucol]
    else:
        uu, vv = u2[..., 0], u2[..., 1]
        map_pdf = 1.0
        li_inf = L
    theta = vv * math.pi
    phi_i = uu * 2.0 * math.pi
    st = torch.sin(theta)
    wi_inf = cm.spherical_direction(st, torch.cos(theta), phi_i)
    if has_env:
        with spans.span("lights.env_map"):
            # Light-to-world: invert the stored world-to-light transform.
            l2w = torch.linalg.inv_ex(scene.env_world_to_light)[0]
            wi_inf = cm.transform_vector(l2w, wi_inf)
    pdf_inf = torch.where(
        st > 1e-7,
        map_pdf / (2.0 * math.pi * math.pi * torch.clamp(st, min=1e-7)),
        0.0)
    dist_inf = dist_d

    # ---- Select per kind --------------------------------------------
    is_tri = kind == sb.LIGHT_AREA_TRI
    is_sph = kind == sb.LIGHT_AREA_SPH
    is_pt = kind == sb.LIGHT_POINT
    is_spot = kind == sb.LIGHT_SPOT
    is_dist = kind == sb.LIGHT_DISTANT
    is_inf = kind == sb.LIGHT_INFINITE
    is_pointlike = is_pt | is_spot
    if image_lights:
        is_gonio = kind == sb.LIGHT_GONIO
        is_proj = kind == sb.LIGHT_PROJ
        is_pointlike = is_pointlike | is_gonio | is_proj

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
    if image_lights:
        li = torch.where(is_gonio[..., None], li_gonio, li)
        li = torch.where(is_proj[..., None], li_proj, li)
    li = torch.where(is_dist[..., None], li_d, li)
    li = torch.where(is_inf[..., None], li_inf, li)

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

    # Infinite light: direction -> (u,v) -> map pdf (infinite.cpp:Pdf_Li).
    if scene.env_light_id >= 0:
        with spans.span("lights.env_map"):
            vrow, ucol, theta = _env_texel(
                scene, cm.transform_vector(scene.env_world_to_light, wi))
            map_pdf = scene.env_pdf_uv[vrow, ucol]
    else:
        theta = torch.arccos(torch.clamp(wi[..., 2], -1.0, 1.0))
        map_pdf = 1.0
    st = torch.sin(theta)
    pdf_inf = torch.where(
        st > 1e-7,
        map_pdf / (2.0 * math.pi * math.pi * torch.clamp(st, min=1e-7)),
        0.0)

    pdf = torch.where(kind == sb.LIGHT_AREA_TRI, pdf_area, 0.0)
    pdf = torch.where(kind == sb.LIGHT_AREA_SPH, pdf_sph, pdf)
    pdf = torch.where(kind == sb.LIGHT_INFINITE, pdf_inf, pdf)
    return pdf


def escaped_radiance(scene: sb.SceneTables, d):
    """Sum of the infinite lights' Le for escaped rays
    (InfiniteAreaLight::Le: equirect map lookup by direction)."""
    out = torch.zeros(d.shape[:-1] + (3,), device=d.device)
    if scene.light_kind.shape[0] == 0:
        return out
    inf_mask = scene.light_kind == sb.LIGHT_INFINITE
    total = torch.sum(torch.where(inf_mask[:, None], scene.light_L, 0.0),
                      dim=0)
    out = out + total
    if scene.env_light_id >= 0:
        with spans.span("lights.env_map"):
            vrow, ucol, _ = _env_texel(scene, cm.transform_vector(
                scene.env_world_to_light, cm.normalize(d)))
            # The map light's L is 1 in `total` (folded into the map).
            out = out - 1.0 + scene.env_map[vrow, ucol]
    return out


def area_light_le(scene: sb.SceneTables, light_id, ng, w):
    """Emitted radiance of an area light hit by a ray going `w` FROM the
    surface toward the viewer (DiffuseAreaLight::L)."""
    L = scene.light_L[torch.clamp(light_id, min=0).long()]
    emit = (light_id >= 0) & (cm.dot(ng, w) > 0)
    return torch.where(emit[..., None], L, 0.0)
