"""Vectorized BSDF lobes + per-lane material dispatch (port of
statmc_tpu/render/bsdf.py).

Every function maps over [R] lanes in the local shading frame (z =
shading normal); the material families are evaluated branchlessly and
selected per lane by type id; a textured Kd is looked up per lane
(scene/textures.py).  Ported families: matte, plastic, metal,
substrate, uber, translucent, mirror, glass (smooth and rough), disney,
hair (the Marschner model of render/hair.py on lanes with a width
offset, else the fallback lobe pair) and kdsubsurface/subsurface (their
FresnelSpecular interface when the scene has BSSRDF tables; the
integrator's SSS block takes the transmitted lanes) and fourier (a
tabulated .bsdf through render/fourier.py on the lanes with a table, the
substrate pair on those without).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import spans
from ..core import math as cm
from ..scene import build as sb
from ..scene.textures import sample_texture
from . import fourier, hair

INV_PI = 1.0 / math.pi


class ShadingFrame(NamedTuple):
    t: Any  # tangent
    b: Any  # bitangent
    n: Any  # shading normal

    @staticmethod
    def from_normal(n):
        t, b = cm.coordinate_system(n)
        return ShadingFrame(t, b, n)

    def to_local(self, w):
        return torch.stack(
            [cm.dot(w, self.t), cm.dot(w, self.b), cm.dot(w, self.n)], dim=-1)

    def to_world(self, w):
        return (w[..., 0:1] * self.t + w[..., 1:2] * self.b
                + w[..., 2:3] * self.n)


class MaterialLanes(NamedTuple):
    """Per-lane material parameters gathered from the scene tables."""
    mat_type: Any
    kd: Any
    ks: Any
    kr: Any
    kt: Any
    eta: Any
    k: Any
    rough_u: Any
    rough_v: Any
    sigma: Any
    # Hair: the width offset h = -1 + 2 v (hair.cpp:221) per lane; None
    # (no hair in the scene, or no uv) keeps hair lanes on the fallback
    # lobe pair and runs no Marschner code.
    hair_h: Any = None
    # BSSRDF: the SSS table index per lane; None when the scene has no
    # subsurface tables.  When set, kdsubsurface/subsurface lanes expose
    # the Kr/Kt FresnelSpecular interface (kdsubsurface.cpp:70-74).
    sss_id: Any = None
    # FourierBSDF: the table index per lane (-1: no readable .bsdf, the
    # substrate fallback) and the scene's stacked tables; both None when
    # the scene has no tables, and then no Fourier code runs.
    fourier_id: Any = None
    fourier_tab: Any = None


def gather_materials(scene: sb.SceneTables, mat_id, uv=None, p=None,
                     uv_fp=None, uv_axes=None) -> MaterialLanes:
    """Per-lane material rows.  With uv given and a textured scene, Kd is
    multiplied by its texture's value at (uv, p), filtered by the
    footprint uv_fp (trilinear) or uv_axes (EWA); untextured lanes sample
    1 and keep their Kd bit for bit, and an untextured scene runs no
    lookup at all.  With uv given in a hair scene, hair_h comes from the
    ribbon's v coordinate (scene/tessellate.py curve(): v in {0, 1}
    across the strip).  A scene with Fourier tables gets each lane's table
    index."""
    m = mat_id.long()
    kd = scene.mat_kd[m]
    if uv is not None and scene.has_textures:
        kd = kd * sample_texture(scene.textures, scene.mat_kd_tex[m], uv, p,
                                 uv_fp, uv_axes=uv_axes)
    hair_h = None
    if uv is not None and sb.scene_has_hair(scene):
        hair_h = torch.clamp(-1.0 + 2.0 * uv[..., 1], -0.999, 0.999)
    return MaterialLanes(
        mat_type=scene.mat_type[m], kd=kd, ks=scene.mat_ks[m],
        kr=scene.mat_kr[m], kt=scene.mat_kt[m], eta=scene.mat_eta[m],
        k=scene.mat_k[m], rough_u=scene.mat_rough_u[m],
        rough_v=scene.mat_rough_v[m], sigma=scene.mat_sigma[m],
        hair_h=hair_h,
        sss_id=scene.mat_sss_id[m] if scene.has_sss else None,
        fourier_id=(None if scene.fourier is None
                    else scene.mat_fourier_id[m]),
        fourier_tab=scene.fourier)


def _hair_lanes(m: MaterialLanes):
    """MaterialLanes slots -> HairLanes (scene/build.py MAT_HAIR: kt =
    sigma_a, sigma = beta_m, rough_u = beta_n, rough_v = alpha)."""
    return hair.HairLanes(h=m.hair_h, eta=m.eta[..., 0], sigma_a=m.kt,
                          beta_m=m.sigma, beta_n=m.rough_u,
                          alpha=m.rough_v)


def sss_interface(m: MaterialLanes):
    """Lanes whose surface BSDF is the subsurface dielectric interface
    (FresnelSpecular, kdsubsurface.cpp:70-74 / subsurface.cpp:74-76);
    None when the scene has no BSSRDF tables.  Rough interfaces keep the
    smooth lobe pair (scene/build.py)."""
    if m.sss_id is None:
        return None
    return (((m.mat_type == sb.MAT_KDSUBSURFACE)
             | (m.mat_type == sb.MAT_SUBSURFACE)) & (m.sss_id >= 0))


def is_specular(m: MaterialLanes):
    """Lanes whose material has only delta lobes (mirror, smooth glass,
    the subsurface FresnelSpecular interface)."""
    smooth_glass = (m.mat_type == sb.MAT_GLASS) & (m.rough_u < 1e-4)
    out = (m.mat_type == sb.MAT_MIRROR) | smooth_glass
    sssl = sss_interface(m)
    return out if sssl is None else out | sssl


# --------------------------------------------------------------------------
# Local-frame helpers (reflection.h)
# --------------------------------------------------------------------------

def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0


def reflect_local(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def cosine_sample_hemisphere(u):
    """Concentric-disk cosine sampling (sampling.h)."""
    uo = 2.0 * u - 1.0
    zero = (torch.abs(uo[..., 0]) < 1e-12) & (torch.abs(uo[..., 1]) < 1e-12)
    big = torch.abs(uo[..., 0]) > torch.abs(uo[..., 1])
    r = torch.where(big, uo[..., 0], uo[..., 1])
    theta = torch.where(
        big,
        (math.pi / 4) * (uo[..., 1] / torch.where(big, uo[..., 0], 1.0)),
        (math.pi / 2)
        - (math.pi / 4) * (uo[..., 0] / torch.where(big, 1.0, uo[..., 1])),
    )
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    z = cm.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


# --------------------------------------------------------------------------
# Fresnel (reflection.cpp:FrDielectric / FrConductor)
# --------------------------------------------------------------------------

def _t(x, like):
    """Python scalar or tensor -> tensor on `like`'s device."""
    return x if torch.is_tensor(x) else torch.full_like(like, x)


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized Fresnel for dielectrics; cos_i may be signed."""
    entering = cos_i > 0
    eta_i, eta_t = _t(eta_i, cos_i), _t(eta_t, cos_i)
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(torch.clamp(cos_i, -1.0, 1.0))
    sin_t = ei / et * cm.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    tir = sin_t >= 1.0
    ct = cm.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-12)
    r_per = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-12)
    f = 0.5 * (r_par * r_par + r_per * r_per)
    return torch.where(tir, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """reflection.cpp:FrConductor (eta/k are [...,3] RGB)."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    c2 = ci * ci
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = cm.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + c2
    a = cm.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)


def _pow5(x):
    """x**5 in the multiplication order of jax.lax.integer_pow."""
    x2 = x * x
    return x * (x2 * x2)


def schlick_fresnel(rs, cos_t):
    p = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    return rs + _pow5(p)[..., None] * (1.0 - rs)


# --------------------------------------------------------------------------
# Trowbridge-Reitz (GGX) microfacet distribution (microfacet.cpp)
# --------------------------------------------------------------------------

def tr_d(wh, ax, ay):
    c2 = wh[..., 2] * wh[..., 2]
    e = (wh[..., 0] ** 2 / (ax * ax) + wh[..., 1] ** 2 / (ay * ay))
    denom_e = c2 + e
    d = 1.0 / (math.pi * ax * ay * denom_e * denom_e)
    return torch.where(denom_e > 1e-16, d, 0.0)


def tr_lambda(w, ax, ay):
    c = torch.abs(w[..., 2])
    inv_c2 = 1.0 / torch.clamp(c * c, min=1e-12)
    a2t2 = (ax * ax * w[..., 0] ** 2 + ay * ay * w[..., 1] ** 2) * inv_c2
    return 0.5 * (-1.0 + cm.sqrt(1.0 + a2t2))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_sample_wh(wo, u, ax, ay):
    """Sample D(wh) cos(wh) (pbrt's non-visible branch,
    microfacet.cpp:271-287); pdf_wh = D(wh)|cos wh|."""
    phi = torch.atan2(
        ay * torch.sin(2 * math.pi * u[..., 1] + 0.5 * math.pi),
        ax * torch.cos(2 * math.pi * u[..., 1] + 0.5 * math.pi),
    )
    iso = torch.abs(ax - ay) < 1e-7
    phi = torch.where(iso, u[..., 1] * 2 * math.pi, phi)
    cp, sp = torch.cos(phi), torch.sin(phi)
    alpha2 = 1.0 / torch.clamp(
        cp * cp / torch.clamp(ax * ax, min=1e-12)
        + sp * sp / torch.clamp(ay * ay, min=1e-12), min=1e-12)
    alpha2 = torch.where(iso, ax * ax, alpha2)
    t2 = alpha2 * u[..., 0] / torch.clamp(1.0 - u[..., 0], min=1e-9)
    ct = 1.0 / cm.sqrt(1.0 + t2)
    st = cm.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    wh = cm.spherical_direction(st, ct, phi)
    return torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def tr_pdf_wh(wh, ax, ay):
    return tr_d(wh, ax, ay) * torch.abs(wh[..., 2])


# --------------------------------------------------------------------------
# Lobe evaluations (f and pdf given wo, wi in local frame)
# --------------------------------------------------------------------------

def _oren_nayar_f(kd, sigma_deg, wo, wi):
    """reflection.cpp:OrenNayar::f."""
    sigma = torch.deg2rad(sigma_deg)
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    sin_to = cm.sqrt(torch.clamp(1.0 - wo[..., 2] ** 2, min=0.0))
    sin_ti = cm.sqrt(torch.clamp(1.0 - wi[..., 2] ** 2, min=0.0))
    cos_pi = torch.where(sin_ti > 1e-4,
                         wi[..., 0] / torch.clamp(sin_ti, min=1e-7), 1.0)
    sin_pi = torch.where(sin_ti > 1e-4,
                         wi[..., 1] / torch.clamp(sin_ti, min=1e-7), 0.0)
    cos_po = torch.where(sin_to > 1e-4,
                         wo[..., 0] / torch.clamp(sin_to, min=1e-7), 1.0)
    sin_po = torch.where(sin_to > 1e-4,
                         wo[..., 1] / torch.clamp(sin_to, min=1e-7), 0.0)
    d_cos = torch.clamp(cos_pi * cos_po + sin_pi * sin_po, min=0.0)
    abs_ci = torch.abs(wi[..., 2])
    abs_co = torch.abs(wo[..., 2])
    big = abs_ci > abs_co
    sin_a = torch.where(big, sin_to, sin_ti)
    tan_b = torch.where(
        big,
        sin_ti / torch.clamp(abs_ci, min=1e-7),
        sin_to / torch.clamp(abs_co, min=1e-7),
    )
    return kd * (INV_PI * (A + B * d_cos * sin_a * tan_b))[..., None]


def _microfacet_reflection_f(wo, wi, ax, ay, F):
    """MicrofacetReflection::f with precomputed Fresnel F [...,3]."""
    co, ci = abs_cos_theta(wo), abs_cos_theta(wi)
    wh = wo + wi
    degenerate = (ci < 1e-7) | (co < 1e-7) | (torch.sum(wh * wh, -1) < 1e-14)
    wh = cm.normalize(wh)
    d = tr_d(wh, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    f = F * (d * g / torch.clamp(4.0 * ci * co, min=1e-7))[..., None]
    return torch.where(degenerate[..., None], 0.0, f)


def _microfacet_pdf(wo, wi, ax, ay):
    wh = cm.normalize(wo + wi)
    pdf_wh = tr_pdf_wh(wh, ax, ay)
    pdf = pdf_wh / torch.clamp(4.0 * torch.abs(cm.dot(wo, wh)), min=1e-7)
    ok = same_hemisphere(wo, wi) & (torch.sum((wo + wi) ** 2, -1) > 1e-14)
    return torch.where(ok, pdf, 0.0)


def _microfacet_transmission_f(wo, wi, ax, ay, kt, eta_mat):
    """MicrofacetTransmission::f (reflection.cpp), radiance mode."""
    same = same_hemisphere(wo, wi)
    co = cos_theta(wo)
    ci = cos_theta(wi)
    eta = torch.where(co > 0, eta_mat, 1.0 / eta_mat)
    wh = cm.normalize(wo + wi * eta[..., None])
    wh = torch.where((wh[..., 2] < 0)[..., None], -wh, wh)
    wo_dot_wh = cm.dot(wo, wh)
    wi_dot_wh = cm.dot(wi, wh)
    valid = ~same & (wo_dot_wh * wi_dot_wh < 0) \
        & (torch.abs(co) > 1e-7) & (torch.abs(ci) > 1e-7)
    F = fresnel_dielectric(wo_dot_wh, 1.0, eta_mat)
    d = tr_d(wh, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    sqrt_denom = wo_dot_wh + eta * wi_dot_wh
    factor = 1.0 / eta
    denom = ci * co * sqrt_denom * sqrt_denom
    denom = torch.sign(denom) * torch.clamp(torch.abs(denom), min=1e-9)
    f = kt * ((1.0 - F) * torch.abs(
        d * g * eta * eta * torch.abs(wi_dot_wh) * torch.abs(wo_dot_wh)
        * factor * factor / denom))[..., None]
    return torch.where(valid[..., None], f, 0.0)


def _microfacet_transmission_pdf(wo, wi, ax, ay, eta_mat):
    same = same_hemisphere(wo, wi)
    co = cos_theta(wo)
    eta = torch.where(co > 0, eta_mat, 1.0 / eta_mat)
    wh = cm.normalize(wo + wi * eta[..., None])
    wh = torch.where((wh[..., 2] < 0)[..., None], -wh, wh)
    wo_dot_wh = cm.dot(wo, wh)
    wi_dot_wh = cm.dot(wi, wh)
    valid = ~same & (wo_dot_wh * wi_dot_wh < 0)
    sqrt_denom = wo_dot_wh + eta * wi_dot_wh
    dwh_dwi = torch.abs(eta * eta * wi_dot_wh
                        / torch.clamp(sqrt_denom * sqrt_denom, min=1e-12))
    pdf = tr_pdf_wh(wh, ax, ay) * dwh_dwi
    return torch.where(valid, pdf, 0.0)


def _fresnel_blend_f(kd, ks, wo, wi, ax, ay):
    """FresnelBlend::f (reflection.cpp, Ashikhmin-Shirley)."""
    co, ci = abs_cos_theta(wo), abs_cos_theta(wi)

    def pow5(v):
        return _pow5(1.0 - v)

    diffuse = ((28.0 / (23.0 * math.pi)) * kd * (1.0 - ks)
               * ((1.0 - pow5(ci * 0.5)) * (1.0 - pow5(co * 0.5)))[..., None])
    wh = wo + wi
    degenerate = torch.sum(wh * wh, -1) < 1e-14
    wh = cm.normalize(wh)
    d = tr_d(wh, ax, ay)
    spec = (d / torch.clamp(
        4.0 * torch.abs(cm.dot(wi, wh)) * torch.maximum(ci, co), min=1e-7)
    )[..., None] * schlick_fresnel(ks, cm.dot(wi, wh))
    spec = torch.where(degenerate[..., None], 0.0, spec)
    return diffuse + spec


# --------------------------------------------------------------------------
# Material dispatch: evaluate / sample over lanes
# --------------------------------------------------------------------------

# Families that take the plastic lobe pair where they are not the BSSRDF
# interface.
_PLASTIC_LIKE = (sb.MAT_KDSUBSURFACE, sb.MAT_SUBSURFACE)


def _has(present, *types) -> bool:
    """Whether any of `types` can occur among the lanes: `present` is the
    set of material types of the scene's tables (None: any type)."""
    return present is None or not present.isdisjoint(types)


def _fourier_lanes(m: MaterialLanes, present):
    """The indices of the lanes whose material is a Fourier table, or
    None when there are none (the scene has no tables, or no lane holds
    one).  The table functions run on these lanes only, where the JAX
    package runs them over all lanes and selects; they are per lane, so
    each lane's result is the same."""
    if m.fourier_tab is None or not _has(present, sb.MAT_FOURIER):
        return None
    lanes = torch.nonzero((m.mat_type == sb.MAT_FOURIER)
                          & (m.fourier_id >= 0))[:, 0]
    return lanes if lanes.numel() else None


def evaluate(m: MaterialLanes, wo, wi, present=None):
    """(f [R,3], pdf [R]) of the non-delta lobes; zero for delta
    materials (BSDF::f + BSDF::Pdf over BSDF_ALL & ~BSDF_SPECULAR).
    `present` (a set of MAT_* or None) skips the families no lane can
    have; the lanes' values are the same either way."""
    refl = same_hemisphere(wo, wi)
    ax = torch.clamp(m.rough_u, min=1e-3)
    ay = torch.clamp(m.rough_v, min=1e-3)
    ci = abs_cos_theta(wi)
    lam_pdf = torch.where(refl, ci * INV_PI, 0.0)
    fams = []  # (type, f, pdf) of the families that can occur

    if _has(present, sb.MAT_MATTE, sb.MAT_TRANSLUCENT):
        lam_f = m.kd * INV_PI
        on_f = _oren_nayar_f(m.kd, m.sigma, wo, wi)
        matte_f = torch.where((m.sigma > 0)[..., None], on_f, lam_f)
        fams += [(sb.MAT_MATTE, matte_f, lam_pdf),
                 (sb.MAT_TRANSLUCENT, matte_f, lam_pdf)]

    if _has(present, sb.MAT_METAL, sb.MAT_PLASTIC, sb.MAT_UBER,
            sb.MAT_SUBSTRATE, sb.MAT_FOURIER, sb.MAT_DISNEY, sb.MAT_GLASS,
            *_PLASTIC_LIKE, sb.MAT_HAIR):
        mf_pdf = _microfacet_pdf(wo, wi, ax, ay)
    if _has(present, sb.MAT_PLASTIC, sb.MAT_UBER, sb.MAT_DISNEY,
            sb.MAT_GLASS, *_PLASTIC_LIKE):
        wh = cm.normalize(wo + wi)

    if _has(present, sb.MAT_DISNEY):
        # Disney principled (materials/disney.cpp, main lobes); metallic
        # rides the sigma slot.
        metallic = torch.clamp(m.sigma, 0.0, 1.0)[..., None]
        rough_lin = cm.sqrt(ax)[..., None]
        cosd = cm.dot(wi, wh)
        co_a = torch.clamp(abs_cos_theta(wo), min=1e-7)
        ci_a = torch.clamp(ci, min=1e-7)
        fl = _pow5(1.0 - ci_a)
        fv = _pow5(1.0 - co_a)
        fd90 = (0.5 + 2.0 * rough_lin * (cosd ** 2)[..., None])
        burley = m.kd * INV_PI * (1.0 + (fd90 - 1.0) * fl[..., None]) \
            * (1.0 + (fd90 - 1.0) * fv[..., None])
        f0 = 0.04 * (1.0 - metallic) + m.kd * metallic
        f_schlick = f0 + (1.0 - f0) * _pow5(1.0 - torch.abs(cosd))[..., None]
        disney_spec = _microfacet_reflection_f(wo, wi, ax, ay, f_schlick)
        disney_f = (1.0 - metallic) * burley + disney_spec
        fams.append((sb.MAT_DISNEY, disney_f, 0.5 * (lam_pdf + mf_pdf)))

    if _has(present, sb.MAT_PLASTIC, sb.MAT_UBER, *_PLASTIC_LIKE):
        F_diel = fresnel_dielectric(cm.dot(wi, wh), 1.0, 1.5)[..., None]
        plastic_spec = _microfacet_reflection_f(wo, wi, ax, ay,
                                                F_diel * m.ks)
        plastic_f = m.kd * INV_PI + plastic_spec
        plastic_pdf = 0.5 * (lam_pdf + mf_pdf)
        # kdsubsurface/subsurface lanes outside the BSSRDF transport
        # (no tables, as in the albedo curves) take the plastic pair.
        fams += [(mt, plastic_f, plastic_pdf)
                 for mt in (sb.MAT_PLASTIC, sb.MAT_UBER)]
        fams += [(mt, plastic_f, plastic_pdf) for mt in _PLASTIC_LIKE
                 if _has(present, mt)]

    if _has(present, sb.MAT_METAL):
        F_cond = fresnel_conductor(cos_theta(wi), m.eta, m.k)
        metal_f = _microfacet_reflection_f(wo, wi, ax, ay, F_cond)
        fams.append((sb.MAT_METAL, metal_f, mf_pdf))

    if _has(present, sb.MAT_SUBSTRATE, sb.MAT_FOURIER):
        # Fourier lanes without a table keep the substrate pair.
        substrate_f = _fresnel_blend_f(m.kd, m.ks, wo, wi, ax, ay)
        substrate_pdf = 0.5 * (lam_pdf + mf_pdf)
        fams += [(mt, substrate_f, substrate_pdf)
                 for mt in (sb.MAT_SUBSTRATE, sb.MAT_FOURIER)
                 if _has(present, mt)]

    if _has(present, sb.MAT_HAIR):
        # The fallback lobe pair (lanes without a width offset): an
        # absorption-coloured diffuse base + a broad glossy lobe.
        hair_f = m.kd * INV_PI + _microfacet_reflection_f(
            wo, wi, ax, ay, m.ks.expand(m.kd.shape))
        fams.append((sb.MAT_HAIR, hair_f, 0.5 * (lam_pdf + mf_pdf)))

    t = m.mat_type
    f = torch.zeros_like(m.kd)
    pdf = torch.zeros_like(ci)
    for mt, ff, pp in fams:
        sel = t == mt
        f = torch.where(sel[..., None], ff, f)
        pdf = torch.where(sel, pp, pdf)
    f = torch.where(refl[..., None], f, 0.0)
    pdf = torch.where(refl, pdf, 0.0)

    ft = _fourier_lanes(m, present)
    if ft is not None:
        # The table's f and pdf (reflection.cpp:322-427) on its lanes,
        # after the reflection mask: the table encodes its own sidedness,
        # transmission included.
        fid, wo_f, wi_f = m.fourier_id[ft], wo[ft], wi[ft]
        f = f.index_put((ft,), fourier.eval_f(m.fourier_tab, fid, wo_f,
                                              wi_f))
        pdf = pdf.index_put((ft,), fourier.pdf_wi(m.fourier_tab, fid, wo_f,
                                                  wi_f))

    if m.hair_h is not None and _has(present, sb.MAT_HAIR):
        # The Marschner model overrides the fallback pair on hair lanes;
        # after the reflection mask, since hair scatters into the whole
        # sphere (hair.cpp:418-480, 602-664).
        with spans.span("hair.eval_f"):
            f_h, pdf_h = hair.eval_f_pdf(_hair_lanes(m), wo, wi)
            sel = t == sb.MAT_HAIR
            f = torch.where(sel[..., None], f_h, f)
            pdf = torch.where(sel, pdf_h, pdf)

    if _has(present, sb.MAT_GLASS):
        # Rough glass: microfacet reflection + transmission.
        rough_glass = (t == sb.MAT_GLASS) & (m.rough_u >= 1e-4)
        eta0 = m.eta[..., 0]
        F_wh = fresnel_dielectric(cm.dot(wi, wh), 1.0, eta0)[..., None]
        rg_refl = _microfacet_reflection_f(wo, wi, ax, ay, F_wh * m.kr)
        rg_refl = torch.where(refl[..., None], rg_refl, 0.0)
        rg_trans = _microfacet_transmission_f(wo, wi, ax, ay, m.kt, eta0)
        rg_f = rg_refl + rg_trans
        rg_pdf = 0.5 * (torch.where(refl, mf_pdf, 0.0)
                        + _microfacet_transmission_pdf(wo, wi, ax, ay, eta0))
        f = torch.where(rough_glass[..., None], rg_f, f)
        pdf = torch.where(rough_glass, rg_pdf, pdf)

    delta = is_specular(m)
    return (torch.where(delta[..., None], 0.0, f),
            torch.where(delta, 0.0, pdf))


class BSDFSample(NamedTuple):
    wi: Any  # [R,3] local frame
    f: Any  # [R,3]
    pdf: Any  # [R]
    specular: Any  # [R] bool (delta lobe sampled)
    transmission: Any  # [R] bool


def sample(m: MaterialLanes, wo, u2, uc, present=None) -> BSDFSample:
    """BSDF::Sample_f over lanes. u2: [R,2], uc: [R] lobe selector;
    `present` as for evaluate."""
    ax = torch.clamp(m.rough_u, min=1e-3)
    ay = torch.clamp(m.rough_v, min=1e-3)
    t = m.mat_type
    falses = torch.zeros_like(t, dtype=torch.bool)

    # Candidate A: cosine hemisphere (diffuse lobes).
    wi_cos = cosine_sample_hemisphere(u2)
    flip_z = cm.const((1.0, 1.0, -1.0), wo.device)
    wi = torch.where(wo[..., 2:3] < 0, wi_cos * flip_z, wi_cos)

    hair_model = m.hair_h is not None and _has(present, sb.MAT_HAIR)
    glossy = _has(present, sb.MAT_PLASTIC, sb.MAT_UBER, sb.MAT_SUBSTRATE,
                  sb.MAT_FOURIER, sb.MAT_DISNEY, sb.MAT_METAL, sb.MAT_GLASS,
                  *_PLASTIC_LIKE, sb.MAT_HAIR)
    # The BSSRDF interface samples as smooth glass does (FresnelSpecular);
    # its transmitted lanes feed the integrator's Sample_Sp block.
    sssl = sss_interface(m) if _has(present, *_PLASTIC_LIKE) else None
    has_glass = _has(present, sb.MAT_GLASS) or sssl is not None
    mirror = t == sb.MAT_MIRROR
    glass = rough_glass = choose_mf_refr = choose_refr = falses
    if glossy:
        # Candidate B: microfacet half-vector.
        wh = tr_sample_wh(wo, u2, ax, ay)
        wi_mf = 2.0 * cm.dot(wo, wh)[..., None] * wh - wo
        two_lobe = ((t == sb.MAT_PLASTIC) | (t == sb.MAT_UBER)
                    | (t == sb.MAT_SUBSTRATE) | (t == sb.MAT_DISNEY))
        # Hair samples the Marschner lobes when it has them, else the
        # two-lobe proposal, as kdsubsurface/subsurface outside the BSSRDF
        # and Fourier lanes without a table do.
        for mt in (sb.MAT_FOURIER, *_PLASTIC_LIKE,
                   *(() if hair_model else (sb.MAT_HAIR,))):
            if _has(present, mt):
                two_lobe = two_lobe | (t == mt)
        if sssl is not None:
            two_lobe = two_lobe & ~sssl
        metal = t == sb.MAT_METAL
    if has_glass:
        # Candidate D: refraction (glass).
        eta0 = m.eta[..., 0]
        F = fresnel_dielectric(cos_theta(wo), 1.0, eta0)
        entering = cos_theta(wo) > 0
        eta_rel = torch.where(entering, 1.0 / eta0, eta0)
        zero = torch.zeros_like(wo[..., 0])
        n_loc = torch.stack([zero, zero, torch.where(entering, 1.0, -1.0)],
                            -1)
        ci = cm.dot(n_loc, wo)
        s2t = torch.clamp(1.0 - ci * ci, min=0.0) * eta_rel * eta_rel
        tir = s2t >= 1.0
        ct = cm.sqrt(torch.clamp(1.0 - s2t, min=0.0))
        wi_refr = (-wo * eta_rel[..., None]
                   + (eta_rel * ci - ct)[..., None] * n_loc)
        glass = (t == sb.MAT_GLASS) & (m.rough_u < 1e-4)
        if sssl is not None:
            glass = glass | sssl
        rough_glass = (t == sb.MAT_GLASS) & (m.rough_u >= 1e-4)

        # Rough glass refraction through the sampled microfacet normal.
        ci_wh = cm.dot(wo, wh)
        eta_rel_wh = torch.where(ci_wh > 0, 1.0 / eta0, eta0)
        wh_f = torch.where((ci_wh < 0)[..., None], -wh, wh)
        ci_whf = torch.abs(ci_wh)
        s2t_wh = torch.clamp(1.0 - ci_whf * ci_whf, min=0.0) * eta_rel_wh ** 2
        ct_wh = cm.sqrt(torch.clamp(1.0 - s2t_wh, min=0.0))
        wi_mf_refr = (-wo * eta_rel_wh[..., None]
                      + (eta_rel_wh * ci_whf - ct_wh)[..., None] * wh_f)
        choose_mf_refr = rough_glass & (uc >= 0.5)
        choose_refr = glass & (uc >= F)
    choose_refl = (glass & (uc < F) | mirror) if has_glass else mirror

    if glossy:
        choose_mf = (two_lobe & (uc < 0.5) | metal
                     | (rough_glass & (uc < 0.5)))
        wi = torch.where(choose_mf[..., None], wi_mf, wi)
    if has_glass:
        wi = torch.where(choose_mf_refr[..., None], wi_mf_refr, wi)
    # Candidate C: mirror reflection.
    wi = torch.where(choose_refl[..., None], reflect_local(wo), wi)
    if has_glass:
        wi = torch.where(choose_refr[..., None], wi_refr, wi)
    if hair_model:
        with spans.span("hair.sample_wi"):
            wi = torch.where((t == sb.MAT_HAIR)[..., None],
                             hair.sample_wi(_hair_lanes(m), wo, u2, uc), wi)
    ft = _fourier_lanes(m, present)
    if ft is not None:
        # A table samples its own distribution (reflection.cpp:429-480);
        # evaluate() returns the matching table pdf.
        wi_ft, _ = fourier.sample_wi(m.fourier_tab, m.fourier_id[ft],
                                     wo[ft], u2[ft])
        wi = wi.index_put((ft,), wi_ft)

    f_eval, pdf_eval = evaluate(m, wo, wi, present)

    # Delta lobes: pdf=1 and f = F*R/|cos wi| so weight = f|cos|/pdf.
    aci = torch.clamp(abs_cos_theta(wi), min=1e-7)
    specular = choose_refl | choose_refr
    f = torch.where(specular[..., None], 0.0, f_eval)
    pdf = torch.where(specular, 1.0, pdf_eval)
    f = torch.where(mirror[..., None], m.kr / aci[..., None], f)
    if has_glass:
        f_glass_r = (F[..., None] * m.kr) / aci[..., None]
        f_glass_t = ((1.0 - F) * eta_rel * eta_rel)[..., None] * m.kt \
            / aci[..., None]
        f_glass_t = torch.where(tir[..., None], 0.0, f_glass_t)
        f = torch.where((choose_refl & glass)[..., None], f_glass_r, f)
        f = torch.where(choose_refr[..., None], f_glass_t, f)
        pdf = torch.where(choose_refl & glass, torch.clamp(F, min=1e-7), pdf)
        pdf = torch.where(choose_refr, torch.clamp(1.0 - F, min=1e-7), pdf)

    return BSDFSample(wi=wi, f=f, pdf=pdf, specular=specular,
                      transmission=choose_refr)
