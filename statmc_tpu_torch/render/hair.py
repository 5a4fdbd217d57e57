"""Marschner hair BSDF: longitudinal x azimuthal lobe products (port of
statmc_tpu/render/hair.py).

The pbrt-v3 HairBSDF (materials/hair.cpp; Chiang et al. 2016): pMax = 3
scattering modes (R, TT, TRT) plus a residual lobe, each the product of
a longitudinal term Mp (von Mises-Fisher through the modified Bessel
I0), an attenuation Ap (Fresnel + one pass of cortex transmittance) and
an azimuthal trimmed logistic Np centred on the perfect-specular
deflection, with the cuticle tilt rotating theta_o per lobe.

Every helper maps over the lane axis [R] branch-free, as in the JAX
package.  Where the JAX code loops over the P_MAX + 1 lobes, the port
stacks them on a trailing axis, so one eager op serves all four lobes;
the lobe sums are still added one lobe at a time, in the JAX package's
order.  Integer powers multiply in jax.lax.integer_pow's order
(_ipow).  Frame: x = curve tangent (dpdu), z = shading normal;
sin(theta) = w.x, phi = atan2(w.z, w.y); h in [-1, 1] across the width.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import math as cm

P_MAX = 3
_PI = 3.14159265358979
_SQRT_PI_OVER_8 = 0.626657069
_EU = (0.419, 0.697, 1.37)  # eumelanin absorption (hair.cpp:270-277)
_PH = (0.187, 0.4, 1.05)  # pheomelanin
_LUM = (0.212671, 0.715160, 0.072169)


class HairLanes(NamedTuple):
    """Per-lane hair parameters (HairBSDF constructor args)."""
    h: Any         # [R] offset across the width, in [-1, 1]
    eta: Any       # [R]
    sigma_a: Any   # [R,3] absorption inside the cortex
    beta_m: Any    # [R] longitudinal roughness in [0,1]
    beta_n: Any    # [R] azimuthal roughness in [0,1]
    alpha: Any     # [R] cuticle scale tilt, degrees


def _ipow(x, n: int):
    """x**n by binary exponentiation in jax.lax.integer_pow's order."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _f64(fn, *xs):
    """fn evaluated in float64 and rounded once to float32.  The card's
    and the CPU's float32 exp, log, sinh, asin, atan2, sin, cos and
    sigmoid each differ by an ulp on some inputs, and a hair ribbon a
    few hundredths wide turns such ulps into visible differences; from
    float64 both round to the same float32 (but on rare ties)."""
    return fn(*(x.double() for x in xs)).float()


def sigma_a_from_concentration(ce, cp):
    """Melanin concentrations -> absorption (hair.cpp:270-277); numpy
    arrays or scalars in, float32 numpy out (scene/build.py), or
    tensors in, tensors out."""
    if torch.is_tensor(ce):
        eu = torch.tensor(_EU, device=ce.device)
        ph = torch.tensor(_PH, device=ce.device)
        cp = torch.as_tensor(cp, dtype=torch.float32, device=ce.device)
        return ce.float()[..., None] * eu + cp[..., None] * ph
    ce = np.asarray(ce, np.float32)
    cp = np.asarray(cp, np.float32)
    return (ce[..., None] * np.asarray(_EU, np.float32)
            + cp[..., None] * np.asarray(_PH, np.float32))


def sigma_a_from_reflectance(c, beta_n):
    """Azimuthally averaged reflectance -> absorption (hair.cpp:279-287);
    numpy or tensors, as sigma_a_from_concentration."""
    if torch.is_tensor(c):
        c = torch.clamp(c.float(), 1e-5, 1.0)
        bn = torch.as_tensor(beta_n, dtype=torch.float32, device=c.device)
        log = torch.log
    else:
        c = np.clip(np.asarray(c, np.float32), np.float32(1e-5),
                    np.float32(1.0))
        bn = np.asarray(beta_n, np.float32)

        def log(x):  # numpy's float32 log can be an ulp off; XLA's is not
            return np.log(x.astype(np.float64)).astype(np.float32)
    denom = (5.969 - 0.215 * bn + 2.532 * _ipow(bn, 2)
             - 10.73 * _ipow(bn, 3) + 5.574 * _ipow(bn, 4)
             + 0.245 * _ipow(bn, 5))
    q = log(c) / denom[..., None]
    return q * q


def _i0(x):
    """Modified Bessel I0, 10-term series (hair.cpp:74-86), the input
    clamped to the series' accurate range."""
    x2 = torch.clamp(x * x, max=144.0)
    val = torch.ones_like(x)
    term = torch.ones_like(x)
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        val = val + term
    return val


def _log_i0(x, i0_small=None):
    """log I0(x) with the large-x asymptotic form (hair.cpp:89-94);
    i0_small, if given, is _i0(min(x, 12)) computed by the caller."""
    xm = torch.clamp(x, min=1e-6)
    big = x + 0.5 * (-math.log(2 * _PI) + _f64(torch.log, 1.0 / xm)
                     + 1.0 / (8.0 * xm))
    if i0_small is None:
        i0_small = _i0(torch.clamp(x, max=12.0))
    return torch.where(x > 12.0, big, _f64(torch.log, i0_small))


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal lobe (hair.cpp:62-72), branch-free: small v takes the
    log-space form; both branches' inputs are clamped finite.  The two
    branches' I0 series run as one stacked call."""
    v = torch.clamp(v, min=1e-8)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = v <= 0.1
    v_big = torch.clamp(v, min=0.05)
    ab = cos_ti * cos_to / v_big
    bb = sin_ti * sin_to / v_big
    i0_a, i0_ab = _i0(torch.stack([torch.clamp(a, max=12.0), ab]))
    log_form = _f64(torch.exp, torch.clamp(
        _log_i0(a, i0_a) - b - 1.0 / v + 0.6931
        + _f64(torch.log, 1.0 / (2.0 * v)), -80.0, 80.0))
    direct = _f64(torch.exp, -bb) * i0_ab / (
        _f64(torch.sinh, 1.0 / v_big) * 2.0 * v_big)
    return torch.where(small, log_form, direct)


def _safe_sqrt(x):
    return cm.sqrt(torch.clamp(x, min=0.0))


def _safe_asin(x):
    return _f64(torch.asin, torch.clamp(x, -1.0, 1.0))


def _fr_dielectric(cos_i, eta):
    """Unpolarized dielectric Fresnel, exterior side (FrDielectric with
    etaI = 1)."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    s2t = torch.clamp(1.0 - ci * ci, min=0.0) / (eta * eta)
    ct = _safe_sqrt(1.0 - s2t)
    r_par = (eta * ci - ct) / torch.clamp(eta * ci + ct, min=1e-7)
    r_perp = (ci - eta * ct) / torch.clamp(ci + eta * ct, min=1e-7)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(s2t >= 1.0, 1.0, fr)


def _ap(cos_to, eta, h, T):
    """Attenuations A_0..A_3 (hair.cpp:96-114), [..., P_MAX+1, 3]."""
    cos_gamma_o = _safe_sqrt(1.0 - h * h)
    f = _fr_dielectric(cos_to * cos_gamma_o, eta)[..., None]
    a0 = f.expand(T.shape)
    a1 = (1.0 - f) * (1.0 - f) * T
    a2 = a1 * T * f
    tf = torch.clamp(T * f, 0.0, 0.9999)
    a3 = a2 * tf / (1.0 - tf)
    return torch.stack([a0, a1, a2, a3], dim=-2)


def _logistic_pdf(x, s):
    x = torch.abs(x) / s
    e = _f64(torch.exp, -torch.clamp(x, max=80.0))
    return e / (s * ((1.0 + e) * (1.0 + e)))


def _logistic_cdf(x, s):
    return _f64(torch.sigmoid, x / s)


def _trimmed_logistic(x, s, a, b):
    return _logistic_pdf(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    """Inverse-CDF sample of the trimmed logistic (hair.cpp:142-149)."""
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    t = 1.0 / torch.clamp(u * k + _logistic_cdf(a, s), 1e-7, 1.0 - 1e-7) \
        - 1.0
    x = -s * _f64(torch.log, torch.clamp(t, min=1e-30))
    return torch.clamp(x, a, b)


def _phi_p(p, gamma_o, gamma_t):
    """Net azimuthal deflection of mode p (hair.cpp:116-118); p a
    tensor broadcasting against gamma_o / gamma_t."""
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * _PI


def _variances(beta_m):
    """Longitudinal variance per lobe (hair.cpp:396-403), [..., 4]."""
    q = 0.726 * beta_m + 0.812 * _ipow(beta_m, 2) + 3.7 * _ipow(beta_m, 20)
    v0 = q * q
    return torch.stack([v0, 0.25 * v0, 4.0 * v0, 4.0 * v0], dim=-1)


def _azimuthal_s(beta_n):
    """Logistic scale from azimuthal roughness (hair.cpp:406-407)."""
    return _SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * _ipow(beta_n, 2)
                              + 5.372 * _ipow(beta_n, 22))


def _tilted_all(sin_to, cos_to, alpha_deg):
    """(sin, |cos|) of theta_o rotated by each lobe's cuticle tilt
    (hair.cpp:411-415, 448-469: R by -2a, TT by a, TRT by 4a, the
    residual untilted), stacked [..., 4]: sin(2^k a) and cos(2^k a) by
    double-angle chaining, then one rotation for the four lobes."""
    a = alpha_deg * (_PI / 180.0)
    s0 = _f64(torch.sin, a)
    c0 = _safe_sqrt(1.0 - s0 * s0)
    s1 = 2.0 * c0 * s0
    c1 = c0 * c0 - s0 * s0
    s2 = 2.0 * c1 * s1
    c2 = c1 * c1 - s1 * s1
    S = torch.stack([-s1, s0, s2, torch.zeros_like(s0)], -1)
    C = torch.stack([c1, c0, c2, torch.ones_like(c0)], -1)
    st, ct = sin_to[..., None], cos_to[..., None]
    return st * C + ct * S, torch.abs(ct * C - st * S)


def _geometry(hp: HairLanes, wo):
    """Angles shared by f/pdf/sample (hair.cpp:420-443)."""
    sin_to = torch.clamp(wo[..., 0], -1.0, 1.0)
    cos_to = torch.clamp(_safe_sqrt(1.0 - sin_to * sin_to), min=1e-5)
    phi_o = _f64(torch.atan2, wo[..., 2], wo[..., 1])
    gamma_o = _safe_asin(hp.h)
    sin_tt = sin_to / hp.eta
    cos_tt = torch.clamp(_safe_sqrt(1.0 - sin_tt * sin_tt), min=1e-5)
    etap = _safe_sqrt(hp.eta * hp.eta - sin_to * sin_to) / cos_to
    sin_gt = hp.h / torch.clamp(etap, min=1e-5)
    cos_gt = _safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = _safe_asin(sin_gt)
    # One pass through the cortex (hair.cpp:441).
    T = _f64(torch.exp,
             -hp.sigma_a * (2.0 * cos_gt / cos_tt)[..., None])
    return sin_to, cos_to, phi_o, gamma_o, gamma_t, T


def _np_lobes(phi, s, gamma_o, gamma_t):
    """Np of lobes 0..P_MAX-1, [..., P_MAX]."""
    p = torch.arange(P_MAX, dtype=phi.dtype, device=phi.device)
    dphi = phi[..., None] - _phi_p(p, gamma_o[..., None], gamma_t[..., None])
    dphi = torch.remainder(dphi + _PI, 2.0 * _PI) - _PI
    return _trimmed_logistic(dphi, s[..., None], -_PI, _PI)


def _lobe_terms(hp: HairLanes, wo, wi):
    """(Mp [..., 4], Np [..., 3], Ap [..., 4, 3], cos_to, T) for the
    pair (wo, wi)."""
    sin_to, cos_to, phi_o, gamma_o, gamma_t, T = _geometry(hp, wo)
    sin_ti = torch.clamp(wi[..., 0], -1.0, 1.0)
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)
    phi = _f64(torch.atan2, wi[..., 2], wi[..., 1]) - phi_o
    sin_top, cos_top = _tilted_all(sin_to, cos_to, hp.alpha)
    mp = _mp(cos_ti[..., None], cos_top, sin_ti[..., None], sin_top,
             _variances(hp.beta_m))
    np_ = _np_lobes(phi, _azimuthal_s(hp.beta_n), gamma_o, gamma_t)
    return mp, np_, cos_to, T


def _ap_pdf(ap):
    """Lobe-selection pmf from the luminance of Ap (hair.cpp:483-508)."""
    y = ap[..., 0] * _LUM[0] + ap[..., 1] * _LUM[1] + ap[..., 2] * _LUM[2]
    tot = y[..., 0] + y[..., 1] + y[..., 2] + y[..., 3]
    return y / torch.clamp(tot, min=1e-12)[..., None]


def eval_f_pdf(hp: HairLanes, wo, wi):
    """(HairBSDF::f, HairBSDF::Pdf) of the pair (wo, wi), sharing the
    lobe terms (hair.cpp:418-480, 602-664).  f is divided by |cos wi| so
    the caller's f |cos| convention holds."""
    mp, np_, cos_to, T = _lobe_terms(hp, wo, wi)
    ap = _ap(cos_to, hp.eta, hp.h, T)
    w = torch.cat([mp[..., :P_MAX] * np_,
                   mp[..., P_MAX:] / (2.0 * _PI)], -1)[..., None] * ap
    fsum = w[..., 0, :] + w[..., 1, :] + w[..., 2, :] + w[..., 3, :]
    abs_cos_wi = torch.abs(wi[..., 2])
    fsum = fsum / torch.clamp(abs_cos_wi, min=1e-5)[..., None]
    f = torch.where((abs_cos_wi > 0)[..., None], fsum, 0.0)
    ap_pdf = _ap_pdf(ap)
    w = mp[..., :P_MAX] * np_ * ap_pdf[..., :P_MAX]
    return f, (w[..., 0] + w[..., 1] + w[..., 2]
               + mp[..., P_MAX] * ap_pdf[..., P_MAX] / (2.0 * _PI))


def eval_f(hp: HairLanes, wo, wi):
    """HairBSDF::f (hair.cpp:418-480)."""
    return eval_f_pdf(hp, wo, wi)[0]


def pdf(hp: HairLanes, wo, wi):
    """HairBSDF::Pdf (hair.cpp:602-664)."""
    return eval_f_pdf(hp, wo, wi)[1]


def _demux(u):
    """One uniform -> two by de-interleaving its top 30 bits (pbrt's
    DemuxFloat, hair.cpp:49-57 Compact1By1)."""
    bits = (torch.clamp(u, 0.0, 1.0 - 1e-7) * (1 << 30)).to(torch.int64)
    even = bits & 0x55555555
    odd = (bits >> 1) & 0x55555555

    def compact(x):
        x = (x | (x >> 1)) & 0x33333333
        x = (x | (x >> 2)) & 0x0F0F0F0F
        x = (x | (x >> 4)) & 0x00FF00FF
        x = (x | (x >> 8)) & 0x0000FFFF
        return x

    a = compact(even).to(torch.float32) / 32768.0
    b = compact(odd).to(torch.float32) / 32768.0
    return torch.clamp(a, 0.0, 1.0 - 1e-6), torch.clamp(b, 0.0, 1.0 - 1e-6)


def sample_wi(hp: HairLanes, wo, u2, uc):
    """HairBSDF::Sample_f's direction (hair.cpp:510-566): lobe p by the
    Ap luminance pmf (uc), theta_i from Mp (u2[..., 0]), the azimuth and
    dphi from u2[..., 1] demuxed.  f and pdf come from eval_f and pdf."""
    sin_to, cos_to, phi_o, gamma_o, gamma_t, T = _geometry(hp, wo)
    ap_pdf = _ap_pdf(_ap(cos_to, hp.eta, hp.h, T))
    s = _azimuthal_s(hp.beta_n)
    cdf = torch.cumsum(ap_pdf, dim=-1)
    p_idx = torch.sum((uc[..., None] >= cdf[..., :-1]).to(torch.int64), -1)
    sin_all, cos_all = _tilted_all(sin_to, cos_to, hp.alpha)
    pi = p_idx[..., None]
    sin_top = torch.gather(sin_all, -1, pi)[..., 0]
    cos_top = torch.gather(cos_all, -1, pi)[..., 0]
    vp = torch.gather(_variances(hp.beta_m), -1, pi)[..., 0]

    u_theta = torch.clamp(u2[..., 0], min=1e-5)
    u_azim, u_dphi = _demux(u2[..., 1])
    # Mp inverse CDF (hair.cpp:542-549) with the tilted |cos theta_o|,
    # as the JAX package (sampler and pdf stay consistent).
    e = _f64(torch.exp, -2.0 / torch.clamp(vp, min=1e-6))
    cos_t = 1.0 + vp * _f64(torch.log, u_theta + (1.0 - u_theta) * e)
    sin_t = _safe_sqrt(1.0 - cos_t * cos_t)
    cos_ph = _f64(torch.cos, 2.0 * _PI * u_azim)
    sin_ti = -cos_t * sin_top + sin_t * cos_ph * cos_top
    cos_ti = _safe_sqrt(1.0 - sin_ti * sin_ti)

    # Np sample (hair.cpp:551-562); the residual lobe is uniform in phi.
    pc = torch.clamp(p_idx, max=P_MAX - 1).to(torch.float32)
    dphi_lobe = (_phi_p(pc, gamma_o, gamma_t)
                 + _sample_trimmed_logistic(u_dphi, s, -_PI, _PI))
    dphi = torch.where(p_idx >= P_MAX, 2.0 * _PI * u_dphi, dphi_lobe)
    phi_i = phi_o + dphi
    return torch.stack([sin_ti, cos_ti * _f64(torch.cos, phi_i),
                        cos_ti * _f64(torch.sin, phi_i)], -1)
