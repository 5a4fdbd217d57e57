# Copied from statmc_tpu/render/bssrdf.py (numpy host precompute; behaviour
# unchanged).
"""Separable BSSRDF groundwork: photon-beam-diffusion profile tables.

Re-derivation of the reference's BSSRDF precomputation
(the reference renderer's src/core/bssrdf.cpp):

* FresnelMoment1/2 polynomial fits (bssrdf.cpp:43-66);
* BeamDiffusionMS: the Grosjean-diffusion dipole with exponentially
  sampled real-source depths, extrapolated boundary, and the
  kappa = 1 - e^{-2 sigmap_t (d_r + z_r)} correction
  (bssrdf.cpp:68-120);
* BeamDiffusionSS: single-scattering integration along the critical-
  angle-offset beam (bssrdf.cpp:122-143);
* ComputeBeamDiffusionBSSRDF: the (rho, radius) profile grid with
  per-rho effective albedo + radius CDF via IntegrateCatmullRom
  (bssrdf.cpp:145-198);
* SubsurfaceFromDiffuse: invert rhoEff to recover (sigma_a, sigma_s)
  from an artist reflectance + mean free path (bssrdf.cpp:199-207).

Everything here is HOST-side numpy precompute (runs once per
material); render/sss.py stacks the tables and runs the device
Sample_Sp probe-ray scheme on them.  All loops are
vectorized over the radius axis, with the sample axis reduced via
einsum-free broadcasting -- the grids are tiny (100 rho x 64 radius x
100 depth samples).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


def fresnel_moment1(eta: float) -> float:
    """bssrdf.cpp:43-52."""
    e = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = e**2, e**3, e**4, e**5
    if eta < 1:
        return float(0.45966 - 1.73965 * e + 3.37668 * e2 - 3.904945 * e3
                     + 2.49277 * e4 - 0.68441 * e5)
    return float(-4.61686 + 11.1136 * e - 10.4646 * e2 + 5.11455 * e3
                 - 1.27198 * e4 + 0.12746 * e5)


def fresnel_moment2(eta: float) -> float:
    """bssrdf.cpp:54-66."""
    e = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = e**2, e**3, e**4, e**5
    if eta < 1:
        return float(0.27614 - 0.87350 * e + 1.12077 * e2 - 0.65095 * e3
                     + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / e
    r2, r3 = r * r, r * r * r
    return float(-547.033 + 45.3087 * r3 - 218.725 * r2 + 458.843 * r
                 + 404.557 * e - 189.519 * e2 + 54.9327 * e3
                 - 9.00603 * e4 + 0.63942 * e5)


def _fr_dielectric(cos_i, eta_i, eta_t):
    """core/reflection.cpp:FrDielectric, vectorized."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = np.where(entering, eta_i, eta_t)
    et = np.where(entering, eta_t, eta_i)
    ci = np.abs(cos_i)
    st = ei / et * np.sqrt(np.maximum(0.0, 1.0 - ci * ci))
    tir = st >= 1
    ct = np.sqrt(np.maximum(0.0, 1.0 - st * st))
    rpar = (et * ci - ei * ct) / np.maximum(et * ci + ei * ct, 1e-12)
    rperp = (ei * ci - et * ct) / np.maximum(ei * ci + et * ct, 1e-12)
    fr = 0.5 * (rpar * rpar + rperp * rperp)
    return np.where(tir, 1.0, fr)


def _phase_hg(cos_theta, g):
    d = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * np.pi * d * np.sqrt(np.maximum(d, 1e-12)))


_N_SAMPLES = 100


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r):
    """bssrdf.cpp:68-120; r may be an array."""
    r = np.asarray(r, np.float64)
    sigmap_s = sigma_s * (1.0 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / sigmap_t
    d_g = (2.0 * sigma_a + sigmap_s) / (3.0 * sigmap_t * sigmap_t)
    sigma_tr = np.sqrt(sigma_a / d_g)
    fm1, fm2 = fresnel_moment1(eta), fresnel_moment2(eta)
    ze = -2.0 * d_g * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)
    i = np.arange(_N_SAMPLES, dtype=np.float64)
    zr = -np.log(1.0 - (i + 0.5) / _N_SAMPLES) / sigmap_t  # [S]
    zv = -zr + 2.0 * ze
    rr = r[..., None]
    dr = np.sqrt(rr * rr + zr * zr)
    dv = np.sqrt(rr * rr + zv * zv)
    phi_d = (1.0 / (4.0 * np.pi)) / d_g * (
        np.exp(-sigma_tr * dr) / dr - np.exp(-sigma_tr * dv) / dv)
    e_dn = (1.0 / (4.0 * np.pi)) * (
        zr * (1.0 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / dr**3
        - zv * (1.0 + sigma_tr * dv) * np.exp(-sigma_tr * dv) / dv**3)
    e = phi_d * c_phi + e_dn * c_e
    kappa = 1.0 - np.exp(-2.0 * sigmap_t * (dr + zr))
    return np.mean(kappa * rhop * rhop * e, axis=-1)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r):
    """bssrdf.cpp:122-143; r may be an array."""
    r = np.asarray(r, np.float64)
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / sigma_t
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = np.arange(_N_SAMPLES, dtype=np.float64)
    ti = t_crit[..., None] - np.log(1.0 - (i + 0.5) / _N_SAMPLES) / sigma_t
    d = np.sqrt(r[..., None] ** 2 + ti * ti)
    cos_o = ti / np.maximum(d, 1e-12)
    ess = (rho * np.exp(-sigma_t * (d + t_crit[..., None]))
           / np.maximum(d * d, 1e-12)
           * _phase_hg(cos_o, g)
           * (1.0 - _fr_dielectric(-cos_o, 1.0, eta))
           * np.abs(cos_o))
    return np.mean(ess, axis=-1)


def _integrate_catmull_rom(x, values):
    """(total, cdf) -- interpolation.cpp:293-322, vectorized rows."""
    x = np.asarray(x, np.float64)
    v = np.asarray(values, np.float64)
    n = x.shape[0]
    cdf = np.zeros(v.shape[:-1] + (n,), np.float64)
    total = np.zeros(v.shape[:-1], np.float64)
    for i in range(n - 1):
        x0, x1 = x[i], x[i + 1]
        f0, f1 = v[..., i], v[..., i + 1]
        width = x1 - x0
        d0 = (width * (f1 - v[..., i - 1]) / (x1 - x[i - 1])
              if i > 0 else f1 - f0)
        d1 = (width * (v[..., i + 2] - f0) / (x[i + 2] - x0)
              if i + 2 < n else f1 - f0)
        total = total + ((d0 - d1) / 12.0 + (f0 + f1) * 0.5) * width
        cdf[..., i + 1] = total
    return total, cdf


class BSSRDFTable(NamedTuple):
    """bssrdf.cpp BSSRDFTable: the (rho, radius) diffusion profile."""
    rho: np.ndarray         # [NR] single-scattering albedos
    radius: np.ndarray      # [NS] unitless optical radii
    profile: np.ndarray     # [NR, NS] 2*pi*r*(SS+MS)
    rho_eff: np.ndarray     # [NR] effective (diffuse) albedo
    profile_cdf: np.ndarray  # [NR, NS]


def compute_beam_diffusion_bssrdf(g: float = 0.0, eta: float = 1.33,
                                  n_rho: int = 100,
                                  n_radius: int = 64) -> BSSRDFTable:
    """bssrdf.cpp:145-198."""
    radius = np.zeros(n_radius)
    radius[1] = 2.5e-3
    for i in range(2, n_radius):
        radius[i] = radius[i - 1] * 1.2
    rho = (1.0 - np.exp(-8.0 * np.arange(n_rho) / (n_rho - 1))) \
        / (1.0 - np.exp(-8.0))
    profile = np.zeros((n_rho, n_radius))
    for i, rh in enumerate(rho):
        if rh <= 0:
            continue
        profile[i] = 2.0 * np.pi * radius * (
            beam_diffusion_ss(rh, 1.0 - rh, g, eta, radius)
            + beam_diffusion_ms(rh, 1.0 - rh, g, eta, radius))
    rho_eff, cdf = _integrate_catmull_rom(radius, profile)
    return BSSRDFTable(rho=rho, radius=radius, profile=profile,
                       rho_eff=rho_eff, profile_cdf=cdf)


def _invert_catmull_rom(x, values, u):
    """interpolation.cpp:InvertCatmullRom -- scalar u against a
    monotone value array."""
    if not u > values[0]:
        return float(x[0])
    if not u < values[-1]:
        return float(x[-1])
    i = int(np.searchsorted(values, u) - 1)
    i = max(0, min(i, len(x) - 2))
    x0, x1 = x[i], x[i + 1]
    f0, f1 = values[i], values[i + 1]
    width = x1 - x0
    d0 = (width * (f1 - values[i - 1]) / (x1 - x[i - 1])
          if i > 0 else f1 - f0)
    d1 = (width * (values[i + 2] - f0) / (x[i + 2] - x0)
          if i + 2 < len(x) else f1 - f0)
    a, b, t = 0.0, 1.0, np.clip((u - f0) / max(f1 - f0, 1e-12), 0, 1)
    for _ in range(32):
        if not (a <= t <= b):
            t = 0.5 * (a + b)
        fhat = (f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                    + t * (d0 + d1 + 2 * (f0 - f1)))))
        # Hermite VALUE (not integral): invert value(t) = u.
        if fhat < u:
            a = t
        else:
            b = t
        deriv = (d0 + t * (2 * (-2 * d0 - d1 + 3 * (f1 - f0))
                           + t * 3 * (d0 + d1 + 2 * (f0 - f1))))
        t = t - (fhat - u) / deriv if abs(deriv) > 1e-12 else 0.5 * (a + b)
        if b - a < 1e-9:
            break
    return float(x0 + width * np.clip(t, 0.0, 1.0))


def subsurface_from_diffuse(table: BSSRDFTable, rho_eff_rgb, mfp_rgb):
    """bssrdf.cpp:199-207: (sigma_a[3], sigma_s[3]) from an artist
    diffuse reflectance + mean free path per channel."""
    rho_eff_rgb = np.atleast_1d(np.asarray(rho_eff_rgb, np.float64))
    mfp_rgb = np.atleast_1d(np.asarray(mfp_rgb, np.float64))
    sigma_a = np.zeros(3)
    sigma_s = np.zeros(3)
    for c in range(3):
        rho = _invert_catmull_rom(table.rho, table.rho_eff,
                                  float(rho_eff_rgb[c % len(rho_eff_rgb)]))
        mfp = float(mfp_rgb[c % len(mfp_rgb)])
        sigma_s[c] = rho / mfp
        sigma_a[c] = (1.0 - rho) / mfp
    return sigma_a, sigma_s
