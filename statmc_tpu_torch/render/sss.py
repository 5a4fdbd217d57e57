# The host part (_host_cr_weights, _host_sample_cr, build_sss_tables) is
# copied from statmc_tpu/render/sss.py (numpy, behaviour unchanged); the
# device part is the port's, in torch.
"""Separable BSSRDF transport: Sample_Sp / Pdf_Sp / the Sw lobe (port of
statmc_tpu/render/sss.py).

The reference's subsurface sampling (core/bssrdf.cpp:233-393
Sample_Sp/Pdf_Sp/Sample_Sr/Pdf_Sr, bssrdf.h:86-97 Sw and :153-168 the
radiance-mode adapter), consumed by the integrator's in-bounce SSS
block (statpath.cpp:892-926).  As in the JAX package: the rho axis of
the profile is collapsed per material and channel at build time
([T, 3, NS] radius rows); SampleCatmullRom2D's Newton-bisection is a
fixed 16-trip masked iteration; FindInterval is a binary search of one
gather per trip; the unbounded IntersectionChain walk is a bounded
chain of PROBE_STEPS closest-hit calls over all lanes, the lanes that
do not fire carrying t_max = 0.

Where the JAX code loops over Pdf_Sp's 3 projection axes x 3 channels
and Sp's 3 channels, the port evaluates the profile once on the stacked
[R, 9] (or [R, 3]) radii and adds the terms in the JAX package's order.
A scene without subsurface materials never enters this module.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import spans
from ..core import math as cm

# Probe-chain depth (bssrdf.cpp:303-321 walks until the segment exits).
PROBE_STEPS = 4


class SSSTables(NamedTuple):
    """Stacked per-material BSSRDF tables.  T = subsurface materials,
    NS = 64 radius nodes (bssrdf.cpp:152-156's geometric grid)."""
    radius: Any   # [NS] unitless optical radius nodes (shared grid)
    prof: Any     # [T,3,NS] rho-collapsed profile rows per RGB channel
    cdf: Any      # [T,3,NS] IntegrateCatmullRom CDF rows
    rhoeff: Any   # [T,3] effective albedo at each channel's rho
    sigma_t: Any  # [T,3] world-space extinction per channel
    eta: Any      # [T] interior IOR
    c_sw: Any     # [T] Sw normalization 1 - 2*FresnelMoment1(1/eta)
    rmax: Any     # [T,3] world-space Sample_Sr(ch, 0.999) bound

    def to_device(self, device="cpu") -> "SSSTables":
        return SSSTables(*[torch.as_tensor(np.asarray(x), device=device)
                           for x in self])


# ------------------------------------------------------------------
# Host-side table construction
# ------------------------------------------------------------------

def _host_cr_weights(nodes: np.ndarray, x: float):
    """Scalar CatmullRomWeights (interpolation.cpp:61-103)."""
    n = len(nodes)
    if not (nodes[0] <= x <= nodes[-1]):
        x = float(np.clip(x, nodes[0], nodes[-1]))
    i = int(np.searchsorted(nodes, x, side="right") - 1)
    i = max(0, min(i, n - 2))
    x0, x1 = nodes[i], nodes[i + 1]
    t = (x - x0) / (x1 - x0) if x1 > x0 else 0.0
    t2, t3 = t * t, t * t * t
    w = np.zeros(4)
    w[1] = 2 * t3 - 3 * t2 + 1
    w[2] = -2 * t3 + 3 * t2
    if i > 0:
        w0 = (t3 - 2 * t2 + t) * (x1 - x0) / (x1 - nodes[i - 1])
        w[0] = -w0
        w[2] += w0
    else:
        w0 = t3 - 2 * t2 + t
        w[1] -= w0
        w[2] += w0
    if i + 2 < n:
        w3 = (t3 - t2) * (x1 - x0) / (nodes[i + 2] - x0)
        w[3] = w3
        w[1] -= w3
    else:
        w3 = t3 - t2
        w[1] -= w3
        w[2] += w3
    return i - 1, w


def _host_sample_cr(x: np.ndarray, f: np.ndarray, cdf: np.ndarray,
                    u: float) -> float:
    """Scalar SampleCatmullRom (interpolation.cpp:217-290) over one
    radius row; returns the sampled x."""
    u = u * cdf[-1]
    i = int(np.searchsorted(cdf, u, side="right") - 1)
    i = max(0, min(i, len(x) - 2))
    f0, f1 = f[i], f[i + 1]
    x0, x1 = x[i], x[i + 1]
    width = x1 - x0
    d0 = (width * (f1 - f[i - 1]) / (x1 - x[i - 1]) if i > 0 else f1 - f0)
    d1 = (width * (f[i + 2] - f0) / (x[i + 2] - x0)
          if i + 2 < len(x) else f1 - f0)
    u = (u - cdf[i]) / width if width > 0 else 0.0
    if f0 != f1:
        t = (f0 - np.sqrt(max(0.0, f0 * f0 + 2 * u * (f1 - f0)))) / (f0 - f1)
    else:
        t = u / max(f0, 1e-30)
    a, b = 0.0, 1.0
    for _ in range(64):
        if not (a <= t <= b):
            t = 0.5 * (a + b)
        Fhat = t * (f0 + t * (0.5 * d0 + t * (
            (1.0 / 3.0) * (-2 * d0 - d1) + f1 - f0
            + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                   + t * (d0 + d1 + 2 * (f0 - f1))))
        if abs(Fhat - u) < 1e-8 * max(cdf[-1], 1e-30):
            break
        if Fhat - u > 0:
            b = t
        else:
            a = t
        t = t - (Fhat - u) / fhat if abs(fhat) > 1e-30 else 0.5 * (a + b)
    return float(x0 + width * np.clip(t, 0.0, 1.0))


def build_sss_tables(entries) -> SSSTables:
    """Stack per-material tables from (sigma_a, sigma_s, g, eta) dicts
    (TabulatedBSSRDF, bssrdf.h:112-130, on ComputeBeamDiffusionBSSRDF),
    the rho spline axis collapsed per channel; numpy arrays."""
    from . import bssrdf as BD

    tables: dict[tuple, Any] = {}
    prof_l, cdf_l, rhoeff_l, sig_l, eta_l, c_l, rmax_l = \
        [], [], [], [], [], [], []
    for e in entries:
        g, eta = float(e["g"]), float(e["eta"])
        key = (round(g, 6), round(eta, 6))
        if key not in tables:
            tables[key] = BD.compute_beam_diffusion_bssrdf(g=g, eta=eta)
        tab = tables[key]
        sigma_a = np.asarray(e["sigma_a"], np.float64).reshape(3)
        sigma_s = np.asarray(e["sigma_s"], np.float64).reshape(3)
        sigma_t = sigma_a + sigma_s
        rho = np.where(sigma_t > 0, sigma_s / np.maximum(sigma_t, 1e-30),
                       0.0)
        NS = len(tab.radius)
        prof_c = np.zeros((3, NS))
        cdf_c = np.zeros((3, NS))
        rhoeff_c = np.zeros(3)
        rmax_c = np.zeros(3)
        for ch in range(3):
            off, w = _host_cr_weights(tab.rho, float(rho[ch]))
            for j in range(4):
                k = min(max(off + j, 0), len(tab.rho) - 1)
                if w[j] == 0.0:
                    continue
                prof_c[ch] += w[j] * tab.profile[k]
                cdf_c[ch] += w[j] * tab.profile_cdf[k]
                rhoeff_c[ch] += w[j] * tab.rho_eff[k]
            # Collapsed rows can go slightly negative at the spline
            # boundary; the CDF must stay monotone for FindInterval.
            cdf_c[ch] = np.maximum.accumulate(np.maximum(cdf_c[ch], 0.0))
            if sigma_t[ch] > 0 and cdf_c[ch][-1] > 0:
                rmax_c[ch] = _host_sample_cr(
                    tab.radius, prof_c[ch], cdf_c[ch], 0.999) / sigma_t[ch]
        prof_l.append(prof_c)
        cdf_l.append(cdf_c)
        rhoeff_l.append(np.maximum(rhoeff_c, 1e-9))
        sig_l.append(sigma_t)
        eta_l.append(eta)
        c_l.append(1.0 - 2.0 * BD.fresnel_moment1(1.0 / eta))
        rmax_l.append(rmax_c)
    f32 = np.float32
    return SSSTables(
        radius=np.asarray(tables[next(iter(tables))].radius, f32),
        prof=np.stack(prof_l).astype(f32),
        cdf=np.stack(cdf_l).astype(f32),
        rhoeff=np.stack(rhoeff_l).astype(f32),
        sigma_t=np.stack(sig_l).astype(f32),
        eta=np.asarray(eta_l, f32),
        c_sw=np.asarray(c_l, f32),
        rmax=np.stack(rmax_l).astype(f32),
    )


# ------------------------------------------------------------------
# Device-side spline machinery
# ------------------------------------------------------------------

def _find_interval_rows(flat, base, ns: int, u):
    """Per-lane FindInterval over rows of a flat value table: the largest
    i in [0, ns-2] with flat[base+i] <= u, one gather per trip."""
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, ns - 1)
    for _ in range(int(np.ceil(np.log2(ns))) + 1):
        mid = (lo + hi + 1) // 2
        pred = flat[base + mid] <= u
        lo = torch.where(pred, mid, lo)
        hi = torch.where(pred, hi, mid - 1)
    return torch.clamp(lo, 0, ns - 2)


def _segment_coeffs(flat, base, i, nodes):
    """Hermite segment (x0, x1, f0, f1, d0, d1) at interval i with pbrt's
    one-sided boundary derivatives (interpolation.cpp:236-247)."""
    ns = nodes.shape[0]
    x0, x1 = nodes[i], nodes[i + 1]
    f0, f1 = flat[base + i], flat[base + i + 1]
    width = x1 - x0
    im1 = torch.clamp(i - 1, min=0)
    d0 = torch.where(i > 0, width * (f1 - flat[base + im1])
                     / torch.clamp(x1 - nodes[im1], min=1e-30), f1 - f0)
    ip2 = torch.clamp(i + 2, max=ns - 1)
    d1 = torch.where(i + 2 < ns, width * (flat[base + ip2] - f0)
                     / torch.clamp(nodes[ip2] - x0, min=1e-30), f1 - f0)
    return x0, x1, f0, f1, d0, d1


def _eval_profile(tab: SSSTables, tid, ch, r_opt):
    """Spline value of the collapsed profile row (tid, ch) at optical
    radius r_opt (TabulatedBSSRDF::Sr's radius interpolation,
    bssrdf.cpp:233-259); 0 outside the node range.  tid, ch and r_opt
    broadcast together."""
    nodes = tab.radius
    ns = nodes.shape[0]
    base = (tid.long() * 3 + ch) * ns
    idx = torch.clamp(torch.searchsorted(nodes, r_opt.contiguous(),
                                         right=True) - 1, 0, ns - 2)
    x0, x1, f0, f1, d0, d1 = _segment_coeffs(tab.prof.reshape(-1), base,
                                             idx, nodes)
    t = (r_opt - x0) / torch.clamp(x1 - x0, min=1e-30)
    val = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                              + t * (d0 + d1 + 2 * (f0 - f1))))
    ok = (r_opt >= nodes[0]) & (r_opt <= nodes[-1])
    return torch.where(ok, val, 0.0)


def sample_sr(tab: SSSTables, tid, ch, u):
    """TabulatedBSSRDF::Sample_Sr over lanes (bssrdf.cpp:354-361 via
    SampleCatmullRom2D): the WORLD radius, or -1 where sigma_t[ch] = 0."""
    nodes = tab.radius
    ns = nodes.shape[0]
    cdf_f = tab.cdf.reshape(-1)
    base = (tid.long() * 3 + ch) * ns
    cmax = cdf_f[base + ns - 1]
    up = u * cmax
    i = _find_interval_rows(cdf_f, base, ns, up)
    x0, x1, f0, f1, d0, d1 = _segment_coeffs(tab.prof.reshape(-1), base, i,
                                             nodes)
    width = x1 - x0
    ui = (up - cdf_f[base + i]) / torch.clamp(width, min=1e-30)
    # Initial guess from the linear-profile closed form.
    lin = torch.abs(f0 - f1) > 1e-20
    t = torch.where(
        lin,
        (f0 - cm.sqrt(torch.clamp(f0 * f0 + 2 * ui * (f1 - f0), min=0.0)))
        / torch.where(lin, f0 - f1, 1.0),
        ui / torch.clamp(f0, min=1e-30))
    a = torch.zeros_like(t)
    b = torch.ones_like(t)
    # The polynomials' t-free terms, hoisted out of the loop with their
    # rounding unchanged (each is the same left-to-right sum).
    F3 = (1.0 / 3.0) * (-2 * d0 - d1) + f1 - f0
    F4 = 0.25 * (d0 + d1) + 0.5 * (f0 - f1)
    h2 = -2 * d0 - d1 + 3 * (f1 - f0)
    h3 = d0 + d1 + 2 * (f0 - f1)
    hd0 = 0.5 * d0
    for _ in range(16):  # fixed-trip masked Newton-bisection
        t = torch.where((t >= a) & (t <= b), t, 0.5 * (a + b))
        Fhat = t * (f0 + t * (hd0 + t * (F3 + t * F4)))
        fhat = f0 + t * (d0 + t * (h2 + t * h3))
        big = Fhat - ui > 0
        b = torch.where(big, t, b)
        a = torch.where(big, a, t)
        t = t - (Fhat - ui) / torch.where(torch.abs(fhat) > 1e-30, fhat, 1.0)
    r_opt = x0 + width * torch.clamp(t, 0.0, 1.0)
    st = tab.sigma_t.reshape(-1)[tid.long() * 3 + ch]
    return torch.where((st > 0) & (cmax > 0),
                       r_opt / torch.clamp(st, min=1e-30), -1.0)


def _sr_area(tab: SSSTables, tid, ch, r):
    """(Sr(r) / (2 pi r_opt) * sigma_t^2, sigma_t): the area density of
    the profile row (tid, ch) at world radius r, before Pdf_Sr's rho_eff
    and Sp's clamp."""
    st = tab.sigma_t.reshape(-1)[tid.long() * 3 + ch]
    r_opt = r * st
    sr = _eval_profile(tab, tid, ch, r_opt)
    sr = torch.where(r_opt > 0, sr / (2.0 * math.pi
                                      * torch.clamp(r_opt, min=1e-30)), sr)
    return sr * st * st


def pdf_sr(tab: SSSTables, tid, ch, r):
    """TabulatedBSSRDF::Pdf_Sr over lanes (bssrdf.cpp:363-393); tid, ch
    (int or tensor) and r broadcast together."""
    rhoeff = tab.rhoeff.reshape(-1)[tid.long() * 3 + ch]
    return torch.clamp(_sr_area(tab, tid, ch, r) / rhoeff, min=0.0)


def sp(tab: SSSTables, tid, r):
    """Spatial profile Sp(po, pi) = Sr(|po - pi|) per RGB channel
    (bssrdf.h:84-85), [R,3]."""
    ch = torch.arange(3, device=r.device)
    return torch.clamp(_sr_area(tab, tid[..., None], ch, r[..., None]),
                       min=0.0)


# ------------------------------------------------------------------
# Sw exit lobe (bssrdf.h:86-97 + the radiance-mode adapter :153-168)
# ------------------------------------------------------------------

def fr_dielectric(cos_i, eta_i, eta_t):
    """FrDielectric over lanes (core/reflection.cpp:47-72)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    eta_i = torch.as_tensor(eta_i, dtype=cos_i.dtype, device=cos_i.device)
    eta_t = torch.as_tensor(eta_t, dtype=cos_i.dtype, device=cos_i.device)
    entering = cos_i > 0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    st = ei / et * cm.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    tir = st >= 1.0
    ct = cm.sqrt(torch.clamp(1.0 - st * st, min=0.0))
    rpar = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-12)
    rper = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-12)
    return torch.where(tir, 1.0, 0.5 * (rpar * rpar + rper * rper))


def sw_eval(eta, c_sw, cos_w):
    """Sw(w) for radiance transport: (1 - Fr(cos)) / (c pi) * eta^2
    (bssrdf.h:89-93; the adapter, :158-163, multiplies eta^2)."""
    fr = fr_dielectric(cos_w, 1.0, eta)
    return (1.0 - fr) / (c_sw * math.pi) * eta * eta


# ------------------------------------------------------------------
# Sample_Sp: axis/channel/radius selection + bounded probe chain
# ------------------------------------------------------------------

class SpSample(NamedTuple):
    p: Any           # [P,3] exit point pi
    ns: Any          # [P,3] shading normal at pi
    s_over_pdf: Any  # [P,3] Sp / pdf (the betas multiplier)
    ok: Any          # [P] bool: a valid exit interaction was found


_AXIS_PROB = (0.25, 0.25, 0.5)


def sample_sp(scene, bvh, tab: SSSTables, sid, po_p, frame, po_mat, u1, u2,
              active) -> SpSample:
    """SeparableBSSRDF::Sample_Sp over masked lanes (bssrdf.cpp:248-330)
    + Pdf_Sp (bssrdf.cpp:332-352).  frame is po's shading frame
    (ss, ts, ns) = (frame.t, frame.b, frame.n); sid the per-lane table
    index (lanes with sid < 0 never fire)."""
    with spans.span("sss.sample_sp"):
        return _sample_sp(scene, bvh, tab, sid, po_p, frame, po_mat, u1,
                          u2, active)


def _sample_sp(scene, bvh, tab, sid, po_p, frame, po_mat, u1, u2, active):
    P = po_p.shape[0]
    dev = po_p.device
    tid = torch.clamp(sid, min=0).long()

    # --- projection axis (u1 < .5 -> ns, < .75 -> ss, else ts) -------
    ax_ns = u1 < 0.5
    ax_ss = (u1 >= 0.5) & (u1 < 0.75)
    u1r = torch.where(ax_ns, u1 * 2.0, torch.where(ax_ss, (u1 - 0.5) * 4.0,
                                                   (u1 - 0.75) * 4.0))

    def pick(a, b, c):
        return torch.where(ax_ns[..., None], a,
                           torch.where(ax_ss[..., None], b, c))

    ss_, ts_, ns_ = frame.t, frame.b, frame.n
    vx = pick(ss_, ts_, ns_)
    vy = pick(ts_, ns_, ss_)
    vz = pick(ns_, ss_, ts_)

    # --- spectral channel + radius (bssrdf.cpp:273-281) --------------
    ch = torch.clamp((u1r * 3.0).to(torch.int32), 0, 2).long()
    u1c = u1r * 3.0 - ch.to(torch.float32)
    r = sample_sr(tab, tid, ch, u2[:, 0])
    phi = 2.0 * math.pi * u2[:, 1]
    rmax = tab.rmax.reshape(-1)[tid * 3 + ch]
    fail = (r < 0) | (r >= rmax) | ~active
    l = 2.0 * cm.sqrt(torch.clamp(rmax * rmax - r * r, min=0.0))

    # --- bounded probe chain (bssrdf.cpp:283-321) ---------------------
    base = (po_p + r[..., None] * (vx * torch.cos(phi)[..., None]
                                   + vy * torch.sin(phi)[..., None])
            - (0.5 * l)[..., None] * vz)
    remaining = torch.where(fail, 0.0, l)
    eps = 1e-4 * torch.clamp(cm.length(po_p), min=1.0)
    hits_p, hits_ns, valid = [], [], []
    probe_on = ~fail
    for _ in range(PROBE_STEPS):
        o_k = base + eps[..., None] * vz
        t_k = torch.clamp(remaining - 2.0 * eps, min=0.0)
        with spans.span("sss.probe"):
            h = intersect_probe(scene, bvh, o_k, vz,
                                torch.where(probe_on, t_k, 0.0))
        good = h.found & probe_on
        hits_p.append(h.p)
        hits_ns.append(h.ns)
        valid.append(good & (h.mat_id == po_mat))
        adv = torch.where(good, h.t + eps, 0.0)
        base = torch.where(good[..., None], h.p, base)
        remaining = torch.clamp(remaining - adv, min=0.0)
        probe_on = good & (remaining > 2.0 * eps)
    valid = torch.stack(valid, dim=-1)            # [P,K]
    hp = torch.stack(hits_p, dim=1)               # [P,K,3]
    hn = torch.stack(hits_ns, dim=1)
    n_found = torch.sum(valid, dim=-1).to(torch.int32)
    fail = fail | (n_found == 0)

    # --- select one admissible interaction (bssrdf.cpp:322-327) -------
    selected = torch.minimum(
        torch.clamp((u1c * n_found.to(torch.float32)).to(torch.int32),
                    min=0),
        torch.clamp(n_found - 1, min=0))
    rank = torch.cumsum(valid.to(torch.int32), dim=-1) - 1
    hotf = (valid & (rank == selected[..., None])).to(torch.float32)[..., None]
    pi_p = torch.sum(hp * hotf, dim=1)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    pi_ns = cm.normalize(torch.sum(hn * hotf, dim=1)
                         + torch.where(fail, 1.0, 0.0)[..., None] * up)

    # --- Pdf_Sp over 3 axes x 3 channels (bssrdf.cpp:332-352) ---------
    dvec = po_p - pi_p
    d_l = torch.stack([cm.dot(ss_, dvec), cm.dot(ts_, dvec),
                       cm.dot(ns_, dvec)], dim=-1)
    n_l = torch.stack([cm.dot(ss_, pi_ns), cm.dot(ts_, pi_ns),
                       cm.dot(ns_, pi_ns)], dim=-1)
    dd = d_l * d_l
    rproj = cm.sqrt(torch.stack([dd[:, 1] + dd[:, 2], dd[:, 2] + dd[:, 0],
                                 dd[:, 0] + dd[:, 1]], dim=-1))
    chs = torch.arange(3, device=dev)
    pdf_ac = pdf_sr(tab, tid[:, None, None], chs, rproj[..., None])  # [P,3,3]
    axis_prob = torch.tensor(_AXIS_PROB, device=dev)
    terms = (pdf_ac * torch.abs(n_l)[..., None] * axis_prob[:, None]
             * (1.0 / 3.0)).reshape(P, 9)
    pdf = torch.zeros((P,), device=dev)
    for k in range(9):  # the JAX package's order: axis-major, then channel
        pdf = pdf + terms[:, k]
    pdf = pdf / torch.clamp(n_found.to(torch.float32), min=1.0)

    s_val = sp(tab, tid, cm.length(dvec))
    ok = ~fail & (pdf > 0) & torch.any(s_val > 0, dim=-1)
    s_over_pdf = torch.where(
        ok[..., None], s_val / torch.clamp(pdf, min=1e-30)[..., None], 0.0)
    return SpSample(p=pi_p, ns=pi_ns, s_over_pdf=s_over_pdf, ok=ok)


def intersect_probe(scene, bvh, o, d, t_max):
    """Closest hit with material id and shading normal for the probe
    chain: a module-level wrapper, so tests can replace the geometry."""
    from .intersect import intersect_scene

    return intersect_scene(scene, o, d, t_max, bvh, want_tangent=False)


# ------------------------------------------------------------------
# Direct lighting at the exit point with the Sw lobe
# ------------------------------------------------------------------

def estimate_direct_sw(scene, bvh, dist, keys, dstep, pi_p, pi_ns, eta,
                       c_sw, active):
    """UniformSampleOneLight at the SSS exit vertex with the adapter's Sw
    lobe as the BSDF (statpath.cpp:903-914's non-SMIS arm; both halves
    of EstimateDirect, core/integrator.cpp:95-236), with plain
    power-heuristic MIS: the SMIS variant is not replicated at the exit
    vertex, as in the JAX package.  Draws ride the threefry SSS slots."""
    with spans.span("sss.direct"):
        return _estimate_direct_sw(scene, bvh, dist, keys, dstep, pi_p,
                                   pi_ns, eta, c_sw, active)


def _estimate_direct_sw(scene, bvh, dist, keys, dstep, pi_p, pi_ns, eta,
                        c_sw, active):
    from ..core import rng as crng
    from ..scene import build as sb
    from . import bsdf as B
    from . import lights as LT
    from .integrator import _offset_origin, power_heuristic
    from .intersect import intersect_scene, occluded_scene
    from .lightdistrib import sample_light_id

    exit_frame = B.ShadingFrame.from_normal(pi_ns)
    u_sel = crng.uniform_1d(keys, dstep, crng.SLOT_SSS_LIGHT_SELECT)
    u_light = crng.uniform_2d(keys, dstep, crng.SLOT_SSS_LIGHT)
    light_id, sel_pmf = sample_light_id(dist, u_sel, pi_p)
    lsamp = LT.sample_li(scene, light_id, pi_p, pi_ns, u_light)
    cos_wi = cm.dot(lsamp.wi, pi_ns)
    # Reflection-only lobe: wi shares the ns hemisphere with wo = +ns.
    f_l = torch.where(cos_wi > 0, sw_eval(eta, c_sw, cos_wi) * cos_wi, 0.0)
    pdf_scatter = torch.where(cos_wi > 0, cos_wi / math.pi, 0.0)
    lvalid = (active & (lsamp.pdf > 0) & torch.any(lsamp.li > 0, -1)
              & (f_l > 0))
    sh_o = _offset_origin(pi_p, pi_ns, lsamp.wi)
    occ = occluded_scene(
        scene, sh_o, lsamp.wi,
        torch.where(lvalid, torch.clamp(lsamp.dist * 0.999, min=0.0), 0.0),
        bvh)
    li_l = torch.where((lvalid & ~occ)[..., None], lsamp.li, 0.0)
    w_l = torch.where(lsamp.is_delta, 1.0,
                      power_heuristic(1.0, lsamp.pdf, 1.0, pdf_scatter))
    ld = (f_l * w_l / torch.clamp(lsamp.pdf, min=1e-30))[..., None] * li_l

    # BSDF half: cosine-sample the Sw lobe.
    u_bs = crng.uniform_2d(keys, dstep, crng.SLOT_SSS_NEE_BSDF)
    wi_l = B.cosine_sample_hemisphere(u_bs)
    wi_w = exit_frame.to_world(wi_l)
    cos_b = torch.clamp(wi_l[:, 2], min=0.0)
    f_b = sw_eval(eta, c_sw, cos_b) * cos_b
    pdf_b = cos_b / math.pi
    bs_o = _offset_origin(pi_p, pi_ns, wi_w)
    bvalid = active & ~lsamp.is_delta & (pdf_b > 0) & (f_b > 0)
    hit2 = intersect_scene(scene, bs_o, wi_w,
                           torch.where(bvalid, cm.INF, 0.0), bvh, lean=True)
    same_light = hit2.found & (hit2.light_id == light_id)
    li_b_hit = LT.area_light_le(scene, hit2.light_id, hit2.ng, -wi_w)
    is_inf = scene.light_kind[light_id.long()] == sb.LIGHT_INFINITE
    li_b_esc = torch.where(is_inf[..., None],
                           LT.escaped_radiance(scene, wi_w), 0.0)
    li_b = torch.where(same_light[..., None], li_b_hit,
                       torch.where(hit2.found[..., None], 0.0, li_b_esc))
    light_pdf_b = LT.pdf_li(scene, light_id, pi_p, wi_w, hit2.p, hit2.ng,
                            hit2.found)
    w_b = power_heuristic(1.0, pdf_b, 1.0, light_pdf_b)
    add_b = (f_b * w_b / torch.clamp(pdf_b, min=1e-30))[..., None] * li_b
    ld = ld + torch.where((bvalid & (light_pdf_b > 0))[..., None], add_b, 0.0)
    return torch.where(active[..., None],
                       ld / torch.clamp(sel_pmf, min=1e-30)[..., None], 0.0)
