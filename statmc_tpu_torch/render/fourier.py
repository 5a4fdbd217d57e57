# Copied from statmc_tpu/render/fourier.py (numpy host code: FourierFile,
# read_bsdf, write_bsdf, lambertian_file, M_CAP; unchanged); the table
# stacking and the evaluation and sampling below are the port's, in
# PyTorch.
"""FourierBSDF: tabulated BSDF reader + lane-parallel evaluation (port of
statmc_tpu/render/fourier.py).

Replaces the reference's FourierBSDFTable machinery
(src/materials/fourier.cpp:116-206 Read, src/core/reflection.cpp:322-480
FourierBSDF::f/Pdf/Sample_f, src/core/interpolation.cpp:61-103
CatmullRomWeights, :217-361 SampleCatmullRom2D and SampleFourier):

* the on-disk SCATFUN v1 format is parsed bit-exactly, with the same
  subset restrictions (flags == 1, 1 or 3 channels, nBases == 1);
* the variable-length per-(muI, muO) coefficient lists are padded into
  one dense [nMu, nMu, nCh, M] block, so a lane gathers its 4x4
  Catmull-Rom neighbourhood with plain indexing; series longer than
  M_CAP are truncated (a warning reports the dropped tail);
* evaluation follows reflection.cpp:322-377: Catmull-Rom weights with
  the one-sided boundary stencils, the cosine series in the azimuth
  difference, the Y/R/B channels with G = 1.39829 Y - 0.100913 B -
  0.297375 R, the 1/|muI| scale and the radiance-mode eta^2 factor;
* sampling inverts the interpolated muI marginal (SampleCatmullRom2D,
  16 Newton-bisection steps) and the azimuth series (SampleFourier, 20
  steps), fixed counts over the lanes, as the JAX package runs them.

The JAX package runs these over every lane of a bounce; render/bsdf.py
calls them on the Fourier lanes only (every op is per lane, so each
lane's result is the same).  The node searches count nodes below x,
integer work equal to the JAX package's.  The arccos, sines and cosines
of the azimuth and the sums of its series are taken in float64 and
rounded once, square roots correctly rounded (core/math.py sqrt), so
the CPU and the card agree: a CPU and a GPU sum the 16-64 terms of a
series in different orders, and the samplers' fixed Newton steps carry
such an ulp along their paths.
"""
from __future__ import annotations

import math
import struct
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import spans
from ..core import math as cm

M_CAP = 64  # dense padded Fourier-order cap (see module docstring)

_HEADER = b"SCATFUN\x01"


class FourierFile(NamedTuple):
    """Host-side parse of one .bsdf file (numpy)."""
    mu: np.ndarray      # [nMu] zenith cosine nodes (ascending)
    cdf: np.ndarray     # [nMu, nMu] marginal CDF (sampling)
    m: np.ndarray       # [nMu, nMu] int series length per node pair
    ak: np.ndarray      # [nMu, nMu, nCh, M] dense padded coefficients
    eta: float
    n_channels: int
    m_max: int          # the file's true mMax (before padding/truncation)


def read_bsdf(path: str, m_cap: int = M_CAP) -> FourierFile:
    """Parse a SCATFUN v1 .bsdf file (materials/fourier.cpp:116-206)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _HEADER:
        raise ValueError(f"{path}: not a SCATFUN v1 file")
    ints = np.frombuffer(data, dtype="<i4", offset=8, count=9)
    flags, n_mu, n_coeffs, m_max, n_channels, n_bases = ints[:6]
    (eta,) = struct.unpack_from("<f", data, 8 + 9 * 4)
    # 4 more unused int32 slots follow eta (fourier.cpp:158-162).
    off = 8 + 9 * 4 + 4 + 4 * 4
    if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
        raise ValueError(
            f"{path}: unsupported SCATFUN variant (flags={flags}, "
            f"channels={n_channels}, bases={n_bases})")
    mu = np.frombuffer(data, dtype="<f4", offset=off, count=n_mu)
    off += 4 * n_mu
    cdf = np.frombuffer(data, dtype="<f4", offset=off,
                        count=n_mu * n_mu).reshape(n_mu, n_mu)
    off += 4 * n_mu * n_mu
    ol = np.frombuffer(data, dtype="<i4", offset=off,
                       count=n_mu * n_mu * 2).reshape(n_mu * n_mu, 2)
    off += 8 * n_mu * n_mu
    a = np.frombuffer(data, dtype="<f4", offset=off, count=n_coeffs)

    m_arr = ol[:, 1].reshape(n_mu, n_mu)
    M = min(int(m_max), m_cap) if m_max > 0 else 1
    ak = np.zeros((n_mu, n_mu, n_channels, M), np.float32)
    dropped = 0.0
    for i in range(n_mu * n_mu):
        offset, length = int(ol[i, 0]), int(ol[i, 1])
        if length <= 0:
            continue
        take = min(length, M)
        # per-pair layout is [nCh, m] contiguous (reflection.cpp:352).
        blk = a[offset:offset + n_channels * length].reshape(
            n_channels, length)
        ak[i // n_mu, i % n_mu, :, :take] = blk[:, :take]
        if length > M:
            dropped = max(dropped, float(np.abs(blk[:, M:]).max()))
    if dropped > 0:
        import logging
        logging.getLogger("statmc_tpu_torch.fourier").warning(
            "%s: Fourier series truncated at %d orders "
            "(largest dropped coefficient %.3g)", path, M, dropped)
    return FourierFile(mu=np.asarray(mu, np.float32),
                       cdf=np.asarray(cdf, np.float32),
                       m=np.minimum(m_arr, M).astype(np.int32),
                       ak=ak, eta=float(eta), n_channels=int(n_channels),
                       m_max=int(m_max))


def write_bsdf(path: str, mu: np.ndarray, ak_list, eta: float = 1.0,
               n_channels: int = 1) -> None:
    """Write a SCATFUN v1 file (test/tool generator; inverse of
    read_bsdf, format per materials/fourier.cpp:148-186).

    ak_list: nested [nMu][nMu] -> [nCh, m] float arrays (m may vary)."""
    n_mu = len(mu)
    coeffs, offlen = [], []
    off = 0
    m_max = 0
    for i in range(n_mu):
        for o in range(n_mu):
            blk = np.asarray(ak_list[i][o], np.float32).reshape(
                n_channels, -1)
            m = blk.shape[1] if blk.size else 0
            if m and not np.any(blk):
                m = 0
            offlen.append((off, m))
            if m:
                coeffs.append(blk[:, :m].reshape(-1))
                off += n_channels * m
                m_max = max(m_max, m)
    a = (np.concatenate(coeffs) if coeffs
         else np.zeros((0,), np.float32))
    # Marginal CDF rows per muO: IntegrateCatmullRom of the order-0
    # luminance coefficient over muI (interpolation.cpp:293-322) -- the
    # table the importance sampler inverts, so it must be the true
    # integral of the a0 spline.
    # ak_list is [muO][muI]-major (file pair order, reflection.h:166):
    # cdf row o must integrate a0 ALONG muI at fixed muO.
    a0 = np.zeros((n_mu, n_mu), np.float64)
    for o in range(n_mu):
        for i in range(n_mu):
            blk = np.asarray(ak_list[o][i], np.float64).reshape(
                n_channels, -1)
            a0[o, i] = blk[0, 0] if blk.size else 0.0
    x = np.asarray(mu, np.float64)
    cdf = np.zeros((n_mu, n_mu), np.float64)
    for o in range(n_mu):
        vals = a0[o]
        for i in range(n_mu - 1):
            x0, x1 = x[i], x[i + 1]
            f0, f1 = vals[i], vals[i + 1]
            width = x1 - x0
            d0 = (width * (f1 - vals[i - 1]) / (x1 - x[i - 1])
                  if i > 0 else f1 - f0)
            d1 = (width * (vals[i + 2] - f0) / (x[i + 2] - x0)
                  if i + 2 < n_mu else f1 - f0)
            cdf[o, i + 1] = cdf[o, i] + (
                (d0 - d1) / 12.0 + (f0 + f1) * 0.5) * width
        # The Hermite integral of a DISCONTINUOUS profile (reflection
        # tables step to zero across muI=0) can dip locally; the
        # inversion requires a monotone cdf.
        cdf[o] = np.maximum.accumulate(cdf[o])
    cdf = cdf.astype(np.float32)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(np.asarray(
            [1, n_mu, a.size, m_max, n_channels, 1, 0, 0, 0],
            "<i4").tobytes())
        f.write(struct.pack("<f", eta))
        f.write(np.zeros(4, "<i4").tobytes())
        f.write(np.asarray(mu, "<f4").tobytes())
        f.write(np.asarray(cdf, "<f4").tobytes())
        f.write(np.asarray(offlen, "<i4").tobytes())
        f.write(np.asarray(a, "<f4").tobytes())


def lambertian_file(albedo, n_mu: int = 16) -> tuple[np.ndarray, list]:
    """(mu nodes, ak_list) for an ideal Lambertian reflector: the
    azimuth-constant series a_0 = rho/pi * |muI| (the table stores
    f * |muI|, cf. the 1/|muI| scale in reflection.cpp:359).

    Conventions baked in: muI = CosTheta(-wi), so REFLECTION entries
    live where muI and muO have opposite signs; 3-channel files store
    [Y, R, B] with G reconstructed at eval (reflection.cpp:369-373);
    ak_list is [muO][muI]-major like the file (reflection.h:166)."""
    albedo = np.atleast_1d(np.asarray(albedo, np.float32))
    if albedo.shape[0] == 3:
        y = (0.212671 * albedo[0] + 0.715160 * albedo[1]
             + 0.072169 * albedo[2])
        chans = np.array([y, albedo[0], albedo[2]], np.float32)
    else:
        chans = albedo
    nch = chans.shape[0]
    mu = np.linspace(-1.0, 1.0, n_mu, dtype=np.float32)
    ak = [[np.zeros((nch, 1), np.float32) for _ in range(n_mu)]
          for _ in range(n_mu)]
    for o, mo in enumerate(mu):
        for i, mi in enumerate(mu):
            if mi * mo < 0:  # reflection side
                ak[o][i] = (chans[:, None] / np.pi
                            * np.float32(abs(mi)))
    return mu, ak


class FourierTables(NamedTuple):
    """Stacked tables for every fourier material in a scene (numpy from
    stack_tables; to_device lifts them to tensors).

    Tables are padded to the largest (nMu, M) among them; `n_mu` keeps
    each table's true node count (padded mu nodes lie past the last
    node, so the node search never lands in them)."""
    mu: Any      # [F, nMuP]
    n_mu: Any    # [F] int32
    ak: Any      # [F, nMuP, nMuP, 3, MP]  (1-channel files replicated)
    eta: Any     # [F]
    n_channels: Any  # [F] int32
    # Importance-sampling tables (reflection.cpp:379-427 Sample_f/Pdf):
    cdf: Any = None   # [F, nMuP, nMuP] marginal CDF rows (muO-major)
    a0: Any = None    # [F, nMuP, nMuP] order-0 luminance coefficient

    def to_device(self, device="cpu") -> "FourierTables":
        return FourierTables(*[torch.as_tensor(np.asarray(x), device=device)
                               for x in self])


def stack_tables(files: list[FourierFile]) -> FourierTables:
    F = len(files)
    n_mu_p = max(f.mu.shape[0] for f in files)
    m_p = max(f.ak.shape[-1] for f in files)
    mu = np.zeros((F, n_mu_p), np.float32)
    ak = np.zeros((F, n_mu_p, n_mu_p, 3, m_p), np.float32)
    n_mu = np.zeros((F,), np.int32)
    eta = np.zeros((F,), np.float32)
    nch = np.zeros((F,), np.int32)
    cdf = np.zeros((F, n_mu_p, n_mu_p), np.float32)
    for i, fl in enumerate(files):
        n = fl.mu.shape[0]
        mu[i, :n] = fl.mu
        mu[i, n:] = fl.mu[-1] + 1.0  # out-of-range guard nodes
        a = fl.ak
        if fl.n_channels == 1:
            a = np.repeat(a, 3, axis=2)
        ak[i, :n, :n, :, :a.shape[-1]] = a
        cdf[i, :n, :n] = fl.cdf
        # Pad columns with the row maximum so the search never lands
        # past the true node range.
        if n < n_mu_p:
            cdf[i, :n, n:] = fl.cdf[:, -1:]
        n_mu[i] = n
        eta[i] = fl.eta
        nch[i] = fl.n_channels
    a0 = ak[:, :, :, 0, 0]  # Y-channel order-0 coefficient (muO-major)
    return FourierTables(mu=mu, n_mu=n_mu, ak=ak, eta=eta, n_channels=nch,
                         cdf=cdf, a0=np.ascontiguousarray(a0))


def _take(arr, idx):
    """arr[r, idx[r]] for a [R, N] table and [R] int indices."""
    return torch.gather(arr, 1, idx.long()[:, None])[:, 0]


def _catmull_rom_weights(nodes, n, x):
    """Lane-parallel CatmullRomWeights (interpolation.cpp:61-103).

    nodes: [R, nMuP] per-lane node row; n: [R] true node count; x: [R].
    Returns (offset [R] int32, weights [R, 4], ok [R])."""
    nP = nodes.shape[1]
    n = n.long()
    first = nodes[:, 0]
    last = _take(nodes, n - 1)
    # Frame rotations leave |cos| a few ulp beyond 1.0; tolerate 1e-5 of
    # overhang and clamp into the node range (as the JAX package does).
    ok = (x >= first - 1e-5) & (x <= last + 1e-5)
    x = torch.minimum(torch.maximum(x, first), last)
    # FindInterval: the largest idx with nodes[idx] <= x, clamped to
    # [0, n-2] as pbrt's FindInterval; offset = idx - 1.
    iota = torch.arange(nP, device=x.device)
    le = (nodes <= x[:, None]) & (iota[None, :] < n[:, None])
    idx = le.sum(1) - 1
    idx = torch.minimum(torch.clamp(idx, min=0),
                        torch.clamp(n - 2, min=0))
    x0 = _take(nodes, idx)
    x1 = _take(nodes, torch.minimum(idx + 1, n - 1))
    t = (x - x0) / torch.where(x1 > x0, x1 - x0, 1.0)
    t2 = t * t
    t3 = t2 * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    # First node weight (one-sided at the boundary).
    xm1 = _take(nodes, torch.clamp(idx - 1, min=0))
    w0_in = (t3 - 2 * t2 + t) * (x1 - x0) / torch.where(
        x1 > xm1, x1 - xm1, 1.0)
    w0_edge = t3 - 2 * t2 + t
    has_m1 = idx > 0
    w0 = torch.where(has_m1, -w0_in, 0.0)
    w1 = torch.where(has_m1, w1, w1 - w0_edge)
    w2 = w2 + torch.where(has_m1, w0_in, w0_edge)
    # Last node weight.
    xp2 = _take(nodes, torch.minimum(idx + 2, n - 1))
    w3_in = (t3 - t2) * (x1 - x0) / torch.where(xp2 > x0, xp2 - x0, 1.0)
    w3_edge = t3 - t2
    has_p2 = idx + 2 < n
    w1 = w1 - torch.where(has_p2, w3_in, w3_edge)
    w2 = w2 + torch.where(has_p2, 0.0, w3_edge)
    w3 = torch.where(has_p2, w3_in, 0.0)
    weights = torch.stack([w0, w1, w2, w3], dim=-1)
    return (idx - 1).to(torch.int32), weights, ok


def _cos_dphi(wo, wi):
    """CosDPhi(-wi, wo) (geometry.h): the azimuth-difference cosine."""
    num = wi[:, 0] * wo[:, 0] + wi[:, 1] * wo[:, 1]
    den2 = ((wi[:, 0] ** 2 + wi[:, 1] ** 2)
            * (wo[:, 0] ** 2 + wo[:, 1] ** 2))
    return torch.where(den2 > 1e-20, torch.clamp(
        -num / cm.sqrt(torch.clamp(den2, min=1e-20)), -1.0, 1.0), 1.0)


def _arccos(x):
    return torch.arccos(x.double()).float()


def _sum64(x, dim: int):
    """A float32 sum taken in float64 and rounded once."""
    return torch.sum(x.double(), dim=dim).float()


def _cos_series(ak, phi):
    """sum_k ak[..., k] cos(k phi), the cosines and the sum in float64,
    rounded once; ak [R, (C,) MP], phi [R]."""
    MP = ak.shape[-1]
    k = torch.arange(MP, dtype=torch.float32, device=phi.device)
    cosk = torch.cos((k[None, :] * phi[:, None]).double()).float()
    if ak.dim() == 3:
        return _sum64(ak * cosk[:, None, :], -1)
    return _sum64(ak * cosk, 1)


def eval_f(tab: FourierTables, fid, wo, wi):
    """FourierBSDF::f over lanes (reflection.cpp:322-377).

    fid: [R] table index (lanes with fid < 0 return 0); wo/wi: [R, 3] in
    the local shading frame.  Returns RGB f [R, 3]."""
    with spans.span("fourier.eval"):
        R = wo.shape[0]
        f = torch.clamp(fid, min=0).long()
        mu_rows = tab.mu[f]
        n_rows = tab.n_mu[f]
        mu_i = -wi[:, 2]
        mu_o = wo[:, 2]
        cos_phi = _cos_dphi(wo, wi)
        oi, wI, okI = _catmull_rom_weights(mu_rows, n_rows, mu_i)
        oo, wO, okO = _catmull_rom_weights(mu_rows, n_rows, mu_o)
        ok = okI & okO & (fid >= 0)

        MP = tab.ak.shape[-1]
        nP = tab.ak.shape[1]
        ak_flat = tab.ak.reshape(tab.ak.shape[0] * nP * nP, 3, MP)
        acc = torch.zeros((R, 3, MP), device=wo.device)
        for b in range(4):
            for a in range(4):
                w = (wI[:, a] * wO[:, b])[:, None, None]
                ii = torch.clamp(oi + a, 0, nP - 1).long()
                jj = torch.clamp(oo + b, 0, nP - 1).long()
                # File layout is [muO, muI]-major: GetAk reads
                # m[offsetO * nMu + offsetI] (reflection.h:166-169).
                acc = acc + w * ak_flat[(f * nP + jj) * nP + ii]
        phi = _arccos(cos_phi)
        sums = _cos_series(acc, phi)  # [R, 3]: Y, R, B
        Y = torch.clamp(sums[:, 0], min=0.0)
        scale = torch.where(torch.abs(mu_i) > 1e-12,
                            1.0 / torch.abs(mu_i), 0.0)
        # Radiance-transport adjoint factor (reflection.cpp:361-365).
        eta_t = tab.eta[f]
        same_side = mu_i * mu_o > 0
        eta_f = torch.where(mu_i > 0, 1.0 / eta_t, eta_t)
        scale = scale * torch.where(same_side, eta_f * eta_f, 1.0)
        Rc = sums[:, 1]
        Bc = sums[:, 2]
        G = 1.39829 * Y - 0.100913 * Bc - 0.297375 * Rc
        rgb = torch.stack([Rc, G, Bc], dim=-1)
        mono = Y[:, None].expand(rgb.shape)
        out = torch.where((tab.n_channels[f] == 1)[:, None], mono, rgb)
        out = torch.clamp(out * scale[:, None], min=0.0)
        return torch.where(ok[:, None], out, 0.0)


def _interp_over_muo(flat_rows, f, oo, wO, nP):
    """sum_b wO[:, b] * table[f, clip(oo+b), :] for a [F*nP, nP] flat
    table: the `interpolate` lambda of SampleCatmullRom2D."""
    out = 0.0
    for b in range(4):
        rows = flat_rows[f * nP + torch.clamp(oo + b, 0, nP - 1).long()]
        out = out + wO[:, b:b + 1] * rows
    return out


def sample_mu_i(tab: FourierTables, fid, mu_o, u):
    """SampleCatmullRom2D over the muI marginal: returns
    (mu_i [R], pdf_mu [R], ok [R])."""
    R = mu_o.shape[0]
    f = torch.clamp(fid, min=0).long()
    nP = tab.mu.shape[1]
    mu_rows = tab.mu[f]
    n_rows = tab.n_mu[f].long()
    oo, wO, okO = _catmull_rom_weights(mu_rows, n_rows, mu_o)

    cdf_i = _interp_over_muo(tab.cdf.reshape(-1, nP), f, oo, wO, nP)
    a0_i = _interp_over_muo(tab.a0.reshape(-1, nP), f, oo, wO, nP)

    maximum = _take(cdf_i, n_rows - 1)
    ok = okO & (maximum > 0)
    uu = u * maximum
    valid_col = torch.arange(nP, device=u.device)[None, :] < n_rows[:, None]
    le = (cdf_i <= uu[:, None]) & valid_col
    idx = torch.minimum(torch.clamp(le.sum(1) - 1, min=0),
                        torch.clamp(n_rows - 2, min=0))

    def take(arr, i):
        return _take(arr, torch.clamp(i, 0, nP - 1))

    f0 = take(a0_i, idx)
    f1 = take(a0_i, idx + 1)
    x0 = take(mu_rows, idx)
    x1 = take(mu_rows, idx + 1)
    width = torch.clamp(x1 - x0, min=1e-12)
    uu = (uu - take(cdf_i, idx)) / width
    d0 = torch.where(idx > 0,
                     width * (f1 - take(a0_i, idx - 1))
                     / torch.clamp(x1 - take(mu_rows, idx - 1), min=1e-12),
                     f1 - f0)
    d1 = torch.where(idx + 2 < n_rows,
                     width * (take(a0_i, idx + 2) - f0)
                     / torch.clamp(take(mu_rows, idx + 2) - x0, min=1e-12),
                     f1 - f0)

    # Hermite-segment inversion (interpolation.cpp:246-286).
    lin = torch.abs(f0 - f1) > 1e-12
    t = torch.where(
        lin,
        (f0 - cm.sqrt(torch.clamp(f0 * f0 + 2.0 * uu * (f1 - f0),
                                  min=0.0)))
        / torch.where(lin, f0 - f1, 1.0),
        uu / torch.clamp(f0, min=1e-12))
    a = torch.zeros((R,), device=u.device)
    b = torch.ones((R,), device=u.device)
    fhat = f0
    for _ in range(16):
        t = torch.where((t >= a) & (t <= b), t, 0.5 * (a + b))
        Fhat = t * (f0 + t * (0.5 * d0
                              + t * ((1.0 / 3.0) * (-2 * d0 - d1)
                                     + f1 - f0
                                     + t * (0.25 * (d0 + d1)
                                            + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                   + t * (d0 + d1 + 2 * (f0 - f1))))
        below = Fhat - uu < 0
        a = torch.where(below, t, a)
        b = torch.where(below, b, t)
        t = t - (Fhat - uu) / torch.where(torch.abs(fhat) > 1e-12, fhat, 1.0)
    pdf_mu = torch.where(ok, torch.clamp(fhat, min=0.0)
                         / torch.clamp(maximum, min=1e-20), 0.0)
    return x0 + width * torch.clamp(t, 0.0, 1.0), pdf_mu, ok


def _luminance_ak(tab: FourierTables, f, mu_i, mu_o):
    """4x4-interpolated Y-channel coefficient vector [R, MP] + ok."""
    nP = tab.mu.shape[1]
    MP = tab.ak.shape[-1]
    mu_rows = tab.mu[f]
    n_rows = tab.n_mu[f]
    oi, wI, okI = _catmull_rom_weights(mu_rows, n_rows, mu_i)
    oo, wO, okO = _catmull_rom_weights(mu_rows, n_rows, mu_o)
    akY_flat = tab.ak[:, :, :, 0, :].reshape(-1, MP)
    acc = torch.zeros((mu_i.shape[0], MP), device=mu_i.device)
    for b in range(4):
        for a in range(4):
            w = (wI[:, a] * wO[:, b])[:, None]
            ii = torch.clamp(oi + a, 0, nP - 1).long()
            jj = torch.clamp(oo + b, 0, nP - 1).long()
            acc = acc + w * akY_flat[(f * nP + jj) * nP + ii]
    return acc, okI & okO, oo, wO


def _sample_fourier_phi(akY, u):
    """SampleFourier (interpolation.cpp:292-361): invert
    F(phi) = a0 phi + sum ak sin(k phi)/k on [0, pi], 20 fixed
    Newton-bisection steps; sines, cosines and sums in float64, rounded
    once."""
    R, MP = akY.shape
    dev = akY.device
    flip = u >= 0.5
    uu = torch.where(flip, 1.0 - 2.0 * (u - 0.5), 2.0 * u)
    ks = torch.arange(MP, dtype=torch.float32, device=dev)
    recip = torch.where(ks > 0, 1.0 / torch.clamp(ks, min=1.0), 0.0)
    a = torch.zeros((R,), device=dev)
    b = torch.full((R,), math.pi, device=dev)
    phi = torch.full((R,), 0.5 * math.pi, device=dev)
    a0 = akY[:, 0]
    fv = a0
    for _ in range(20):
        kphi = (ks[None, :] * phi[:, None]).double()
        sin_k = torch.sin(kphi).float()
        cos_k = torch.cos(kphi).float()
        F = a0 * phi + _sum64(akY[:, 1:] * recip[None, 1:] * sin_k[:, 1:], 1)
        fv = _sum64(akY * cos_k, 1)
        F = F - uu * a0 * math.pi
        hi = F > 0
        b = torch.where(hi, phi, b)
        a = torch.where(hi, a, phi)
        step = phi - F / torch.where(torch.abs(fv) > 1e-12, fv, 1.0)
        inb = (step > a) & (step < b) & torch.isfinite(step)
        phi = torch.where(inb, step, 0.5 * (a + b))
    pdf_phi = torch.where(a0 > 0, (0.5 / math.pi) * fv
                          / torch.clamp(a0, min=1e-20), 0.0)
    phi = torch.where(flip, 2.0 * math.pi - phi, phi)
    return phi, torch.clamp(pdf_phi, min=0.0)


def sample_wi(tab: FourierTables, fid, wo, u2):
    """FourierBSDF::Sample_f direction (reflection.cpp:429-480):
    returns (wi [R,3], pdf [R])."""
    with spans.span("fourier.sample"):
        mu_o = wo[:, 2]
        f = torch.clamp(fid, min=0).long()
        mu_i, pdf_mu, ok_mu = sample_mu_i(tab, f, mu_o, u2[:, 1])
        akY, ok_ak, _, _ = _luminance_ak(tab, f, mu_i, mu_o)
        phi, pdf_phi = _sample_fourier_phi(akY, u2[:, 0])
        sin2_i = torch.clamp(1.0 - mu_i * mu_i, min=0.0)
        sin2_o = torch.clamp(wo[:, 0] ** 2 + wo[:, 1] ** 2, min=1e-20)
        norm = cm.sqrt(sin2_i / sin2_o)
        norm = torch.where(torch.isfinite(norm), norm, 0.0)
        phid = phi.double()
        sp, cp = torch.sin(phid).float(), torch.cos(phid).float()
        wi = -torch.stack([norm * (cp * wo[:, 0] - sp * wo[:, 1]),
                           norm * (sp * wo[:, 0] + cp * wo[:, 1]),
                           mu_i], dim=-1)
        wi = wi / torch.clamp(cm.sqrt(torch.sum(wi * wi, -1, keepdim=True)),
                              min=1e-12)
        pdf = torch.where(ok_mu & ok_ak,
                          torch.clamp(pdf_mu * pdf_phi, min=0.0), 0.0)
        return wi, pdf


def pdf_wi(tab: FourierTables, fid, wo, wi):
    """FourierBSDF::Pdf (reflection.cpp:379-427)."""
    with spans.span("fourier.eval"):
        f = torch.clamp(fid, min=0).long()
        nP = tab.mu.shape[1]
        mu_i = -wi[:, 2]
        mu_o = wo[:, 2]
        akY, ok, oo, wO = _luminance_ak(tab, f, mu_i, mu_o)
        phi = _arccos(_cos_dphi(wo, wi))
        Y = _cos_series(akY, phi)
        n_rows = tab.n_mu[f].long()
        cdf_flat = tab.cdf.reshape(-1, nP)
        rho = 0.0
        for b in range(4):
            row = cdf_flat[f * nP + torch.clamp(oo + b, 0, nP - 1).long()]
            rho = rho + wO[:, b] * _take(row, n_rows - 1) * (2.0 * math.pi)
        return torch.where(ok & (rho > 0) & (Y > 0),
                           Y / torch.clamp(rho, min=1e-20), 0.0)
