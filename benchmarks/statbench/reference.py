"""The plain reference: straightforward PyTorch and NumPy, in float64, for
what the timed path produces.  It imports nothing of the program, and it
reads only the inputs that the benchmark made (the scene's geometry, the
denoise frames) and, to judge them, the program's outputs.

- ``closest_hits``: the closest triangle or sphere along each ray within
  (eps, t_max), by testing every triangle and sphere (Moller-Trumbore;
  the quadratic), with the eps the port's kernels state (1e-4 for
  triangles, 1e-3 for spheres).
- ``moments``: n, the mean, M2 and M3 of a pixel's samples, in the
  Box-Cox domain (lambda = 0.5) for a transformed stream, with the raw
  film mean and M2 beside them, by two passes over the samples.
- ``corrected_stats`` and ``filter_at``: the statistical joint-bilateral
  filter (StatMC): the Johnson-corrected mean and its t-interval
  half-width, the two-sample test of every (pixel, neighbour) pair of the
  (2r+1)^2 window, the spatial and G-buffer range Gaussians, and the
  normalized average of the accepted neighbours' film means.

Every function takes `dtype`: float64 is the reference; the control puts
the same arithmetic in bfloat16 in the program's place.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
TRI_EPS, SPH_EPS = 1e-4, 1e-3
# Two-sided level of the filter's test and the largest degrees of freedom
# it distinguishes (past it, the quantile of MAX_DF), as StatMC sets them.
ALPHA, MAX_DF = 0.005, 256


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def closest_hits(o, d, t_max, tris, centres, radii, dtype=F64,
                 pairs_per_block: int = 1 << 23):
    """Rays o, d [R,3], t_max [R]; tris [T,3,3]; spheres centres [S,3],
    radii [S].  Returns (t [R], kind [R], index [R]): kind 0 where
    nothing lies in (eps, t_max), 1 a triangle, 2 a sphere; t is inf
    where kind is 0; index names the triangle or sphere (0 where kind is
    0)."""
    dev = o.device
    o, d, t_max = (x.to(dtype) for x in (o, d, t_max))
    v0 = tris[:, 0].to(dev, dtype)
    e1 = (tris[:, 1] - tris[:, 0]).to(dev, dtype)
    e2 = (tris[:, 2] - tris[:, 0]).to(dev, dtype)
    c, r = centres.to(dev, dtype), radii.to(dev, dtype)
    R, T = o.shape[0], v0.shape[0]
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    t_out = torch.full((R,), float("inf"), dtype=dtype, device=dev)
    kind = torch.zeros((R,), dtype=torch.int64, device=dev)
    index = torch.zeros((R,), dtype=torch.int64, device=dev)
    step = max(1, pairs_per_block // max(T, 1))
    for a in range(0, R, step):
        ob, db = o[a:a + step, None], d[a:a + step, None]
        tm = t_max[a:a + step]
        n = ob.shape[0]
        tri_best = torch.full((n,), float("inf"), dtype=dtype, device=dev)
        tri_i = torch.zeros((n,), dtype=torch.int64, device=dev)
        if T:
            pvec = _cross(db, e2[None])
            det = _dot(e1[None], pvec)
            inv = 1.0 / det
            tvec = ob - v0[None]
            u = _dot(tvec, pvec) * inv
            qvec = _cross(tvec, e1[None])
            v = _dot(db, qvec) * inv
            t = _dot(e2[None], qvec) * inv
            ok = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
                  & (t > TRI_EPS) & (t < tm[:, None]))
            tri_best, tri_i = torch.where(ok, t, inf).min(-1)
        sph_best = torch.full_like(tri_best, float("inf"))
        sph_i = torch.zeros_like(tri_i)
        if c.shape[0]:
            oc = ob - c[None]
            b = _dot(oc, db)
            cc = _dot(oc, oc) - r[None] * r[None]
            aa = _dot(db, db)
            disc = b * b - aa * cc
            sq = torch.sqrt(torch.clamp(disc, min=0))
            t0, t1 = (-b - sq) / aa, (-b + sq) / aa
            ts = torch.where(t0 > SPH_EPS, t0, t1)
            ok = (disc >= 0) & (ts > SPH_EPS) & (ts < tm[:, None])
            sph_best, sph_i = torch.where(ok, ts, inf).min(-1)
        best = torch.minimum(tri_best, sph_best)
        is_sph = sph_best < tri_best
        t_out[a:a + step] = best
        kind[a:a + step] = torch.where(torch.isinf(best), 0,
                                       torch.where(is_sph, 2, 1))
        index[a:a + step] = torch.where(
            torch.isinf(best), 0, torch.where(is_sph, sph_i, tri_i))
    return t_out, kind, index


def box_cox(x):
    return 2.0 * (torch.sqrt(x) - 1.0)


def moments(x, mask, transform: bool, dtype=F64):
    """Samples x [K,S,C] with mask [K,S] (a sample that counts) -> n [K],
    mean, m2, m3 [K,C] (of the Box-Cox values when transform) and, when
    transform, film_mean, film_m2 [K,C] of the raw values."""
    x = x.to(dtype)
    w = mask.to(dtype)[..., None]
    n = w.sum(1)
    ns = torch.clamp(n, min=1)
    y = box_cox(torch.clamp(x, min=0)) if transform else x
    mean = (w * y).sum(1) / ns
    dy = (y - mean[:, None]) * w
    out = {"n": n[:, 0], "mean": mean, "m2": (dy * dy).sum(1),
           "m3": (dy * dy * dy).sum(1)}
    if transform:
        fm = (w * x).sum(1) / ns
        dx = (x - fm[:, None]) * w
        out["film_mean"] = fm
        out["film_m2"] = (dx * dx).sum(1)
    return out


def t_quantiles(alpha: float = ALPHA, max_df: int = MAX_DF) -> np.ndarray:
    """q[df] = t_{1 - alpha/2}(df) for df = 0..max_df; df = 0 (one sample
    or none) has no variance estimate and accepts every neighbour."""
    from scipy.stats import t as student_t

    q = np.empty(max_df + 1)
    q[0] = 1e30
    q[1:] = student_t.ppf(1.0 - alpha / 2.0, np.arange(1, max_df + 1))
    return q


def corrected_stats(n, mean, m2, m3, tq, dtype=F64):
    """n [...], mean/m2/m3 [...,C] -> (mean_corr, half-width d) [...,C]:
    mean + m3/(6 s^2 n^2) (Johnson's correction, 0 where s^2 = 0), and
    t_{1-alpha/2}(n-1) sqrt(s^2/n) with s^2 = m2/(n-1)."""
    n, mean, m2, m3 = (x.to(dtype) for x in (n, mean, m2, m3))
    nf = torch.clamp(n, min=1)[..., None]
    s2 = m2 / torch.clamp(nf - 1, min=1)
    corr = torch.where(s2 > 1e-12,
                       (m3 / nf) / torch.clamp(6 * s2 * nf, min=1e-12), 0)
    df = torch.clamp(n - 1, 0, len(tq) - 1).long()
    tcrit = torch.as_tensor(tq, device=n.device).to(dtype)[df][..., None]
    return mean + corr, tcrit * torch.sqrt(torch.clamp(s2 / nf, min=0))


def filter_at(ys, xs, mc, d, fm, gb, gb_sd, radius: int, filter_sd: float,
              dtype=F64):
    """The filter's output at pixels (ys, xs) [K]: mc, d, fm [H,W,C] and
    G-buffer planes gb [H,W,G] with one standard deviation a plane.
    Neighbours outside the image take no part.  Returns
    (film_mean_f [K,C], accepted pairs [K], in-image pairs [K])."""
    H, W, _ = mc.shape
    dev = mc.device
    r = int(radius)
    off = torch.arange(-r, r + 1, device=dev)
    yy = ys[:, None, None] + off[None, :, None]
    xx = xs[:, None, None] + off[None, None, :]
    inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    yc, xc = yy.clamp(0, H - 1), xx.clamp(0, W - 1)

    def at(a, y, x):
        return a[y, x].to(dtype)

    mc_i, d_i = at(mc, ys, xs)[:, None, None], at(d, ys, xs)[:, None, None]
    mc_j, d_j = at(mc, yc, xc), at(d, yc, xc)
    diff = mc_i - mc_j
    accept = torch.all(diff * diff <= d_i * d_i + d_j * d_j + 1e-20, -1)
    accept = accept & inside
    ds = -0.5 / (filter_sd * filter_sd)
    arg = ds * (off[None, :, None] ** 2 + off[None, None, :] ** 2).to(dtype)
    gf = torch.tensor([-0.5 / (s * s) for s in gb_sd], device=dev,
                      dtype=dtype)
    dg = at(gb, ys, xs)[:, None, None] - at(gb, yc, xc)
    arg = arg + (gf * dg * dg).sum(-1)
    w = torch.exp(arg) * accept.to(dtype)
    num = (w[..., None] * at(fm, yc, xc)).sum((1, 2))
    out = num / torch.clamp(w.sum((1, 2)), min=1e-20)[:, None]
    return out, accept.sum((1, 2)), inside.sum((1, 2))


def accepted_pairs(mc, d, radius: int):
    """(in-image pairs, accepted pairs) of the whole image's (2r+1)^2
    windows under the filter's test, in float64; mc, d [H,W,C]."""
    H, W, _ = mc.shape
    mc, d = mc.to(F64), d.to(F64)
    d2 = d * d
    pairs = accepted = 0
    r = int(radius)
    for dy in range(-r, r + 1):
        ys, yj = (slice(max(0, -dy), H - max(0, dy)),
                  slice(max(0, dy), H - max(0, -dy)))
        for dx in range(-r, r + 1):
            xs, xj = (slice(max(0, -dx), W - max(0, dx)),
                      slice(max(0, dx), W - max(0, -dx)))
            diff = mc[ys, xs] - mc[yj, xj]
            ok = torch.all(diff * diff <= d2[ys, xs] + d2[yj, xj] + 1e-20, -1)
            pairs += ok.numel()
            accepted = accepted + ok.sum()
    return pairs, int(accepted)


def film_rgb(rgb):
    """pbrt's RGB -> XYZ -> RGB round trip of the film (spectrum.h's
    RGBToXYZ and XYZToRGB)."""
    to_xyz = torch.tensor([[0.412453, 0.357580, 0.180423],
                           [0.212671, 0.715160, 0.072169],
                           [0.019334, 0.119193, 0.950227]],
                          dtype=rgb.dtype, device=rgb.device)
    to_rgb = torch.tensor([[3.240479, -1.537150, -0.498535],
                           [-0.969256, 1.875991, 0.041556],
                           [0.055648, -0.204043, 1.057311]],
                          dtype=rgb.dtype, device=rgb.device)
    return rgb @ to_xyz.T @ to_rgb.T
