"""Denoise frames: the moment buffers of a rendered frame, made by the
benchmark itself and not by the port.

A frame is a piecewise-smooth image: a smooth background under `shapes`
discs and rectangles, each with its own radiance level (log-uniform in
`levels`), tint, albedo, normal and per-sample noise level (one of
`sigmas`: 0 gives pixels whose samples agree, as on a light or in full
shadow).  Each pixel gets `spp` samples, its radiance times multiplicative
lognormal noise of mean 1, with a firefly (times `firefly_gain`) at rate
`firefly_rate`: heavy-tailed, as a path tracer's samples are.  The
buffers are what the port's moment streams hold after those samples: n,
the mean, M2 and M3 of the Box-Cox values (lambda = 0.5), the raw film
mean and M2 (the Radiance stream), and the albedo and normal means (the
G-buffer streams), computed in float64 and stored in float32.

The layout of frame f comes from `layout_seed` + f and the samples'
noise from `seed`.
"""
from __future__ import annotations

import numpy as np
import torch


def _layout(H: int, W: int, rng, shapes: int, levels, sigmas, device):
    """Per pixel: radiance [H,W,3], albedo, normal [H,W,3], noise sigma
    [H,W], in float64 on `device`."""
    f64 = torch.float64
    yy, xx = torch.meshgrid(torch.arange(H, device=device, dtype=f64),
                            torch.arange(W, device=device, dtype=f64),
                            indexing="ij")
    gx, gy = rng.random(2) * 6.28
    base = 0.6 + 0.4 * torch.sin(xx / W * 3.1 + gx) * torch.cos(yy / H * 2.3
                                                               + gy)
    rad = base[..., None].repeat(1, 1, 3)
    alb = torch.full((H, W, 3), 0.5, device=device, dtype=f64)
    nrm = torch.zeros((H, W, 3), device=device, dtype=f64)
    nrm[..., 2] = 1.0
    sig = torch.full((H, W), float(sigmas[-1]), device=device, dtype=f64)
    lo, hi = np.log(levels[0]), np.log(levels[1])
    for _ in range(shapes):
        cy, cx = rng.random() * H, rng.random() * W
        ry, rx = (rng.random(2) * 0.12 + 0.03) * np.array([H, W])
        if rng.random() < 0.5:
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        else:
            inside = ((yy - cy).abs() <= ry) & ((xx - cx).abs() <= rx)
        level = float(np.exp(rng.uniform(lo, hi)))
        tint = rng.random(3) * 0.6 + 0.4
        grad = 1 + 0.3 * torch.sin((xx - cx) / max(rx, 1) * 1.7)
        val = level * grad[..., None] * torch.as_tensor(tint, device=device)
        rad = torch.where(inside[..., None], val, rad)
        alb = torch.where(inside[..., None], torch.as_tensor(
            rng.random(3) * 0.8 + 0.1, device=device), alb)
        n = rng.normal(size=3)
        n[2] = abs(n[2]) + 0.3
        n /= np.linalg.norm(n)
        nrm = torch.where(inside[..., None], torch.as_tensor(n, device=device),
                          nrm)
        sig = torch.where(inside, float(sigmas[rng.integers(len(sigmas))]),
                          sig)
    return rad, alb, nrm, sig


def make(H: int, W: int, seed: int, frames: int, spp: int, shapes: int,
         levels, sigmas, firefly_rate: float, firefly_gain: float,
         layout_seed: int, device):
    """`frames` frames, each a dict: n [P], mean, m2, m3, film_mean,
    film_m2, albedo, normal [P,3] (float32, P = H W pixels)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f64 = torch.float64
    out = []
    for f in range(frames):
        rng = np.random.default_rng(layout_seed + f)
        rad, alb, nrm, sig = _layout(H, W, rng, shapes, levels, sigmas,
                                     device)
        z = torch.randn((spp, H, W), generator=gen, device=device, dtype=f64)
        u = torch.rand((spp, H, W), generator=gen, device=device, dtype=f64)
        w = torch.exp(sig * z - 0.5 * sig * sig)
        w = torch.where((u < firefly_rate) & (sig > 0), w * firefly_gain, w)
        x = rad[None] * w[..., None]  # [S,H,W,3]
        y = 2.0 * (torch.sqrt(x) - 1.0)
        mean = y.mean(0)
        dy = y - mean
        fm = x.mean(0)
        dx = x - fm
        fr = {"n": torch.full((H * W,), float(spp), device=device),
              "mean": mean, "m2": (dy * dy).sum(0), "m3": (dy ** 3).sum(0),
              "film_mean": fm, "film_m2": (dx * dx).sum(0),
              "albedo": alb, "normal": nrm}
        out.append({k: v.reshape(H * W, -1).squeeze(-1).float().contiguous()
                    if k == "n" else v.reshape(H * W, 3).float().contiguous()
                    for k, v in fr.items()})
    return out
