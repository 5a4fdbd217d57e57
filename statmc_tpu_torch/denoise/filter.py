"""Statistical joint-bilateral denoising (port of
statmc_tpu/denoise/filter_jax.py: corrected_stats, stat_filter,
StatDenoiser).

For every pixel the Johnson skewness-corrected mean and its confidence
half-width (the "discriminator") decide which neighbours estimate the
same radiance; accepted neighbours are weighted by the spatial and
G-buffer range Gaussians and the raw film means are averaged.  The
window sweep is kernel B2 (filter_cuda.run_filter): the CUDA kernel for
tensors on the card, its plain PyTorch version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as cm
from ..stats import estimator as E
from .filter_cuda import run_filter
from .ttest import MAX_DF, quantile_table


# Two-sided t-test level of the acceptance test (the reference's default).
ALPHA = 0.005


def corrected_stats(n, mean, m2, m3, tq):
    """Johnson-corrected means + discriminator (CI half width) per pixel;
    returns (mean_corr, disc) with the shape of `mean`.  (The JAX
    package's moon_ci variant has no caller on the main path and is not
    ported.)"""
    nf = torch.clamp(n, min=1.0)[..., None]
    s2 = m2 / torch.clamp(nf - 1.0, min=1.0)
    m3hat = m3 / nf
    corr = m3hat / torch.clamp(6.0 * s2 * nf, min=1e-12)
    corr = torch.where(s2 > 1e-12, corr, 0.0)
    mean_corr = mean + corr
    sem = cm.sqrt(torch.clamp(s2 / nf, min=0.0))
    df = torch.clamp(n - 1.0, 0.0, float(MAX_DF)).to(torch.int32)
    tcrit = tq[df.long()][..., None]
    return mean_corr, tcrit * sem


def stat_filter(n, mean, m2, m3, film_mean, gb_planes, gb_factors,
                ds_factor: float, tq, radius: int, film_img=None) -> dict:
    """n [H,W], mean/m2/m3/film_mean [H,W,C], gb_planes [H,W,G] with one
    factor -0.5/sigma^2 per plane.  Returns mean_corr, discriminator,
    film_mean_f (and film_f when film_img [H,W,3] is given)."""
    H, W, C = mean.shape
    mc, disc = corrected_stats(n, mean, m2, m3, tq)
    fstack = film_mean if film_img is None else torch.cat(
        [film_mean, film_img], -1)
    out, _ = run_filter(
        mc.contiguous(), (disc * disc).contiguous(), fstack.contiguous(),
        gb_planes.contiguous(), torch.ones((H, W), device=mean.device),
        radius, ds_factor, gb_factors)
    res = dict(mean_corr=mc, discriminator=disc, film_mean_f=out[..., :C])
    if film_img is not None:
        res["film_f"] = out[..., C:]
    return res


class StatDenoiser:
    """Drives the filter over every DenoiseGroup buffer (the analogue of
    Estimator::Denoise, estimator.cpp:427-489)."""

    def __init__(self, ecfg: E.EstimatorConfig, width: int, height: int,
                 device="cpu"):
        self.ecfg = ecfg
        self.W, self.H = width, height
        self.tq = torch.as_tensor(quantile_table(ALPHA), device=device)
        self.ds_factor = float(np.float32(
            -0.5 / (ecfg.filter_sd * ecfg.filter_sd)))
        self.radius = int(ecfg.filter_radius)

    def _gbuffers(self, states):
        """Enabled filter G-buffer means as planes [H,W,G] and one range
        factor per plane."""
        planes, pfac = [], []
        for t in (E.STAT_MATERIAL_ID, E.STAT_DEPTH, E.STAT_NORMAL,
                  E.STAT_ALBEDO):
            c = self.ecfg.configs[t]
            if c.enable and c.enable_for_filter and t in states:
                fm = states[t].get("film_mean", states[t]["mean"])[0]
                planes.append(fm.reshape(self.H, self.W, c.n_channels))
                pfac.extend([-0.5 / (c.filter_sd * c.filter_sd)]
                            * c.n_channels)
        if planes:
            return torch.cat(planes, -1), tuple(pfac)
        return torch.zeros((self.H, self.W, 0), device=self.tq.device), ()

    def __call__(self, state: dict, film, gbufs) -> dict:
        """Filter all bounce buffers of one stat type.  state: moment
        state [NB,P,C]; film: [H,W,3] film image for Radiance (or None);
        gbufs: `_gbuffers(states)`.  Returns [NB,P,C] buffers + film_f."""
        H, W = self.H, self.W
        NB = state["n"].shape[0]
        C = state["mean"].shape[-1]
        gb_planes, gf = gbufs
        outs = {"mean_corr": [], "discriminator": [], "film_mean_f": []}
        film_f = None
        # Reference aliasing (estimator.cpp:143-146, RGB path): Radiance
        # b0's film-mean-f IS the filtered film, so the film planes are
        # not filtered a second time.
        alias_film = C == 3
        for j in range(NB):
            n_img = state["n"][j, :, 0].reshape(H, W)
            mean = state["mean"][j].reshape(H, W, C)
            m2 = state.get("m2", state["mean"])[j].reshape(H, W, C)
            m3 = (state["m3"][j].reshape(H, W, C) if "m3" in state
                  else torch.zeros_like(mean))
            fm = state.get("film_mean", state["mean"])[j].reshape(H, W, C)
            fi = film if (film is not None and j == 0) else None
            want_film_alias = fi is not None and alias_film
            if want_film_alias:
                fi = None
            res = stat_filter(n_img, mean, m2, m3, fm, gb_planes, gf,
                              self.ds_factor, self.tq, self.radius,
                              film_img=fi)
            for k in outs:
                outs[k].append(res[k].reshape(-1, C))
            if fi is not None:
                film_f = res["film_f"]
            elif want_film_alias:
                film_f = res["film_mean_f"].reshape(H, W, C)
        return {
            "mean_corr": torch.stack(outs["mean_corr"]),
            "discriminator": torch.stack(outs["discriminator"]),
            "film_mean_f": torch.stack(outs["film_mean_f"]),
            "film_f": film_f,
        }
