"""Statistical joint-bilateral denoising (port of
statmc_tpu/denoise/filter_jax.py: corrected_stats, stat_filter,
StatDenoiser).

For every pixel the Johnson skewness-corrected mean and its confidence
half-width (the "discriminator") decide which neighbours estimate the
same radiance; accepted neighbours are weighted by the spatial and
G-buffer range Gaussians and the raw film means are averaged.  The
window sweep is kernel B2 (filter_cuda.run_filter): the CUDA kernel for
tensors on the card, its plain PyTorch version on the CPU.

``moon_ci`` swaps in Moon et al. [2013] confidence intervals (the
reference's MEMFNC=1): the film means, without the skewness correction.
``StatDenoiser(range_bf16=True)`` runs B2's bf16 range form on the whole
image; the port defaults to the f32 form (the JAX package defaults to
bf16 on its TPU path; ROADMAP.md section C).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import spans
from ..core import math as cm
from ..stats import estimator as E
from .filter_cuda import run_filter
from .ttest import MAX_DF, quantile_table


# Two-sided t-test level of the acceptance test (the reference's default).
ALPHA = 0.005


def corrected_stats(n, mean, m2, m3, tq, moon_ci: bool = False):
    """Johnson-corrected means + discriminator (CI half width) per pixel;
    returns (mean_corr, disc) with the shape of `mean`.  moon_ci: `mean`
    itself, without the skewness correction."""
    nf = torch.clamp(n, min=1.0)[..., None]
    s2 = m2 / torch.clamp(nf - 1.0, min=1.0)
    if moon_ci:
        mean_corr = mean
    else:
        m3hat = m3 / nf
        corr = m3hat / torch.clamp(6.0 * s2 * nf, min=1e-12)
        corr = torch.where(s2 > 1e-12, corr, 0.0)
        mean_corr = mean + corr
    sem = cm.sqrt(torch.clamp(s2 / nf, min=0.0))
    df = torch.clamp(n - 1.0, 0.0, float(MAX_DF)).to(torch.int32)
    tcrit = tq[df.long()][..., None]
    return mean_corr, tcrit * sem


def stat_filter(n, mean, m2, m3, film_mean, gb_planes, gb_factors,
                ds_factor: float, tq, radius: int, film_img=None,
                valid=None, moon_ci: bool = False,
                range_bf16: bool = False) -> dict:
    """n [H,W], mean/m2/m3/film_mean [H,W,C], gb_planes [H,W,G] with one
    factor -0.5/sigma^2 per plane; valid [H,W] 0/1 weighs each pixel as a
    neighbour (all ones when None; a halo slab's rows past the image's
    edges are 0).  moon_ci tests the film means, as the JAX package's
    stat_filter does; range_bf16 runs B2's bf16 range form.  Returns
    mean_corr, discriminator, film_mean_f (and film_f when film_img
    [H,W,3] is given)."""
    H, W, C = mean.shape
    mc, disc = corrected_stats(n, film_mean if moon_ci else mean, m2, m3, tq,
                               moon_ci)
    fstack = film_mean if film_img is None else torch.cat(
        [film_mean, film_img], -1)
    out, _ = run_filter(
        mc.contiguous(), (disc * disc).contiguous(), fstack.contiguous(),
        gb_planes.contiguous(),
        torch.ones((H, W), device=mean.device) if valid is None
        else valid.contiguous(), radius, ds_factor, gb_factors,
        range_bf16=range_bf16)
    res = dict(mean_corr=mc, discriminator=disc, film_mean_f=out[..., :C])
    if film_img is not None:
        res["film_f"] = out[..., C:]
    return res


def halo_extend(halo, gb_planes):
    """A row slab's validity mask and G-buffer planes [h,W,G] extended by
    `halo`, an exchange [h,W,K] -> [h+2r,W,K] (a mesh's rows of the "px"
    neighbours, zeros past the image's edges): (valid [h+2r,W], planes
    [h+2r,W,G]); valid is 0 on the rows past the image's edges."""
    h, W = gb_planes.shape[:2]
    valid = halo(gb_planes.new_ones((h, W, 1)))[..., 0]
    return valid, halo(gb_planes)


def stat_filter_slab(halo, valid, n, mean, m2, m3, film_mean, gb_planes,
                     gb_factors, ds_factor: float, tq, radius: int,
                     film_img=None, moon_ci: bool = False) -> dict:
    """stat_filter on a row slab of h rows (statmc_tpu/denoise/
    filter_jax.py:250-310), in B2's f32 form whatever the denoiser's
    range_bf16, as the JAX package's sharded denoise: n [h,W],
    mean/m2/m3/film_mean [h,W,C] and film_img [h,W,3] are extended by
    `halo` in one exchange; valid and gb_planes come extended
    (halo_extend).  Returns stat_filter's outputs cropped back to the
    slab's rows."""
    h, C = n.shape[0], mean.shape[-1]
    parts = [n[..., None], mean, m2, m3, film_mean] + (
        [film_img] if film_img is not None else [])
    ext = halo(torch.cat(parts, -1))
    n_e, mean_e, m2_e, m3_e, fm_e = (
        ext[..., 0], *torch.split(ext[..., 1:1 + 4 * C], C, -1))
    film_e = ext[..., 1 + 4 * C:] if film_img is not None else None
    res = stat_filter(n_e, mean_e, m2_e, m3_e, fm_e, gb_planes, gb_factors,
                      ds_factor, tq, radius, film_img=film_e, valid=valid,
                      moon_ci=moon_ci)
    return {k: v[radius:radius + h] for k, v in res.items()}


class StatDenoiser:
    """Drives the filter over every DenoiseGroup buffer (the analogue of
    Estimator::Denoise, estimator.cpp:427-489).  alpha: the two-sided
    level of the acceptance test; moon_ci: Moon et al.'s intervals on the
    film means; range_bf16: B2's bf16 range form on the whole image (the
    halo path stays f32)."""

    def __init__(self, ecfg: E.EstimatorConfig, width: int, height: int,
                 alpha: float = ALPHA, moon_ci: bool = False,
                 range_bf16: bool = False, device="cpu"):
        self.ecfg = ecfg
        self.W, self.H = width, height
        self.alpha = alpha
        self.moon_ci = moon_ci
        self.range_bf16 = range_bf16
        self.tq = torch.as_tensor(quantile_table(alpha), device=device)
        self.ds_factor = float(np.float32(
            -0.5 / (ecfg.filter_sd * ecfg.filter_sd)))
        self.radius = int(ecfg.filter_radius)

    @spans.spanned("denoise.gbuffers")
    def _gbuffers(self, states, height=None):
        """Enabled filter G-buffer means as planes [H,W,G] and one range
        factor per plane; `height` overrides H (a mesh's row slab)."""
        H = self.H if height is None else height
        planes, pfac = [], []
        for t in (E.STAT_MATERIAL_ID, E.STAT_DEPTH, E.STAT_NORMAL,
                  E.STAT_ALBEDO):
            c = self.ecfg.configs[t]
            if c.enable and c.enable_for_filter and t in states:
                fm = states[t].get("film_mean", states[t]["mean"])[0]
                planes.append(fm.reshape(H, self.W, c.n_channels))
                pfac.extend([-0.5 / (c.filter_sd * c.filter_sd)]
                            * c.n_channels)
        if planes:
            return torch.cat(planes, -1), tuple(pfac)
        return torch.zeros((H, self.W, 0), device=self.tq.device), ()

    @spans.spanned("denoise.filter")
    def __call__(self, state: dict, film, gbufs, halo=None) -> dict:
        """Filter all bounce buffers of one stat type.  state: moment
        state [NB,P,C] of P = H W pixels (or of a row slab); film: [H,W,3]
        film image for Radiance (or None); gbufs: `_gbuffers(states)`.
        Returns [NB,P,C] buffers + film_f.

        halo: an exchange [h,W,K] -> [h+2r,W,K] (a mesh's rows of the "px"
        neighbours, zeros past the image's edges): each bounce is filtered
        on the halo-extended slab and cropped back (stat_filter_slab)."""
        W = self.W
        NB = state["n"].shape[0]
        C = state["mean"].shape[-1]
        H = state["n"].shape[1] // W
        gb_planes, gf = gbufs
        if halo is not None:
            valid, gb_planes = halo_extend(halo, gb_planes)
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
            if halo is None:
                res = stat_filter(n_img, mean, m2, m3, fm, gb_planes, gf,
                                  self.ds_factor, self.tq, self.radius,
                                  film_img=fi, moon_ci=self.moon_ci,
                                  range_bf16=self.range_bf16)
            else:
                res = stat_filter_slab(halo, valid, n_img, mean, m2, m3, fm,
                                       gb_planes, gf, self.ds_factor,
                                       self.tq, self.radius, film_img=fi,
                                       moon_ci=self.moon_ci)
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
