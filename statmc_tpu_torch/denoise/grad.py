"""The differentiable statistical filter (port of
statmc_tpu/denoise/filter_pallas.py:356-452).

``filter_apply`` filters ``film_mean`` with weights from (mc, d2,
gbufs, valid) through kernel B2 and is differentiable in ``film_mean``:
its backward pass launches B2 once more, unnormalized, on g / wsum.
That rests on the weights being symmetric, w_ij = w_ji, so that the
transpose of the window sum is the window sum itself: the acceptance
test and both range terms are symmetric in i and j, but the factor
valid_j is not, so where ``valid`` has zeros (a halo mask) the backward
pass differs from the true gradient, as the JAX package's does
(ROADMAP.md, section C).  ``filter_apply_diff`` is the plain autodiff
twin with the same weight math, differentiable in the payload and the
G-buffers; the binary acceptance gate is detached (its gradient is zero
almost everywhere).
"""
from __future__ import annotations

import torch

from .filter_cuda import run_filter


class FilterApply(torch.autograd.Function):
    """Normalized B2 of film_mean; backward = B2 with normalize=False on
    g / max(wsum, 1e-20).  Only film_mean gets a gradient."""

    @staticmethod
    def forward(ctx, film_mean, mc, d2, gbufs, valid, radius, ds_factor,
                gb_factors):
        out, wsum = run_filter(mc, d2, film_mean.contiguous(), gbufs, valid,
                               radius, ds_factor, gb_factors, normalize=True)
        ctx.save_for_backward(mc, d2, gbufs, valid, wsum)
        ctx.params = (radius, ds_factor, gb_factors)
        return out

    @staticmethod
    def backward(ctx, g):
        mc, d2, gbufs, valid, wsum = ctx.saved_tensors
        gg = (g / torch.clamp(wsum, min=1e-20)[..., None]).contiguous()
        grad_m, _ = run_filter(mc, d2, gg, gbufs, valid, *ctx.params,
                               normalize=False)
        return (grad_m,) + (None,) * 7


def filter_apply(film_mean, mc, d2, gbufs, valid, radius: int,
                 ds_factor: float, gb_factors):
    """out [H,W,CF] = B2(film_mean), differentiable in film_mean."""
    return FilterApply.apply(film_mean, mc, d2, gbufs, valid, radius,
                             ds_factor, tuple(gb_factors))


def filter_apply_diff(film_mean, mc, d2, gbufs, valid, radius: int,
                      ds_factor: float, gb_factors):
    """Plain PyTorch twin of filter_apply, differentiable by autograd in
    film_mean and gbufs (and mc, d2 through nothing but the detached
    gate).  Returns out [H,W,CF]."""
    H, W, _ = mc.shape
    r = int(radius)

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, r, r, r, r))

    mc_p, d2_p, fm_p, gb_p = pad(mc), pad(d2), pad(film_mean), pad(gbufs)
    v_p = torch.nn.functional.pad(valid, (r, r, r, r))
    gbf = torch.tensor(list(gb_factors), dtype=torch.float32,
                       device=mc.device)
    wsum = torch.zeros((H, W), device=mc.device)
    fsum = torch.zeros(film_mean.shape, device=mc.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ys, xs = slice(dy + r, dy + r + H), slice(dx + r, dx + r + W)
            diff = mc - mc_p[ys, xs]
            accept = torch.all(diff * diff <= d2 + d2_p[ys, xs] + 1e-20,
                               -1).to(torch.float32).detach()
            logw = torch.full((H, W), ds_factor * float(dy * dy + dx * dx),
                              device=mc.device)
            if gbufs.shape[-1]:
                dg = gbufs - gb_p[ys, xs]
                logw = logw + torch.sum(gbf * dg * dg, -1)
            w = torch.exp(logw) * accept * v_p[ys, xs]
            wsum = wsum + w
            fsum = fsum + w[..., None] * fm_p[ys, xs]
    return fsum / torch.clamp(wsum, min=1e-20)[..., None]
