"""Streaming per-pixel moment statistics (port of
statmc_tpu/stats/moments.py).

A MomentState is a dict of tensors: ``n`` [..., 1] and ``mean``/``m2``/
``m3``/``film_mean``/``film_m2`` [..., C].  The update expressions keep
the JAX package's statement order (estimator.h:188-226) and its compiled
rounding, so CPU results are bitwise equal to the jitted JAX update.
"""
from __future__ import annotations

import torch

from ..core import math as cm


def make_state(shape, channels: int, transform: bool, max_moment: int = 3,
               device="cpu") -> dict:
    """Zeroed moment state for `shape` pixels x `channels`."""
    full = tuple(shape) + (channels,)

    def z(s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    st = {"n": z(tuple(shape) + (1,)), "mean": z(full)}
    if max_moment >= 2:
        st["m2"] = z(full)
    if max_moment >= 3:
        st["m3"] = z(full)
    if transform:
        st["film_mean"] = z(full)
        st["film_m2"] = z(full)
    return st


def box_cox(x, lam: float = 0.5):
    """(x^lambda - 1)/lambda (estimator.h:135-145).  lambda = 0.5 takes
    the correctly rounded square root, as XLA lowers the power."""
    p = cm.sqrt(x) if lam == 0.5 else torch.pow(x, lam)
    return (p - 1.0) / lam


def _meng_update(n, mean, m2, m3, x, w):
    """One Meng/Pebay step; w is a [..., 1] {0,1} mask of active lanes."""
    n_new = n + w
    n_safe = torch.clamp(n_new, min=1.0)
    d = x - mean
    dn = d / n_safe
    dn2 = dn * dn
    mean_new = mean + w * dn
    out = {"n": n_new, "mean": mean_new}
    if m2 is not None:
        m2_new = m2 + w * (d * (d - dn))
        out["m2"] = m2_new
        if m3 is not None:
            # XLA contracts this line into two fused multiply-adds:
            # -3 dn m2' + d (d^2 - dn^2) = fma(-3 dn, m2', d fma(d, d, -dn^2)).
            out["m3"] = m3 + w * cm.fma(-3.0 * dn, m2_new,
                                        d * cm.fma(d, d, -dn2))
    return out


def _mask_w(state: dict, mask):
    if mask is None:
        return torch.ones_like(state["n"])
    return mask[..., None].to(state["n"].dtype)


def update(state: dict, sample, mask=None) -> dict:
    """AddSampleM{1,2,3}: raw sample into the stat stream."""
    w = _mask_w(state, mask)
    new = _meng_update(state["n"], state["mean"], state.get("m2"),
                       state.get("m3"), sample, w)
    # Without transform, film buffers alias the stat buffers.
    if "film_mean" in state:
        new["film_mean"] = new["mean"]
        new["film_m2"] = new.get("m2", state["film_m2"])
    return new


def update_transform(state: dict, sample, mask=None, lam: float = 0.5
                     ) -> dict:
    """AddTransformSample: Box-Cox into stats, raw sample into the film
    duals, sharing one n."""
    w = _mask_w(state, mask)
    new = _meng_update(state["n"], state["mean"], state.get("m2"),
                       state.get("m3"), box_cox(sample, lam), w)
    n_safe = torch.clamp(new["n"], min=1.0)
    fd = sample - state["film_mean"]
    fdn = fd / n_safe
    new["film_mean"] = state["film_mean"] + w * fdn
    new["film_m2"] = state["film_m2"] + w * (fd * (fd - fdn))
    return new


def from_batch(samples, axis: int = 0, transform: bool = False,
               lam: float = 0.5, mask=None) -> dict:
    """A moment state from a batch of samples in one shot
    (statmc_tpu/stats/moments.py:168): the stable two-pass form, the
    batch mean subtracted first; `mask` weights each sample 0 or 1.
    Equals the streaming result in exact arithmetic."""
    x = box_cox(samples, lam) if transform else samples
    if mask is None:
        n = float(samples.shape[axis])
        mean = x.mean(axis)
        d = x - mean.unsqueeze(axis)
        st = {"n": torch.full_like(mean[..., :1], n), "mean": mean,
              "m2": (d * d).sum(axis), "m3": (d * d * d).sum(axis)}
        if transform:
            fmean = samples.mean(axis)
            fd = samples - fmean.unsqueeze(axis)
            st["film_mean"] = fmean
            st["film_m2"] = (fd * fd).sum(axis)
        return st
    w = mask.unsqueeze(-1).to(samples.dtype)
    n = w.sum(axis)
    n_safe = torch.clamp(n, min=1.0)
    mean = (w * x).sum(axis) / n_safe
    d = (x - mean.unsqueeze(axis)) * w
    st = {"n": n[..., :1], "mean": mean, "m2": (d * d).sum(axis),
          "m3": (d * d * d).sum(axis)}
    if transform:
        fmean = (w * samples).sum(axis) / n_safe
        fd = (samples - fmean.unsqueeze(axis)) * w
        st["film_mean"] = fmean
        st["film_m2"] = (fd * fd).sum(axis)
    return st


def sample_variance(state: dict):
    """Unbiased sample variance M2/(n-1)."""
    return state["m2"] / torch.clamp(state["n"] - 1.0, min=1.0)


def mean_variance(state: dict, film: bool = False):
    """Variance of the mean: M2/((n-1) n) (estimator.cpp:524-569)."""
    n = state["n"]
    m2 = state["film_m2"] if film and "film_m2" in state else state["m2"]
    return m2 / torch.clamp((n - 1.0) * n, min=1.0)


def combine(a: dict, b: dict) -> dict:
    """Chan et al.'s pairwise combine of two moment states over the same
    pixels (statmc_tpu/stats/moments.py:123), in its operation order."""
    na, nb = a["n"], b["n"]
    n = na + nb
    n_safe = torch.clamp(n, min=1.0)
    d = b["mean"] - a["mean"]
    dn = d / n_safe
    out = {"n": n, "mean": a["mean"] + nb * dn}
    if "m2" in a:
        out["m2"] = a["m2"] + b["m2"] + d * dn * na * nb
        if "m3" in a:
            out["m3"] = (a["m3"] + b["m3"]
                         + d * dn * dn * na * nb * (na - nb)
                         + 3.0 * dn * (na * b["m2"] - nb * a["m2"]))
    if "film_mean" in a:
        fd = b["film_mean"] - a["film_mean"]
        fdn = fd / n_safe
        out["film_mean"] = a["film_mean"] + nb * fdn
        out["film_m2"] = a["film_m2"] + b["film_m2"] + fd * fdn * na * nb
    return out


def combine_across(state: dict, group=None) -> dict:
    """Merge the moment states of the members of a torch.distributed
    group (statmc_tpu/stats/moments.py:150 combine_across_axis): gather
    every member's state, then combine them in the group's rank order,
    member 0 first.  A group of one returns the state itself."""
    from ..parallel import comm

    if comm.size(group) == 1:
        return state
    keys = list(state)
    flat = torch.cat([state[k].reshape(-1) for k in keys])
    members = []
    for g in comm.all_gather(flat, group):
        st, o = {}, 0
        for k in keys:
            st[k] = g[o:o + state[k].numel()].reshape(state[k].shape)
            o += state[k].numel()
        members.append(st)
    acc = members[0]
    for m in members[1:]:
        acc = combine(acc, m)
    return acc
