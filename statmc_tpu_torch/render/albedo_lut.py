"""Per-material directional-albedo curves for the bounce-0 albedo G-buffer
(port of statmc_tpu/render/albedo_lut.py: _mc_albedo,
precompute_material_curves, albedo_from_curves).

The reference bakes every constant-texture dimension of its albedo LUTs
out at material construction (material.cpp:134-255), so each material
reduces to a 1-D curve over cos(theta_o), estimated here by Monte Carlo
over the BSDF sampler with the JAX package's threefry streams.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as cm
from ..core import rng
from ..scene import build as sb
from . import bsdf as B


def _mc_albedo(mat_lanes: B.MaterialLanes, cos_thetas, n_samples: int, key,
               chunk: int = 64, full_sphere=None):
    """rho(wo) = E[f |cos wi| / pdf] per lane, over the reflection side,
    or over the whole sphere on the lanes of the [G] bool mask
    full_sphere (hair fibres scatter through TT/TRT).

    Draw i uses fold_in(key, i) exactly as the JAX fori_loop does; the
    samples are evaluated in batches of `chunk` draws and summed in draw
    order, so the sum matches the sequential loop's rounding."""
    G = cos_thetas.shape[0]
    dev = cos_thetas.device
    st = cm.sqrt(torch.clamp(1.0 - cos_thetas ** 2, min=0.0))
    wo = torch.stack([st, torch.zeros_like(st), cos_thetas], dim=-1)
    acc = torch.zeros((G, 3), device=dev)
    for i0 in range(0, n_samples, chunk):
        n = min(chunk, n_samples - i0)
        keys = rng.fold_in(key.expand(n, 2),
                           torch.arange(i0, i0 + n, device=dev))
        u2 = rng.uniform(keys, (G, 2)).reshape(n * G, 2)
        uc = rng.uniform(rng.fold_in(keys, 1), (G,)).reshape(n * G)
        lanes = B.MaterialLanes(*[
            None if x is None else x.repeat((n,) + (1,) * (x.dim() - 1))
            for x in mat_lanes])
        smp = B.sample(lanes, wo.repeat(n, 1), u2, uc)
        w = smp.f * torch.abs(smp.wi[..., 2:3]) / torch.clamp(
            smp.pdf, min=1e-9)[..., None]
        w = torch.where(torch.isfinite(w), w, 0.0)
        keep = smp.wi[..., 2:3] > 0
        if full_sphere is not None:
            keep = keep | full_sphere.repeat(n)[:, None]
        w = torch.where(keep, w, 0.0).reshape(n, G, 3)
        for j in range(n):
            acc = acc + w[j]
    return acc / n_samples


def precompute_material_curves(scene: sb.SceneTables, n_cos: int = 16,
                               n_samples: int = 512, seed: int = 3):
    """(lut_d [M, n_cos, 3], lut_rest [M, n_cos, 3]) on the scene's
    device: albedo(cos) ~= kd * lut_d[mat](cos) + lut_rest[mat](cos)."""
    dev = scene.mat_type.device
    M = int(scene.mat_type.shape[0])
    cos = torch.as_tensor((np.arange(n_cos) + 0.5) / n_cos,
                          dtype=torch.float32, device=dev)
    G = M * n_cos

    def tile(x):
        return torch.repeat_interleave(x, n_cos, dim=0)

    ones3 = torch.ones((G, 3), device=dev)
    zeros3 = torch.zeros((G, 3), device=dev)
    # Hair rows take the Marschner model at h = 0 (sigma_a rides the kt
    # slot) over the whole sphere, the analogue of the reference's hair
    # albedo LUT (materials/hair.cpp:171); hairless scenes run none of it.
    has_hair = bool(torch.any(scene.mat_type == sb.MAT_HAIR))
    base = B.MaterialLanes(
        mat_type=tile(scene.mat_type), kd=ones3, ks=zeros3, kr=zeros3,
        kt=zeros3, eta=tile(scene.mat_eta), k=tile(scene.mat_k),
        rough_u=tile(scene.mat_rough_u), rough_v=tile(scene.mat_rough_v),
        sigma=tile(scene.mat_sigma),
        hair_h=torch.zeros((G,), device=dev) if has_hair else None)
    rest = base._replace(kd=zeros3, ks=tile(scene.mat_ks),
                         kr=tile(scene.mat_kr), kt=tile(scene.mat_kt))
    cc = cos.repeat(M)
    key = rng.base_key(seed, device=dev)
    sphere = (base.mat_type == sb.MAT_HAIR) if has_hair else None
    lut_d = _mc_albedo(base, cc, n_samples, key,
                       full_sphere=sphere).reshape(M, n_cos, 3)
    lut_rest = _mc_albedo(rest, cc, n_samples, rng.fold_in(key, 1),
                          full_sphere=sphere).reshape(M, n_cos, 3)
    # Only Kd-proportional families keep the kd * lut_d decomposition
    # (hair's full-sphere albedo lives in lut_rest).
    t = scene.mat_type
    kd_linear = ((t == sb.MAT_MATTE) | (t == sb.MAT_PLASTIC)
                 | (t == sb.MAT_UBER) | (t == sb.MAT_SUBSTRATE)
                 | (t == sb.MAT_TRANSLUCENT) | (t == sb.MAT_DISNEY))
    lut_d = torch.where(kd_linear[:, None, None], lut_d, 0.0)
    return lut_d, lut_rest


def albedo_from_curves(lut_d, lut_rest, mat_id, kd, cos_o):
    """Query the reduced curves per lane: [R,3] albedo."""
    n_cos = lut_d.shape[1]
    x = torch.clamp(torch.abs(cos_o), 0.0, 1.0) * n_cos - 0.5
    i0 = torch.clamp(torch.floor(x).to(torch.int32), 0, n_cos - 2)
    f = torch.clamp(x - i0.to(torch.float32), 0.0, 1.0)[..., None]
    m, i0 = mat_id.long(), i0.long()
    d = lut_d[m, i0] * (1 - f) + lut_d[m, i0 + 1] * f
    rr = lut_rest[m, i0] * (1 - f) + lut_rest[m, i0 + 1] * f
    return torch.clamp(kd * d + rr, 0.0, 1.0)
