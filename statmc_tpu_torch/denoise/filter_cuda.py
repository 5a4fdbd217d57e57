"""Kernel B2: the statistical joint-bilateral filter on the card (port of
statmc_tpu/denoise/filter_pallas.py:_run_filter, f32 direct form).

``run_filter`` is the wrapper of ``csrc/stat_filter.cu``; ``run_filter_plain``
beside it is the same function in plain PyTorch, used for tensors on the
CPU and as the kernel's reference on the card.  For every pixel i and
every neighbour j of the (2r+1)^2 window (rows outer, columns inner):

    accept = all_c (mc_i - mc_j)^2 <= d2_i + d2_j + 1e-20
    w      = exp(ds (dy^2 + dx^2) + sum_g gf_g (g_i - g_j)^2) * accept * valid_j

and the output is sum_j w fm_j / max(sum_j w, 1e-20) (or unnormalized)
plus sum_j w.  The image is zero-padded with valid = 0 outside it.  The
TPU variants range_bf16 / accept_bf16 / accept_expand are not ported.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build


def _arg0(ds_factor: float, dy: int, dx: int) -> float:
    """f32 spatial term ds * (dy^2 + dx^2), rounded as the kernel does."""
    return float(np.float32(ds_factor) * np.float32(dy * dy + dx * dx))


def run_filter_plain(mc, d2, fm, gbufs, valid, radius: int, ds_factor: float,
                     gb_factors, normalize: bool = True):
    """mc/d2 [H,W,C], fm [H,W,CF], gbufs [H,W,G], valid [H,W] ->
    (out [H,W,CF], wsum [H,W]).  Same summation order as the kernel."""
    H, W, _ = mc.shape
    r = int(radius)
    gf = [float(np.float32(g)) for g in gb_factors]

    def pad(x):
        x = x if x.dim() == 3 else x[..., None]
        return torch.nn.functional.pad(x, (0, 0, r, r, r, r))

    mc_p, d2_p, fm_p, gb_p, v_p = (pad(x) for x in (mc, d2, fm, gbufs,
                                                    valid))
    wsum = torch.zeros((H, W), device=mc.device)
    acc = torch.zeros_like(fm)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ys, xs = slice(dy + r, dy + r + H), slice(dx + r, dx + r + W)
            diff = mc - mc_p[ys, xs]
            accept = torch.all(diff * diff <= d2 + d2_p[ys, xs] + 1e-20, -1)
            arg = torch.full((H, W), _arg0(ds_factor, dy, dx),
                             device=mc.device)
            g_j = gb_p[ys, xs]
            for g in range(len(gf)):
                dg = gbufs[..., g] - g_j[..., g]
                arg = arg + gf[g] * (dg * dg)
            w = torch.exp(arg) * accept.to(torch.float32) * v_p[ys, xs, 0]
            wsum = wsum + w
            acc = acc + w[..., None] * fm_p[ys, xs]
    out = acc / torch.clamp(wsum, min=1e-20)[..., None] if normalize else acc
    return out, wsum


def run_filter(mc, d2, fm, gbufs, valid, radius: int, ds_factor: float,
               gb_factors, normalize: bool = True):
    """Kernel B2 wrapper, arguments as the JAX package's _run_filter
    (f32 direct form).  CPU tensors take the plain version; CUDA tensors
    launch the kernel, and `run_filter.launches` counts the launches."""
    if not mc.is_cuda:
        return run_filter_plain(mc, d2, fm, gbufs, valid, radius, ds_factor,
                                gb_factors, normalize)
    H, W, C = mc.shape
    CF, G = fm.shape[-1], gbufs.shape[-1]
    for name, x, shape in (("mc", mc, (H, W, C)), ("d2", d2, (H, W, C)),
                           ("fm", fm, (H, W, CF)),
                           ("gbufs", gbufs, (H, W, G)),
                           ("valid", valid, (H, W))):
        if (not x.is_cuda or x.device != mc.device
                or x.dtype != torch.float32 or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"run_filter: {name} must be a contiguous "
                             f"float32 CUDA tensor of shape {shape} on "
                             f"{mc.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if len(gb_factors) != G:
        raise ValueError(f"run_filter: {len(gb_factors)} factors for {G} "
                         "G-buffer planes")
    out = torch.empty((H, W, CF), dtype=torch.float32, device=mc.device)
    wsum = torch.empty((H, W), dtype=torch.float32, device=mc.device)
    factors = (ctypes.c_float * max(G, 1))(*[float(g) for g in gb_factors])
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(mc.device).cuda_stream
    rc = lib.statmc_stat_filter(
        mc.data_ptr(), d2.data_ptr(), fm.data_ptr(), gbufs.data_ptr(),
        valid.data_ptr(), ctypes.cast(factors, ctypes.c_void_p), H, W, C,
        CF, G, int(radius), float(np.float32(ds_factor)), int(normalize),
        out.data_ptr(), wsum.data_ptr(), ctypes.c_void_p(stream))
    cuda_build.check(rc, "statmc_stat_filter")
    run_filter.launches += 1
    return out, wsum


run_filter.launches = 0
