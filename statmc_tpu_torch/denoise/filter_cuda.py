"""Kernel B2: the statistical joint-bilateral filter on the card (port of
statmc_tpu/denoise/filter_pallas.py:_run_filter, with its three flags).

``run_filter`` is the wrapper of ``csrc/stat_filter.cu``; ``run_filter_plain``
beside it is the same function in plain PyTorch, used for tensors on the
CPU and as the kernel's reference on the card.  For every pixel i and
every neighbour j of the (2r+1)^2 window (rows outer, columns inner), in
the default f32 direct form:

    accept = all_c (mc_i - mc_j)^2 <= d2_i + d2_j + 1e-20
    w      = exp(ds (dy^2 + dx^2) + sum_g gf_g (g_i - g_j)^2) * accept * valid_j

and the output is sum_j w fm_j / max(sum_j w, 1e-20) (or unnormalized)
plus sum_j w.  The image is zero-padded with valid = 0 outside it.  The
flags, under _run_filter's names:

- ``accept_expand``: the test as fma(-2 mc_i, mc_j, fma(mc_j, mc_j, -d2_j))
  <= fma(-mc_i, mc_i, d2_i + 1e-20), the FMAs where XLA's CPU code
  contracts the Pallas kernel's expanded form;
- ``accept_bf16`` (takes precedence over ``accept_expand``): the direct
  test with every operation in bf16;
- ``range_bf16``: the range exponent in bf16 on planes pre-scaled to
  s_g = bf16(sqrt(-gf_g) g): arg = bf16(ds (dy^2 + dx^2)), then
  arg -= (s_i - s_j)^2 a plane (difference, square and subtraction each
  rounded), w = bf16(exp(arg)).  With no G-buffer planes it changes
  nothing.

Sums of weights and payload stay f32 in every form.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build, spans
from ..core import math as cm

BF16 = torch.bfloat16

# run_filter's keywords of each of the kernel's six forms.
FORMS = {
    "f32": {},
    "accept_expand": dict(accept_expand=True),
    "accept_bf16": dict(accept_bf16=True),
    "range_bf16": dict(range_bf16=True),
    "range_bf16+accept_expand": dict(range_bf16=True, accept_expand=True),
    "range_bf16+accept_bf16": dict(range_bf16=True, accept_bf16=True),
}


def form_of(accept_expand: bool = False, range_bf16: bool = False,
            accept_bf16: bool = False) -> str:
    """The key of FORMS that the kernel runs under these flags
    (accept_bf16 takes precedence over accept_expand)."""
    accept = ("accept_bf16" if accept_bf16 else
              "accept_expand" if accept_expand else "")
    return "+".join(n for n in ("range_bf16" if range_bf16 else "", accept)
                    if n) or "f32"


def _arg0(ds_factor: float, dy: int, dx: int) -> float:
    """f32 spatial term ds * (dy^2 + dx^2), rounded as the kernel does."""
    return float(np.float32(ds_factor) * np.float32(dy * dy + dx * dx))


def scaled_planes(gbufs, gb_factors):
    """The bf16 range form's planes [H,W,G]: bf16(f32(sqrt(-gf_g) g_g)),
    the scale sqrt(-gf) taken in double and rounded to float, as the JAX
    package's float32 planes meet its Python float and as the kernel's
    entry point computes it."""
    sc = torch.tensor([np.sqrt(-float(g)) for g in gb_factors],
                      dtype=torch.float32, device=gbufs.device)
    return (gbufs * sc).to(BF16)


def acceptance(mc, d2, accept_expand: bool = False,
               accept_bf16: bool = False):
    """The two-sample test of every pixel (mc, d2 [H,W,C]) against a
    neighbour's: a function (mc_j, d2_j) -> accept [H,W] bool, rounded as
    the kernel rounds."""
    if accept_bf16:
        mc16, thr16 = mc.to(BF16), (d2 + 1e-20).to(BF16)

        def test(mc_j, d2_j):
            diff = mc16 - mc_j.to(BF16)
            return torch.all(diff * diff <= thr16 + d2_j.to(BF16), -1)
    elif accept_expand:
        m, b = -2.0 * mc, cm.fma(-mc, mc, d2 + 1e-20)

        def test(mc_j, d2_j):
            return torch.all(cm.fma(m, mc_j, cm.fma(mc_j, mc_j, -d2_j)) <= b,
                             -1)
    else:
        def test(mc_j, d2_j):
            diff = mc - mc_j
            return torch.all(diff * diff <= d2 + d2_j + 1e-20, -1)
    return test


def run_filter_plain(mc, d2, fm, gbufs, valid, radius: int, ds_factor: float,
                     gb_factors, normalize: bool = True,
                     accept_expand: bool = False, range_bf16: bool = False,
                     accept_bf16: bool = False):
    """mc/d2 [H,W,C], fm [H,W,CF], gbufs [H,W,G], valid [H,W] ->
    (out [H,W,CF], wsum [H,W]).  Same summation order and rounding as the
    kernel in each form."""
    H, W, _ = mc.shape
    r = int(radius)
    gf = [float(np.float32(g)) for g in gb_factors]
    range16 = range_bf16 and len(gf) > 0
    test = acceptance(mc, d2, accept_expand, accept_bf16)

    def pad(x):
        x = x if x.dim() == 3 else x[..., None]
        return torch.nn.functional.pad(x, (0, 0, r, r, r, r))

    g_i = scaled_planes(gbufs, gb_factors) if range16 else gbufs
    mc_p, d2_p, fm_p, gb_p, v_p = (pad(x) for x in (mc, d2, fm, g_i, valid))
    wsum = torch.zeros((H, W), device=mc.device)
    acc = torch.zeros_like(fm)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ys, xs = slice(dy + r, dy + r + H), slice(dx + r, dx + r + W)
            accept = test(mc_p[ys, xs], d2_p[ys, xs])
            arg = torch.full((H, W), _arg0(ds_factor, dy, dx),
                             device=mc.device)
            g_j = gb_p[ys, xs]
            if range16:
                arg = arg.to(BF16)
                for g in range(len(gf)):
                    d = g_i[..., g] - g_j[..., g]
                    arg = arg - d * d
                e = torch.exp(arg.float()).to(BF16).float()
            else:
                for g in range(len(gf)):
                    dg = g_i[..., g] - g_j[..., g]
                    arg = arg + gf[g] * (dg * dg)
                e = torch.exp(arg)
            w = e * accept.to(torch.float32) * v_p[ys, xs, 0]
            wsum = wsum + w
            acc = acc + w[..., None] * fm_p[ys, xs]
    out = acc / torch.clamp(wsum, min=1e-20)[..., None] if normalize else acc
    return out, wsum


def run_filter(mc, d2, fm, gbufs, valid, radius: int, ds_factor: float,
               gb_factors, normalize: bool = True, accept_expand: bool = False,
               range_bf16: bool = False, accept_bf16: bool = False):
    """Kernel B2 wrapper, arguments and flags as the JAX package's
    _run_filter.  CPU tensors take the plain version; CUDA tensors launch
    the kernel in the form the flags name (every form is built).  The
    counter kernel.B2 (spans.py) counts the launches, and
    kernel.B2.<form> counts them by the form launched (a key of FORMS;
    range_bf16 with no G-buffer planes launches its acceptance form):
    form_launches() reads them."""
    if not mc.is_cuda:
        return run_filter_plain(mc, d2, fm, gbufs, valid, radius, ds_factor,
                                gb_factors, normalize, accept_expand,
                                range_bf16, accept_bf16)
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
    range16 = bool(range_bf16) and G > 0
    out = torch.empty((H, W, CF), dtype=torch.float32, device=mc.device)
    wsum = torch.empty((H, W), dtype=torch.float32, device=mc.device)
    # The bf16 range form's scaled planes, G rounded up to even.
    gs = (torch.empty((H, W, G + G % 2), dtype=BF16, device=mc.device)
          if range16 else None)
    factors = (ctypes.c_double * max(G, 1))(*[float(g) for g in gb_factors])
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(mc.device).cuda_stream
    rc = lib.statmc_stat_filter(
        mc.data_ptr(), d2.data_ptr(), fm.data_ptr(), gbufs.data_ptr(),
        valid.data_ptr(), ctypes.cast(factors, ctypes.c_void_p), H, W, C, CF,
        G, int(radius), float(np.float32(ds_factor)), int(normalize),
        int(bool(accept_expand)), int(range16), int(bool(accept_bf16)),
        None if gs is None else gs.data_ptr(), out.data_ptr(), wsum.data_ptr(),
        ctypes.c_void_p(stream))
    cuda_build.check(rc, "statmc_stat_filter")
    spans.count("kernel.B2", 1)
    spans.count("kernel.B2." + form_of(accept_expand, range16, accept_bf16),
                1)
    return out, wsum


def form_launches() -> dict:
    """B2's launches by form ({form: n} over FORMS), from the counters
    kernel.B2.<form>."""
    return {f: spans.counted("kernel.B2." + f) for f in FORMS}
