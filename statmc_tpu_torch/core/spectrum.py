"""RGB spectrum helpers (port of statmc_tpu/core/spectrum.py): pbrt's
luminance weights and XYZ round trip, on [..., 3] tensors."""
from __future__ import annotations

import torch

from . import math as cm

_Y_WEIGHT = (0.212671, 0.715160, 0.072169)


def luminance(rgb):
    """RGBSpectrum::y() (spectrum.h:RGBSpectrum::y)."""
    w = cm.const(_Y_WEIGHT, rgb.device, rgb.dtype)
    return torch.sum(rgb * w, dim=-1)


def rgb_to_xyz(rgb):
    """spectrum.h:RGBToXYZ."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    x = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    return torch.stack([x, y, z], dim=-1)


def xyz_to_rgb(xyz):
    """spectrum.h:XYZToRGB."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = 3.240479 * x - 1.537150 * y - 0.498535 * z
    g = -0.969256 * x + 1.875991 * y + 0.041556 * z
    b = 0.055648 * x - 0.204043 * y + 1.057311 * z
    return torch.stack([r, g, b], dim=-1)
