"""bsdftest: BSDF sampling-consistency checker (port of
statmc_tpu/tools/bsdftest.py).

After the reference's src/tools/bsdftest.cpp: for a material, estimate
the hemispherical reflectance rho(wo) three independent ways (uniform
hemisphere, cosine-weighted, and the BSDF's own importance sampling) and
report their spread; disagreement flags an inconsistent f/pdf pair.  The
draws are the JAX tool's numpy draws.

Usage: python -m statmc_tpu_torch.tools.bsdftest [material] [roughness]
       [--device {cuda,cpu}]

Exit codes: 0 consistent, 2 inconsistent (spread >= 0.05), 1 for an
unknown material, a bad --device, or no CUDA device without --device cpu.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from . import device as _device
from ..render import bsdf as B
from ..scene import build as sb

MATERIALS = {"matte": sb.MAT_MATTE, "plastic": sb.MAT_PLASTIC,
             "substrate": sb.MAT_SUBSTRATE, "metal": sb.MAT_METAL,
             "uber": sb.MAT_UBER}
SPREAD_LIMIT = 0.05


def estimate_rho(mat_type: int, kd, ks, rough: float, n: int = 1 << 14,
                 seed: int = 0, cos_o: float = 0.8, device="cuda"):
    """(rho_uniform, rho_cosine, rho_importance) RGB estimates (numpy)."""
    rng = np.random.default_rng(seed)
    so = float(np.sqrt(max(0.0, 1.0 - cos_o * cos_o)))
    wo = torch.tensor([so, 0.0, cos_o], dtype=torch.float32,
                      device=device).expand(n, 3)
    ones = torch.ones((n, 3), device=device)

    def rgb(v):
        return torch.as_tensor(np.asarray(v, np.float32),
                               device=device) * ones

    m = B.MaterialLanes(
        mat_type=torch.full((n,), mat_type, dtype=torch.int32, device=device),
        kd=rgb(kd), ks=rgb(ks), kr=ones, kt=0.0 * ones, eta=1.5 * ones,
        k=0.0 * ones, rough_u=torch.full((n,), rough, device=device),
        rough_v=torch.full((n,), rough, device=device),
        sigma=torch.zeros((n,), device=device))
    u2 = torch.as_tensor(rng.random((n, 2)), dtype=torch.float32,
                         device=device)
    uc = torch.as_tensor(rng.random(n), dtype=torch.float32, device=device)

    # 1) Uniform hemisphere integration of f cos / (1/2pi).
    z = u2[:, 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2 * math.pi * u2[:, 1]
    wi_u = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    f_u, _ = B.evaluate(m, wo, wi_u)
    rho_u = (f_u * z[:, None] * (2 * math.pi)).mean(0)

    # 2) Cosine-weighted integration of f cos / (cos/pi).
    f_c, _ = B.evaluate(m, wo, B.cosine_sample_hemisphere(u2))
    rho_c = (f_c * math.pi).mean(0)

    # 3) The BSDF's own importance sampling: f cos / pdf.
    s = B.sample(m, wo, u2, uc)
    w = s.f * torch.abs(s.wi[:, 2:3]) / torch.clamp(s.pdf, min=1e-9)[:, None]
    w = torch.where((s.pdf > 1e-9)[:, None] & (s.wi[:, 2:3] > 0), w, 0.0)
    rho_i = w.mean(0)
    return tuple(x.cpu().numpy() for x in (rho_u, rho_c, rho_i))


def check(name: str, rough: float = 0.2, device="cuda") -> float:
    """Print the three estimates for material `name` and return their
    largest spread over the channels."""
    rho_u, rho_c, rho_i = estimate_rho(MATERIALS[name], (0.5, 0.5, 0.5),
                                       (0.3, 0.3, 0.3), rough, device=device)
    print(f"material {name} roughness {rough}")
    print(f"  rho uniform-hemisphere : {rho_u}")
    print(f"  rho cosine-weighted    : {rho_c}")
    print(f"  rho importance-sampled : {rho_i}")
    spread = float(np.abs(np.ptp(np.stack([rho_u, rho_c, rho_i]),
                                 axis=0)).max())
    print(f"  max spread: {spread:.4f} "
          f"({'OK' if spread < SPREAD_LIMIT else 'INCONSISTENT'})")
    return spread


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        dev = argv[i + 1] if i + 1 < len(argv) else None
        del argv[i:i + 2]
        if dev not in ("cuda", "cpu"):
            print("bsdftest: --device takes cuda or cpu", file=sys.stderr)
            return 1
    name = argv[0] if argv else "matte"
    rough = float(argv[1]) if len(argv) > 1 else 0.2
    if name not in MATERIALS:
        print(f"unknown material {name!r}", file=sys.stderr)
        return 1
    dev = _device("bsdftest", dev)
    if dev is None:
        return 1
    return 0 if check(name, rough, dev) < SPREAD_LIMIT else 2


if __name__ == "__main__":
    sys.exit(main())
