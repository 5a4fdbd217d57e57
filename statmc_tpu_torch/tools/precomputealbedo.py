"""Albedo-LUT precompute tool (port of statmc_tpu/tools/precomputealbedo.py).

The counterpart of the reference's standalone precomputealbedo
(src/statistics/luts/precomputealbedo/): Monte Carlo tables of the
directional albedo over the nine families' grids (render/albedo_lut.py
FAMILY_AXES), with the reference's self-tests:

  --compare    LUT interpolation against fresh MC at 64 random off-grid
               coordinates, threshold 0.05 (main.cpp:50 LutCheckThreshold)
  --testlut    the interpolation's round trip at the grid points
  --benchmark  lookups/s of 2^20 coordinates against the direct MC rho()/s
               at 64 spp on 4,096 coordinates

Usage: python -m statmc_tpu_torch.tools.precomputealbedo --family metal
       [--sizes 16 16 8 8 8] [--samples 1024] [--seed 0] [--out lut.npz]
       [--compare] [--testlut] [--benchmark] [--device {cuda,cpu}]

It prints the JAX tool's lines, writes its .npz keys (data, sizes,
family) and returns its exit codes: 1 when --compare's maximum error
exceeds 0.05 or --testlut's round trip fails, and 1 when the card is
asked for (the default) and there is none.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import device as _device
from ..render.albedo_lut import (FAMILY_AXES, grid_coords, mc_albedo_at,
                                 precompute_family_nd)

COMPARE_THRESHOLD = 0.05


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="precomputealbedo")
    ap.add_argument("--family", default="matte",
                    choices=sorted(FAMILY_AXES.keys()))
    ap.add_argument("--sizes", type=int, nargs="*", default=None,
                    help="per-dimension table sizes (default 8/dim, "
                         "uber 4/dim, metal 16 16 8 8 8)")
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed offset (main.cpp --seedoffset)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--testlut", action="store_true")
    ap.add_argument("--benchmark", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="compute on the card (default) or on the CPU")
    return ap.parse_args(argv)


def _seconds(dev, fn):
    """(fn(), host seconds to its end on `dev`)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def run(args) -> dict:
    """The tool on parsed arguments: prints its lines and returns what
    it measured ("rc", "lut", "seconds", "texels", and per mode
    "compare" (max, mean), "testlut", "lookups_per_s", "rho_per_s");
    {"rc": 1} without the asked-for device."""
    dev = _device("precomputealbedo", args.device)
    if dev is None:
        return {"rc": 1}
    n_dims = len(FAMILY_AXES[args.family])
    lut, dt = _seconds(dev, lambda: precompute_family_nd(
        args.family, args.sizes, n_samples=args.samples, seed=args.seed,
        device=dev))
    print(f"precomputed {args.family} LUT {lut.sizes} ({n_dims}-D, "
          f"{args.samples} samples/texel) in {dt:.1f}s")
    res = {"rc": 0, "lut": lut, "seconds": dt, "texels": lut.data.shape[0]}
    if args.out:
        np.savez(args.out, data=lut.data.cpu().numpy(), sizes=lut.sizes,
                 family=args.family)
        print(f"wrote {args.out}")

    if args.compare:
        # Fresh MC at random off-grid parameters against the interpolated
        # LUT (main.cpp --testlut: warn past LutCheckThreshold).
        rng = np.random.default_rng(1 + args.seed)
        coords = torch.as_tensor(rng.random((64, n_dims)),
                                 dtype=torch.float32, device=dev)
        interp = lut.lookup(coords).cpu().numpy()
        truth = mc_albedo_at(args.family, coords,
                             n_samples=max(args.samples, 4096),
                             seed=args.seed + 7).cpu().numpy()
        err = np.abs(interp - truth)
        print(f"compare: max err {err.max():.4f} mean {err.mean():.4f} "
              f"(threshold {COMPARE_THRESHOLD})")
        res["compare"] = (float(err.max()), float(err.mean()))
        if err.max() > COMPARE_THRESHOLD:
            res["rc"] = 1
    if args.testlut:
        # Interpolation at the grid points gives the stored values back.
        c = torch.as_tensor(grid_coords(lut.sizes), device=dev)
        ok = np.allclose(lut.lookup(c).cpu().numpy(),
                         lut.data.cpu().numpy(), atol=1e-5)
        print(f"testlut: grid round trip {'OK' if ok else 'FAIL'}")
        res["testlut"] = ok
        if not ok:
            res["rc"] = 1
    if args.benchmark:
        rng = np.random.default_rng(2)
        coords = torch.as_tensor(rng.random((1 << 20, n_dims)),
                                 dtype=torch.float32, device=dev)
        lut.lookup(coords)

        def lookups():
            for _ in range(10):
                lut.lookup(coords)

        _, dt = _seconds(dev, lookups)
        res["lookups_per_s"] = 10 * coords.shape[0] / dt
        print(f"benchmark: {res['lookups_per_s'] / 1e6:.1f} M lookups/s")
        # The direct-MC comparison point (the reference reports ~100x:
        # precomputealbedo/README "about two magnitudes").
        small = coords[: 1 << 12]
        mc_albedo_at(args.family, small, n_samples=64)
        _, dt = _seconds(dev, lambda: mc_albedo_at(args.family, small,
                                                   n_samples=64))
        res["rho_per_s"] = small.shape[0] / dt
        print(f"benchmark: direct MC {res['rho_per_s'] / 1e6:.3f} "
              f"M rho()/s (64 spp)")
    return res


def main(argv=None) -> int:
    return run(parse_args(argv))["rc"]


if __name__ == "__main__":
    sys.exit(main())
