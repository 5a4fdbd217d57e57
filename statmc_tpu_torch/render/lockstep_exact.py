"""Exact lockstep replay: serial-consumption parity with the reference
(port of statmc_tpu/render/lockstep_exact.py).

The reference's RandomSampler is one serial PCG32 per 16x16 tile
(src/samplers/random.cpp:68), never reseeded between pixels or samples,
and pbrt consumes draws conditionally (core/lockstep.py's docstring has
the rules).  So the stream position of every draw depends on how many
draws every earlier sample of the tile consumed.  Here the lanes are
tiles, and the replay walks (pixel-in-tile, sample) in the reference's
serial order: pixels row-major over the cropped tile, each pixel's
samples back to back (statpath.cpp:255-294).  A per-tile stream cursor
rides the bounce carry (integrator._bounce_step, MODE_LOCKSTEP_EXACT)
and advances as the reference's control flow would, so every draw site
reads the value pbrt's sampler would give it.

A parity instrument, not a fast path: max_px * spp samples in the
tiles' serial order, a few at a time (render_exact's docstring).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lockstep as LS
from ..core import rng as crng
from . import camera as CAM
from .integrator import IntegratorConfig, _bounce_step, _scrub_ls, \
    _zero_path_carry


class ExactReplay(NamedTuple):
    """Per-(pixel, sample) replay record, numpy arrays.

    cursor_start[p, s]: the tile-stream position at which sample s of
    pixel p began consuming (its pFilm.x draw); cursor_end[p, s] where it
    stopped.  u_cam[p, s]: the film jitter consumed there.  radiance[p, s]:
    the sample's film estimate; radiance_b[p, s, k]: the radiance arriving
    from bounce k onward (the t0-bK buffers' per-sample input)."""
    cursor_start: np.ndarray  # [P, S] int32
    cursor_end: np.ndarray  # [P, S] int32
    u_cam: np.ndarray  # [P, S, 2] f32
    radiance: np.ndarray  # [P, S, 3] f32
    film: np.ndarray  # [P, 3] f32 mean over samples
    radiance_b: np.ndarray = None  # [P, S, NL, 3]


# Lanes a round may trace: on the CPU wider ops cost more, on the card
# launches cost most.
LANE_BUDGET = {"cpu": 1024, "cuda": 16384}


def _lookahead(T: int, spread: int, lane_budget: int) -> int:
    """The most samples a round can trace ahead within lane_budget lanes:
    sample k of a round needs k * spread + 1 candidate starts per tile."""
    K = 1
    while T * ((K + 1) + spread * K * (K + 1) // 2) <= lane_budget:
        K += 1
    return K


def render_exact(scene, bvh, dist, cfg: IntegratorConfig, cam, width: int,
                 height: int, spp: int, base_seed: int = 0,
                 albedo_luts=None) -> ExactReplay:
    """Serial-order replay of one render iteration at `spp` samples, on
    the device of the scene tables.  cfg.sampler_mode must be
    MODE_LOCKSTEP_EXACT; the feedback inputs are neutral (iteration 1).

    A sample's result depends only on its pixel and the stream position
    it starts at, and a sample consumes between D_CAMERA and
    D_CAMERA + D_BOUNCE * max_depth draws.  So each round traces the
    next K samples of every tile at once: the first at the tile's known
    cursor, sample k at every start the k samples before it could leave
    (LANE_BUDGET bounds the lanes), and then picks, tile by tile and
    sample by sample, the lane that starts where its predecessor ended.
    The result is the one-sample-at-a-time replay's, in K times fewer
    serial steps."""
    assert cfg.sampler_mode == crng.MODE_LOCKSTEP_EXACT
    dev = scene.tri_p0.device
    stream, pixel_of_tile, n_px = LS.make_streams(
        width, height, spp, cfg.max_depth, base_seed)
    T, max_px = pixel_of_tile.shape
    streams = torch.as_tensor(stream, device=dev)  # [T, L]
    W = width
    NL, NB = cfg.n_ls, max(cfg.nb_mis, 1)
    n_steps = cfg.max_depth + 1 + cfg.null_extra
    lo, hi = LS.D_CAMERA, LS.D_CAMERA + LS.D_BOUNCE * cfg.max_depth
    K = _lookahead(T, hi - lo, LANE_BUDGET[dev.type])
    J = max_px * spp
    P = width * height
    out_cs = np.zeros((P, spp), np.int32)
    out_ce = np.zeros((P, spp), np.int32)
    out_uc = np.zeros((P, spp, 2), np.float32)
    out_lb = np.zeros((P, spp, NL, 3), np.float32)
    cursor = np.zeros(T, np.int64)
    for j0 in range(0, J, K):
        k_n = min(K, J - j0)
        # Lanes: for each tile t and look-ahead k, the starts
        # cursor[t] + k lo .. cursor[t] + k hi (k = 0: the cursor only).
        first = [0]  # lane of (t, k) with offset k * lo
        tile_l, k_l, off_l = [], [], []
        for t in range(T):
            for k in range(k_n):
                offs = np.arange(k * lo, k * hi + 1)
                tile_l.append(np.full(len(offs), t))
                k_l.append(np.full(len(offs), k))
                off_l.append(offs)
                first.append(first[-1] + len(offs))
        tile = np.concatenate(tile_l)
        start = cursor[tile] + np.concatenate(off_l)
        i = (j0 + np.concatenate(k_l)) // spp
        pid = pixel_of_tile[tile, i]
        valid = (i < n_px[tile]) & (pid >= 0)
        R = len(tile)

        tile_d = torch.as_tensor(tile, device=dev)
        start_d = torch.as_tensor(start, device=dev)
        pid_d = torch.as_tensor(np.maximum(pid, 0), device=dev)
        u_cam = torch.stack([streams[tile_d, start_d + k] for k in (0, 1)],
                            dim=-1)
        pxy = torch.stack([(pid_d % W).to(torch.float32),
                           (pid_d // W).to(torch.float32)], dim=-1)
        o, d = CAM.generate_rays(cam, pxy + u_cam)
        carry = dict(o=o, d=d, **_zero_path_carry(R, NL, NB, dev))
        carry["active"] = torch.as_tensor(valid, device=dev)
        carry["cursor"] = (start_d + lo).to(torch.int32)
        fill = dict(avg_ls=torch.ones((R, NL), device=dev),
                    win_bsdf=torch.zeros((R, NB), device=dev),
                    win_light=torch.zeros((R, NB), device=dev))
        keys = torch.zeros((R, 2), dtype=torch.int64, device=dev)
        for step in range(n_steps):
            # Once every lane is done no later step draws or adds
            # anything, so the round stops there.
            if not bool(carry["active"].any()):
                break
            carry = _bounce_step(scene, bvh, dist, cfg, carry, step, keys,
                                 fill["avg_ls"], fill["win_bsdf"],
                                 fill["win_light"], False, albedo_luts,
                                 (streams, tile_d))
        end = carry["cursor"].cpu().numpy().astype(np.int64)
        ls = _scrub_ls(carry["ls"]).cpu().numpy()
        uc = u_cam.cpu().numpy()

        # Each tile's chain: sample k starts where sample k - 1 ended.
        for t in range(T):
            c = cursor[t]
            for k in range(k_n):
                lane = first[t * k_n + k] + (c - cursor[t]) - k * lo
                if not valid[lane]:
                    break  # the tile's pixels are done
                p, s = pid[lane], (j0 + k) % spp
                out_cs[p, s], out_ce[p, s] = c, end[lane]
                out_uc[p, s] = uc[lane]
                out_lb[p, s] = ls[lane]
                c = end[lane]
            cursor[t] = c
    out_ls = out_lb[:, :, 0]
    return ExactReplay(
        cursor_start=out_cs, cursor_end=out_ce, u_cam=out_uc,
        radiance=out_ls, film=out_ls.mean(axis=1), radiance_b=out_lb)


def moments_from_samples(ls: np.ndarray, bc_lambda: float | None = 0.5):
    """Per-pixel (n, mean, m2, m3) over the sample axis in the reference's
    accumulation order and precision (StatTile::AddStatSampleM3,
    estimator.h:188-205: Meng's update in f32, samples in their in-pixel
    order); with bc_lambda set the samples pass through the Box-Cox
    transform first (estimator.h:135-145), None keeps them raw (the
    film-mean/film-m2 track).  Copied from the JAX package (numpy).

    ls: [P, S, C].  Returns (n [P], mean, m2, m3 [P, C]) float32."""
    P, S, C = ls.shape
    x = ls.astype(np.float32)
    if bc_lambda is not None:
        lam = np.float32(bc_lambda)
        x = (np.power(np.maximum(x, 0.0), lam, dtype=np.float32)
             - np.float32(1.0)) / lam
    n = np.zeros((P,), np.float32)
    mean = np.zeros((P, C), np.float32)
    m2 = np.zeros((P, C), np.float32)
    m3 = np.zeros((P, C), np.float32)
    for s in range(S):
        v = x[:, s]
        n += 1
        d = v - mean
        d2 = d * d
        dN = d / n[:, None]
        dN2 = dN * dN
        mean += dN
        m2 += d * (d - dN)
        # estimator.h:204: m3 reads the already-updated m2.
        m3 += -np.float32(3.0) * dN * m2 + d * (d2 - dN2)
    return n, mean, m2, m3
