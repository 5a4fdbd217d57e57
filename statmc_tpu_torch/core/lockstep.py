# Copied from statmc_tpu/core/lockstep.py (numpy host code; behaviour unchanged).
"""Lockstep sampler: replay the reference's exact PCG32 draw streams.

The reference's RandomSampler is one serial PCG32 per 16x16 tile, seeded
SetSequence((baseSeed+1)*(tileIndex+1)) at Clone time
(src/samplers/random.cpp:52,68,86-87; tile grid + Clone(tileIndex) at
src/statistics/statpath.cpp:132-184), with draws consumed in strict
order as the tile loop walks pixels row-major and each pixel runs its
samples back-to-back (statpath.cpp:269-375).

Draw order per sample (verified against the reference sources):
  camera   GetCameraSample: 2D film jitter, 1D time, 2D lens
           (src/core/sampler.cpp:56-62)  -> 5 values
  bounce b (statpath.cpp:761-958):
           1D light select   (statpath.cpp:744/747)
           2D uLight         (statpath.cpp:751)
           2D uScattering    (statpath.cpp:752)
           2D BSDF sample    (statpath.cpp:869)
           1D Russian roulette (statpath.cpp:948)  -> 8 values

This module precomputes table[pixel, sample, dim] on the host with a
bit-exact PCG32 (same constants/output function as src/core/rng.h:61-63,
130-145) under a FIXED per-sample consumption layout of
D = 5 + 8*n_steps values.  The wavefront integrator consumes the table
positionally (core/rng.py MODE_LOCKSTEP), so every draw site receives
the exact value pbrt's sampler would produce at that stream position.

Two replay modes share the host PCG32:

* PADDED (make_table, MODE_LOCKSTEP): a fixed per-sample layout of
  D = 5 + 8*n_steps values.  Device-speed, but the serial stream
  position drifts from the reference after any early-terminated path
  (pbrt consumes draws conditionally).  Use it when only per-site
  value distribution matters.
* EXACT (make_streams + render/lockstep_exact.py,
  MODE_LOCKSTEP_EXACT): replays pbrt's *conditional* consumption.
  Each tile's raw serial stream is materialized once; the replay
  driver walks (pixel-in-tile, sample) in the reference's serial
  order and threads a per-tile stream cursor through the bounce scan,
  advancing it exactly as the reference's control flow would:
    camera        5 draws, always     (core/sampler.cpp:56-62)
    NEE           5 draws iff the hit BSDF has non-specular lobes
                  (statpath.cpp:846 NumComponents guard; select +
                  uLight + uScattering, statpath.cpp:744-752; the
                  SMIS variant consumes identically -- EstimateDirect-
                  SMIS never touches the sampler, statpath.cpp:552-730)
    continuation  2 draws iff found && bounces < maxDepth && bsdf
                  non-null (statpath.cpp:869; consumed even when
                  f==0/pdf==0 breaks after)
    RR            1 draw iff bounces > 3 && alive && survivalRate <
                  rrThreshold (statpath.cpp:941-948: Get1D sits
                  inside BOTH conditionals)
    null BSDF     0 draws (statpath.cpp:823-827 re-spawns before any
                  sampler call)
  Seeding, tile decomposition, draw order, the PCG32 stream, and the
  per-sample stream positions are all exact; see
  tests/test_lockstep_exact.py for the positional-parity proof on a
  mixed-path-length multi-sample tile.  (Out of scope: media/BSSRDF
  draw sites, and the zero-probability light-select early-out of
  Distribution1D::SampleDiscrete, which consumes 1 draw instead of 5
  -- unreachable under the uniform/power strategies.)
"""
from __future__ import annotations

import numpy as np

TILE = 16
_MULT = np.uint64(0x5851F42D4C957F2D)
_DEFAULT_STATE = np.uint64(0x853C49E6748FEA9B)
_ONE_MINUS_EPS = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))

# Per-sample table layout.
D_CAMERA = 5           # film.x film.y time lens.x lens.y
D_BOUNCE = 8           # select uL.x uL.y uS.x uS.y bsdf.x bsdf.y rr
OFF_SELECT = 0
OFF_LIGHT = 1
OFF_SCATTER = 3
OFF_BSDF = 5
OFF_RR = 7


def dims_per_sample(n_steps: int) -> int:
    return D_CAMERA + D_BOUNCE * n_steps


def _advance(state: np.ndarray, inc: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return state * _MULT + inc


def _output(state: np.ndarray) -> np.ndarray:
    xorshifted = (((state >> np.uint64(18)) ^ state) >> np.uint64(27)).astype(
        np.uint32)
    rot = (state >> np.uint64(59)).astype(np.uint32)
    return (xorshifted >> rot) | (
        xorshifted << ((np.uint32(32) - rot) & np.uint32(31)))


def _set_sequence(initseq: np.ndarray):
    """rng.h:130-136: state=0, inc=(seq<<1)|1, advance, +=DEFAULT, advance."""
    inc = ((initseq.astype(np.uint64) << np.uint64(1)) | np.uint64(1))
    state = np.zeros_like(inc)
    state = _advance(state, inc)
    with np.errstate(over="ignore"):
        state = state + _DEFAULT_STATE
    state = _advance(state, inc)
    return state, inc


def _uniform_float(state: np.ndarray, inc: np.ndarray):
    """rng.h UniformFloat: min(1-eps, u32 * 0x1p-32f); advance-then-output
    order matches UniformUInt32 (oldstate used for output)."""
    old = state
    state = _advance(state, inc)
    u = _output(old).astype(np.float64) * 2.3283064365386963e-10
    return np.minimum(u.astype(np.float32), _ONE_MINUS_EPS), state


def make_table(width: int, height: int, spp: int, n_steps: int,
               base_seed: int = 0) -> np.ndarray:
    """table[P, spp, D] of f32 draws, P = width*height row-major.

    Reproduces the per-tile serial order: within tile (tx, ty), pixels
    row-major over the cropped tile bounds, each pixel's spp samples
    consecutive, each sample consuming exactly dims_per_sample(n_steps)
    values (the padded layout documented above).
    """
    D = dims_per_sample(n_steps)
    n_tx = (width + TILE - 1) // TILE
    n_ty = (height + TILE - 1) // TILE
    T = n_tx * n_ty
    tile_index = np.arange(T, dtype=np.uint64)
    with np.errstate(over="ignore"):
        seq = np.uint64(base_seed + 1) * (tile_index + np.uint64(1))
    state, inc = _set_sequence(seq)

    # Serial index of each pixel within its tile (row-major over the
    # tile's cropped bounds), and each pixel's tile id.
    ys, xs = np.divmod(np.arange(width * height), width)
    tx, ty = xs // TILE, ys // TILE
    tid = ty * n_tx + tx
    tw = np.minimum((tx + 1) * TILE, width) - tx * TILE  # cropped tile width
    idx_in_tile = (ys - ty * TILE) * tw + (xs - tx * TILE)

    max_px = int(idx_in_tile.max()) + 1
    draws_per_tile = max_px * spp * D
    stream = np.empty((T, draws_per_tile), dtype=np.float32)
    for k in range(draws_per_tile):
        stream[:, k], state = _uniform_float(state, inc)

    base = (idx_in_tile * spp)[:, None, None] * D \
        + np.arange(spp)[None, :, None] * D \
        + np.arange(D)[None, None, :]
    return stream[tid[:, None, None], base]


def _tile_geometry(width: int, height: int):
    """(tid [P], idx_in_tile [P], n_tx, n_ty): the reference's 16x16
    tile decomposition with cropped tile bounds (statpath.cpp:132-184),
    pixels row-major within each cropped tile."""
    n_tx = (width + TILE - 1) // TILE
    n_ty = (height + TILE - 1) // TILE
    ys, xs = np.divmod(np.arange(width * height), width)
    tx, ty = xs // TILE, ys // TILE
    tid = ty * n_tx + tx
    tw = np.minimum((tx + 1) * TILE, width) - tx * TILE
    idx_in_tile = (ys - ty * TILE) * tw + (xs - tx * TILE)
    return tid, idx_in_tile, n_tx, n_ty


def make_streams(width: int, height: int, spp: int, max_depth: int,
                 base_seed: int = 0):
    """Raw serial per-tile PCG32 streams for the EXACT replay mode.

    Returns (stream [T, L] f32, pixel_of_tile [T, max_px] int32 with -1
    padding, n_px [T] int32).  L = max_px * spp * (5 + 8*max_depth): a
    per-sample worst case (every bounce shading + RR-drawing) bound on
    conditional consumption, so no tile can run off its stream.
    """
    tid, idx_in_tile, n_tx, n_ty = _tile_geometry(width, height)
    T = n_tx * n_ty
    tile_index = np.arange(T, dtype=np.uint64)
    with np.errstate(over="ignore"):
        seq = np.uint64(base_seed + 1) * (tile_index + np.uint64(1))
    state, inc = _set_sequence(seq)

    max_px = int(idx_in_tile.max()) + 1
    D = D_CAMERA + D_BOUNCE * max_depth
    L = max_px * spp * D
    stream = np.empty((T, L), dtype=np.float32)
    for k in range(L):
        stream[:, k], state = _uniform_float(state, inc)

    pixel_of_tile = np.full((T, max_px), -1, np.int32)
    pixel_of_tile[tid, idx_in_tile] = np.arange(width * height)
    n_px = (pixel_of_tile >= 0).sum(axis=1).astype(np.int32)
    return stream, pixel_of_tile, n_px
