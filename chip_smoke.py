#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (statmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py --kernels  # phases 1-4b, 7b and 11 only: the
                                     # kernels against their plain
                                     # versions, no result lines
    python3 chip_smoke.py --mesh     # phases 1-4b and 8l only: B1, B2,
                                     # B2 on halo slabs, R1 and the mesh
                                     # phases, no result lines
    python3 chip_smoke.py --albedo   # phases 1-4b and 8m only: the
                                     # albedo-LUT precompute and
                                     # bsdftest (flags combine: each
                                     # group they name)
    python3 chip_smoke.py --other DIR  # also time B2 and B3 built from the
                                       # tree DIR (say, the parent commit
                                       # unpacked by git archive), in
                                       # turns with this tree's, on the
                                       # same inputs

Phases, one line each; any failure raises, so the exit code is non-zero
and the final line is not printed:

1. require CUDA and print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from statmc_tpu_torch/csrc/ with nvcc, and
   print what ptxas and the runtime report for B1 and B4 (registers,
   spills, resident blocks per SM);
3. kernel B1 (fused intersector) against its plain PyTorch version on the
   staircase proxy's table and on a 16,384-triangle table, 2^20 rays:
   ids equal on every ray and t equal as bits;
4. kernel B2 (statistical filter) against its plain version at 1280x720,
   radius 20, C = 3, G = 6, CF = 3, normalized and not; then each of its
   five other forms (range_bf16, accept_expand, accept_bf16 and their
   pairs, denoise/filter_cuda.py FORMS) against its plain version on a
   256x144 crop with its halo of 20 (the crop's centre equal to the whole
   image's kernel output bit for bit), timed on the whole image, with its
   bound at its own accepted share and its relative error against the
   f32 form's output;
4a. kernel B2 on the mesh's halo slabs: inputs of phase 4's kind cut
   into 2 and 4 row slabs, each extended by 20 rows of its neighbours
   and by zeros with valid = 0 past the image's edges: the kernel
   against its plain version on every slab, and the slabs' centre rows
   equal to the whole image's output bit for bit;
4b. kernel R1 (threefry draw sites) against its plain version at 921,600
   lanes: a 2D draw site and pixel_keys bit for bit, one launch a call,
   CUDA-event medians of both beside R1's bound, and the device kernels
   one call of each launches;
5. the staircase main path: ``load(scene).render(iterations=2)`` on the
   staircase proxy at 1280x720, maxdepth 8, filter radius 20, albedo +
   normal G-buffers, 4 spp, with B1's and B2's launch counts (B2's by
   form too: every launch the default f32 form's) set to 0 just before
   it and read just after;
6. kernel B2 against its plain version on the render's own inputs: the
   arguments iteration 2's denoise passes to run_filter, captured by
   running that denoise once more; normalized and not, with the
   accepted share and the bound at it; and its five other forms as in 4,
   each within a mean relative error of 2e-3 of the f32 form's output;
6a. that denoise once more through ``Renderer(setup,
   denoiser=StatDenoiser(..., range_bf16=True))`` on the same states: B2's
   launches by form set to 0 just before and read just after (the
   range_bf16 form must launch, and no other), the film-f finite, not
   equal to the f32 denoise's and within a mean relative error of 2e-3
   of it;
7. the same call as 5 on a small staircase proxy (32x24) on the card and
   through the plain PyTorch path on the CPU, which the CPU tests hold
   against the JAX package: the buffers must agree;
7a. samplers: one 1280x720 staircase iteration (2 spp) under random,
   halton, sobol and 02sequence, once each (rays/s, B1's launches
   around each), then 7 under each LD mode and lockstep;
7b. B2 as the backward kernel of denoise/grad.py's FilterApply: one
   forward + backward at 1280x720, r = 20 (B2's launches counted around
   it), the gradient against the plain version's VJP and, on a 96x96
   crop at r = 5, against filter_apply_diff's autograd; the backward
   kernel's time and bound, and forward + backward;
7c. reference parity: Renderer.render_lockstep_exact on the five scenes
   of tests/fixtures/refparity/ (B1's launches around each), held to
   the C++ reference's own PFMs at tests/test_refparity.py's tolerances;
   B1 against its plain version, bit for bit, on the recorded inputs of
   every B1 call of those replays (down to 1-4 live rays a call);
7d. checkpoint: a small staircase interrupted after iteration 1, saved,
   restored into a fresh renderer and finished, equal bit for bit to the
   uninterrupted render; B1's and B2's launches set to 0 just before the
   resumed iteration, read just after, and both must be above 0;
8. the terrain main path (the large-scene, two-level path):
   ``load(terrain).render(iterations=1)`` on the 131,554-triangle terrain
   proxy at 1280x720, 4 spp, maxdepth 8, with B3's and B4's launch counts
   set to 0 just before it and read just after;
8a. the textured terrain: the same terrain (at FEATURE_SPP = 2 spp) with
   textures of every kind
   (a 2048x2048 imagemap floor at uscale = vscale = 8, checkerboard boxes,
   fbm, wrinkled, windy, marble, dots, uv, bilerp, mix and scale on the
   spheres), an environment-mapped infinite light (a 2048x1024 EXR) and a
   projection light (a 512x512 image), every image made from SEED and
   written by the port's own writers, denoised: every kernel's launch
   count set to 0 just before its iteration and read just after (B2, B3
   and B4 must launch); film finite with mean > 0; the albedo G-buffer's
   detail above the untextured terrain's; rays/s beside the untextured
   terrain's;
8b. hair and subsurface scattering at full width: the staircase with a
   768-curve hair tuft (two hair materials, eumelanin and rgb color),
   three kdsubsurface and two subsurface spheres and a quarter of the
   clutter boxes kdsubsurface (13,358 triangles, fused path, 2
   iterations), then the terrain with a 2,048-curve tuft, 40 of the 120
   boxes kdsubsurface and 16 of the 48 spheres subsurface (164,322
   triangles, two-level), both at the untextured scenes' settings but
   FEATURE_SPP = 2 spp, and
   denoised: every kernel's launch count set to 0 just before the render
   and read just after (B1 and B2 on the staircase, B2, B3 and B4 on the
   terrain must launch); films finite with mean > 0; hair and subsurface
   materials each on >= 5% of the camera rays' first hits; rays/s beside
   the untextured scene's, peak device memory, and per iteration the
   lanes that ran the Marschner model, the lanes where the SSS block
   fired, the share of those whose Sample_Sp succeeded and the probe
   chain's live rays; on the terrain, B3's surviving boxes per block and
   B4's dense-walk blocks on the camera rays;
8c. SSS probe calls: the inputs of every intersect call of one bounce
   step of both renders (the 4 probe calls and the exit vertex's shadow
   and BSDF-MIS calls among them) recorded, and held bit for bit: B1
   against its plain version on the staircase's (the SSS block's calls
   on all their rays, the step's other calls on 32,768 rays each); B3's votes on every block and B4's (t, id) on every
   block with a live ray on the terrain's SSS calls, on 64 blocks of the
   others;
8d. volpath at full width: the staircase under volpath with a
   homogeneous haze the camera starts in, a 128^3 grid smoke (made from
   SEED) behind a null-material box, three Fourier spheres and a quarter
   of the boxes Fourier (.bsdf tables written by the port's write_bsdf
   from SEED), VOLPATH_SPP = 1 spp, 1 iteration, maxdepth 8, denoised:
   B1 and B2 must
   launch (counts set to 0 just before, read just after); every buffer
   finite, film mean > 0; Fourier on >= 5% of first hits; the share of
   camera paths with a medium vertex and in the smoke; rays/s beside the
   untextured staircase's, peak device memory; per bounce step the
   lanes, intersect calls, walk segments against K and the lanes that
   entered delta and ratio tracking, and the loops' iterations against
   their caps (render/volume.py's track_stats);
8e. volpath walk calls: B1 against its plain version bit for bit on
   every intersect call of that render's first bounce step, the walks'
   on all their rays, the camera path's on 32,768 seeded rays;
8f. the realistic camera: the staircase through Camera "realistic"
   (tests/fixtures/biconvex.dat, focused on the stairs, a 4 mm stop) at
   the main path's settings: B1 and B2 must launch (counts set to 0
   just before the render, read just after); every buffer finite, film
   mean > 0; the share of camera rays the lens lets through; rays/s
   beside the staircase's, peak device memory;
8g. the kd-tree: the staircase under `Accelerator "kdtree"` (1 spp, 1
   iteration, denoised): B2 must launch and B1 must not; the SAH
   build's seconds, node count, depth and widest leaf; the walk's steps
   a call (mean and maximum) against its cap, and steps a ray;
8h. ao on the staircase (64 cosine probes, 4 spp; B1 must launch) and
   on the terrain (1 spp; B3 and B4 must launch): rays/s beside the
   statpath scene's;
8i. sppm on the staircase (maxdepth 5, one photon a pixel, radius
   0.05, 2 passes; B1 must launch): per pass the grid deposit's pairs
   tested and kept, photons a visible point, the radius's shrink, and
   pass 1 run twice (two renderers) equal bit for bit;
8j. bdpt on the staircase (maxdepth 5, 1 spp, 2 iterations; B1 must
   launch, B2-B4 must not): the t = 1 splat lanes and pixels a sample,
   rays/s (the JAX package's nominal count) beside the staircase's, peak
   memory, iteration 1 run twice (two renderers) equal bit for bit; bdpt
   on the terrain (1 spp, 1 iteration; B3 and B4 must launch), rays/s
   beside the terrain's; mlt on the staircase (bidirectional, maxdepth
   5): the bootstrap, then half a mutation a pixel (57 steps of 8,192
   chains; B1 must launch): b, the acceptance rate, the share of large
   steps, steps/s, mutations/s beside the staircase's rays/s, peak
   memory;
8l. the mesh (statmc_tpu_torch/parallel/), before every profile: the
    1280x720 staircase with ACRR and SMIS (MESH_SPP = 2 spp, 2
    iterations, denoised at radius 20) through ``python -m
    statmc_tpu_torch --mesh 1x1`` in a subprocess (a world of one over
    NCCL; B1 and B2 from its ``Kernel launches by rank:`` line), then on
    a 2x2 mesh of four spawned ranks on cuda:0 over gloo (the denoise on
    halo row slabs; B1 and B2 launched on every rank), both held against
    the one-device render of the same file through the per-sample
    driver: n exact, the film after iteration 1 within rtol 1e-4 / atol
    1e-5 on every pixel; after iteration 2 film, film-f and the ACRR
    feedback on >= 99.5% of the pixels, the 2x2's feedback against the
    one-device render continued from the 2x2's iteration-1 feedback,
    after showing that iteration 1 differs in the Radiance m3 alone and
    that m3 gives the 2x2's film-f and feedback bit for bit; the 2x2's
    film-f and feedback equal to the whole-image filter's on its own
    gathered states on every pixel; each mesh's rays/s beside the
    per-sample driver's and its collectives' ms an iteration (host clock
    between synchronizes).  With 4 cards also --mesh 2x2 and --mesh 1x4
    through the CLI over NCCL, one card a rank, bit for bit equal to the
    2x2 on one card and to the 1x1;
8m. the albedo LUTs (statmc_tpu_torch/tools/precomputealbedo, no
    kernel of csrc/ on the path), before every profile: all nine families
    at their default sizes and 1,024 samples a texel on the card with
    --compare (<= 0.05 but for glass, metal and uber, whose grids from
    the JAX package miss it), --testlut and --benchmark: seconds,
    texels, BSDF samples/s, the compare error, the round trip, peak
    memory, M lookups/s, M rho()/s; each family at 3 texels an axis
    (uber 2) and 64 samples on the card and on the CPU, all texels
    within 1e-3 and the share within rtol 1e-4 against 99% (reported);
    bsdftest's five materials on the card, each with a spread < 0.05;
8k. each of 8f-8j but the kd-tree once more under torch.profiler, device
   only (after all their unprofiled renders): kernels an iteration (one
   sample: the realistic staircase's of its 4; BDPT's iteration 3; two
   MLT steps), device ms, busy share, B1-B4's ms, and
   the seconds each profile took;
9. the staircase's iteration 2 once more under torch.profiler (device
   activity only): B1's device time per iteration, and B2's from that
   iteration's denoise pass profiled once more on its own; then one more
   terrain iteration under torch.profiler: device time by
   kernel (B3's and B4's per iteration) and by stage of the two-level
   intersect call (partition, slab rays, B3, worklists, features, B4,
   unsort), and the device's busy share of the unprofiled iteration;
   the rays of that iteration's B3 calls are kept; then the textured
   terrain's iteration under torch.profiler: kernels, device time and
   busy share beside the untextured terrain's, and the device ms inside
   the ``textures.sample_texture`` and ``lights.env_map`` ranges; then
   one sample of the hair + SSS staircase: kernels, device ms and busy
   share beside a sample of the untextured staircase's, device ms inside the
   ``hair.eval_f``, ``hair.sample_wi``, ``sss.sample_sp``, ``sss.probe``
   and ``sss.direct`` ranges, B1's ms (B2's from its denoise pass alone);
   and the hair + SSS terrain's iteration (device only) for B2, B3, B4;
   then the volpath iteration (its one sample, host and device):
   kernels, device ms, busy share, B1's and B2's ms, and device ms
   inside the ``volume.*`` and ``fourier.*`` ranges;
10. kernel B3 on those rays: its time over all calls; votes against the
    two-stage plain cull, and the reject tests, per-ray tests and
    surviving boxes per block that its design spends there, on every
    call;
11. kernels B3 (subgroup cull) and B4 (worklist walk) against their plain
    versions on the terrain's table: its 1280x720 camera rays (sorted, as
    the main path sorts them) and 2^20 random rays grazing the terrain
    floor (unsorted, a third each unbounded, finite and dead, so that
    blocks overflow the worklist and walk densely); B3 compared on every
    block of both, with its reject and per-ray tests, surviving boxes per
    block and both bounds (the design's count and the flat sweep's); B4
    compared on 64 blocks of each (timed on all and on those 64);
12. a small terrain proxy (32x24, 19,554 triangles, still two-level) on
    the card and on the CPU: the buffers must agree;
12b. the textured staircase (32x24, every texture kind, an environment
    map, a goniometric light) on the card and on the CPU: equal ray
    totals, every buffer within rtol 1e-4 on >= 99% of its pixels, B1
    and B2 launched on the card;
12c. the hair + SSS staircase at 32x24 (a 128-curve tuft) on the card
    and on the CPU: equal ray totals, every buffer within rtol 1e-4 on
    >= 97% of its pixels (HAIR_SMALL_SHARE), B1 and B2 launched on the
    card;
12d. volpath two-level: the terrain (n = 96, 19,566 triangles) under
    volpath with the haze and a 16^3 smoke behind a null box, 64x36, 1
    spp: B3 and B4 must launch; B3's votes on every block and B4's (t,
    id) on every block with a live ray against their plain versions,
    bit for bit, on every intersect call of one bounce step (the walks'
    included); its iteration profiled (device only);
12e. volpath small: the volpath staircase at 32x24 (a 16^3 smoke, 2 spp,
    2 iterations) on the card and on the CPU: ray totals within 0.1%,
    every buffer within rtol 1e-4 on >= 98% of its pixels, B1 and B2
    launched on the card;
12f. the realistic, kd-tree, ao and sppm staircases at 32x24 on the
    card and on the CPU: equal ray totals, every buffer within rtol
    1e-4 on >= 98% of its pixels, the kernels of each path launched on
    the card;
12g. the bdpt staircase at 32x24 (maxdepth 4, 2 iterations) on the card
    and on the CPU, as 12f (B1 launched); mlt at 32x24 (maxdepth 3), both
    mutation modes, N_CHAINS and N_BOOTSTRAP cut to 512 and 1,024 on
    both sides: b within rtol 1e-4, the bootstrap's chains, the first
    step's proposals and accepts and its splat pixels (rtol 1e-4) on >=
    98%, after 3 steps >= 90% of the chains still identical and the
    film's mean within 2%, B1 launched on the card;
12a. the command line: ``python -m statmc_tpu_torch`` in a subprocess on
    the 1280x720 staircase with configs/render-for-ours.pbrt's block (cut
    to maxdepth 8 and 4 spp), 2 iterations, every buffer written; then
    ``--denoise`` with configs/denoise.pbrt's block; every PFM finite,
    film-f equal to the same render denoised in memory (rtol 1e-4 / atol
    1e-5); each subprocess reports its kernels' launches (the CLI's
    ``Kernel launches:`` line): B1 in the render, B2 in --denoise;
13. one JSON line of this slice's workflow results, one of per-kernel
    results, then the device line.

Kernel times are CUDA-event medians of 10 runs after 3 warm-ups; a plain
version runs once, and its time is that one CUDA-event reading.  Each
kernel's bound (bound_ms) is the larger of its FP32 operations over
67 TFLOP/s and its bytes (each input read once, each output written
once) over 3.35 TB/s, the H100 SXM's published peaks, counting the work
these inputs need; B2's bf16 operations count half an FP32 one (a bf16x2
instruction does two in one FP32 issue slot: the non-tensor bf16 peak,
133.8 TFLOP/s, is twice the FP32 one).  main_path_ms is the kernel's
device time over one profiled iteration of the main path that runs it.
Every time is printed with the card's name and power limit.  Imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, SPP, MAXDEPTH, RADIUS = 1280, 720, 4, 8, 20
N_RAYS = 1 << 20
# H100 SXM peaks: FP32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# FP32 operations per unit of work (an FMA counts two):
# (ray, triangle): the three edge forms need 18 FMAs and the inside test
# ~7 operations; the plane forms (7 FMAs), the division and the compares
# are needed only by the small share of pairs that are inside, which the
# count neglects (that only lowers the bound).
B1_OPS = 2 * 18 + 7
# The count before the plane forms were evaluated lazily: all five forms
# (25 FMAs) + a 15-operation epilogue for every pair.
EAGER_OPS = 2 * 25 + 15
B2_OPS_REJECT = 3 * 5  # (pixel, neighbour): the 3-channel acceptance test
# An accepted pair adds its weight (spatial 3, G = 6 planes x 4), expf
# (~8), valid and wsum (2) and the CF = 3 sums (2 each).
B2_OPS_ACCEPT = B2_OPS_REJECT + 3 + 6 * 4 + 8 + 2 + 3 * 2
# B2's forms (denoise/filter_cuda.py FORMS) at that shape, in FP32
# operations: the test a pair (direct, expanded: an FMA (2) and a compare a
# channel, bf16: difference, square, sum and compare a channel) and the
# weight an accepted pair (f32 range, or the bf16 one: the spatial term,
# 6 planes x difference, square and subtraction in bf16, expf, valid and
# wsum, the 3 sums).  A bf16 operation is one half of a bf16x2
# instruction, which takes one FP32 issue slot, so it counts half: the
# H100 SXM's non-tensor bf16 peak (133.8 TFLOP/s) is twice its FP32 one.
# Conversions to and from bf16 are not counted.
B2_TEST_OPS = {"f32": B2_OPS_REJECT, "expand": 3 * 3, "bf16": 3 * 4 / 2}
B2_WEIGHT_OPS = {"f32": B2_OPS_ACCEPT - B2_OPS_REJECT,
                 "bf16": 3 + 6 * 3 / 2 + 8 + 2 + 3 * 2}
# Rows and columns of the crop on which B2's other forms meet their plain
# versions (with a halo of r on every side): the plain version takes ~1 s
# a call on the whole 1280x720 image.
B2_CROP = (144, 256)
B3_OPS = 20  # (ray, subgroup box) slab test
# (sub-block, box) reject of the redesigned B3: per axis 4 subtractions,
# 8 products, 14 min/max and 2 merges; then the product and 2 compares.
B3_REJECT_OPS = 3 * (4 + 8 + 14 + 2) + 3
B4_OPS = B1_OPS  # (ray, triangle): the same core as B1
# R1 (csrc/threefry.cu): 32-bit integer operations of one Threefry-2x32 of
# 20 rounds (the key schedule's 2 xors and 2 first adds; an add, a rotate
# and an xor a round; 3 adds a key injection, 5 of them) and of turning a
# hash into a uniform (xor, shift, or, subtraction).  Peak: 64 such
# operations a clock an SM (the CUDA C++ Programming Guide's throughput
# table, compute capability 9.0) x 132 SMs x 1.98 GHz.
R1_HASH_OPS, R1_UNIFORM_OPS = 4 + 20 * 3 + 5 * 3, 4
PEAK_INT_OPS = 64 * 132 * 1.98e9
R1_REPS = 20  # R1 launches profiled for its device time a launch
# The kernels' names in a profiler trace.
KERNEL_NAMES = {"B1": "fused_intersect", "B2": "stat_filter",
                "B3": "twolevel_cull", "B4": "twolevel_walk",
                "R1": "threefry_kernel"}
SUBSET = 64  # blocks of 512 rays on which B4 meets its plain version
# The small reference render (phase 6) and the share of its pixels that
# must agree between the card and the CPU in every buffer (0.9961 at
# worst on an NVIDIA H100 80GB HBM3 at 700 W, with equal ray totals).
SMALL_W, SMALL_H, SMALL_SHARE = 32, 24, 0.98
TERRAIN_SPP, TERRAIN_MAXDEPTH = 4, 8  # bench.py's terrain line
# Samples a pixel of the feature scenes (the textured terrain, the hair +
# SSS staircase and terrain): cut from 4 to 2 to keep the whole run inside
# its time limit once the realistic, kd-tree, ao and sppm phases joined
# it.  Their rays/s stand beside the 4-spp scenes' (a path's rays/s
# hardly depends on the count); their kernels an iteration halve.
FEATURE_SPP = 2
# Samples a pixel of the kd-tree staircase and of the samplers phase's
# full-width iterations, cut from 4 to keep the whole run inside its time
# limit once the bdpt and mlt phases joined it, the kd-tree's to 1 once
# B2's other forms did.  Rays/s hardly depends on the count.
KDTREE_SPP, SAMPLER_SPP = 1, 2
# The profiler ranges whose device time _trace_sums attributes: the
# two-level intersect's stages, the texture lookups, the env-map branches,
# the hair model and the BSSRDF transport (these nest: sss.probe inside
# sss.sample_sp, twolevel.* inside both).
RANGES = ("twolevel.", "textures.", "lights.", "hair.", "sss.", "volume.",
          "fourier.")
SEED = 0  # the textured phases' images are made from it
# The textured small phase's share of pixels within rtol 1e-4 (card
# against CPU), with ray totals equal.
TEXTURED_SHARE = 0.99


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _clocks_under(fn, ms: float) -> str:
    """nvidia-smi's SM clock and power draw, read while ~2 s of `fn`
    launches (each `ms` long) keep the card busy."""
    import torch

    for _ in range(int(2000.0 / max(ms, 0.01)) + 1):
        fn()  # asynchronous: the queue now holds ~2 s of work
    time.sleep(0.5)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return out


def _median_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _once_ms(fn):
    """(result, ms) of one call, timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _other_library(tree):
    """Kernels B2 and B3 built from another tree's sources
    (`tree`/statmc_tpu_torch/csrc/stat_filter.cu and twolevel_cull.cu, with
    this tree's nvcc flags) into build/other/, loaded with ctypes.  Their
    C entry points must take this tree's arguments (cuda_build's
    _SIGNATURES), or B2's those of a tree from before its other forms
    (the f32 form's, with float factors), which a stand-in takes this
    tree's arguments for."""
    import ctypes

    from statmc_tpu_torch import cuda_build

    csrc = os.path.join(os.path.abspath(tree), "statmc_tpu_torch", "csrc")
    out = os.path.join(REPO, "build", "other")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libstatmc_other.so")
    cuda_build._build([os.path.join(csrc, n) for n in
                       ("stat_filter.cu", "twolevel_cull.cu")], so)
    lib = ctypes.CDLL(so)
    for name in ("statmc_stat_filter", "statmc_twolevel_cull"):
        fn = getattr(lib, name)
        fn.argtypes = cuda_build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    with open(os.path.join(csrc, "stat_filter.cu")) as f:
        if "int accept_bf16" in f.read():
            return lib
    # mc, d2, fm, gb, valid, gb_factors (float), H, W, C, CF, G, radius,
    # ds, normalize, out, wsum, stream
    f32_only = lib.statmc_stat_filter
    f32_only.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int]
                         + [ctypes.c_void_p] * 3)

    def stat_filter(mc, d2, fm, gb, valid, factors, H, W, C, CF, G, radius,
                    ds, normalize, accept_expand, range_bf16, accept_bf16,
                    gs, out, wsum, stream):
        if accept_expand or range_bf16 or accept_bf16:
            raise ValueError("the other tree's B2 has only the f32 form")
        gf = ctypes.cast(factors, ctypes.POINTER(ctypes.c_double))[:G]
        gf32 = (ctypes.c_float * max(G, 1))(*gf)
        return f32_only(mc, d2, fm, gb, valid,
                        ctypes.cast(gf32, ctypes.c_void_p), H, W, C, CF, G,
                        radius, ds, normalize, out, wsum, stream)

    return types.SimpleNamespace(
        statmc_stat_filter=stat_filter,
        statmc_twolevel_cull=lib.statmc_twolevel_cull)


def _ab_ms(fn, other):
    """(this tree's ms, the other tree's ms) of `fn`, a call of the kernel
    wrappers: medians in turns this, other, other, this, each pair
    averaged; the other tree's kernels stand in for this tree's by taking
    the place of the loaded library.  (None, None) without another tree."""
    if other is None:
        return None, None
    from statmc_tpu_torch import cuda_build

    own = cuda_build.library()
    times = {}
    for lib in (own, other, other, own):
        cuda_build._lib = lib
        try:
            times.setdefault(id(lib), []).append(_median_ms(fn))
        finally:
            cuda_build._lib = own
    return (statistics.mean(times[id(own)]),
            statistics.mean(times[id(other)]))


def _ab_text(ab):
    if ab[0] is None:
        return ""
    return (f"; in turns with the other tree: this {ab[0]:.3f} ms, other "
            f"{ab[1]:.3f} ms")


def _bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the two times."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def _scene_text(width, height, spp=SPP):
    from statmc_tpu_torch.testscenes import scene_text

    return scene_text(width=width, height=height, spp=spp, iterations=2,
                      maxdepth=MAXDEPTH, denoise=True, filtersd=10.0,
                      filterradius=RADIUS)


def _staircase_tris():
    from statmc_tpu_torch.driver import _morton_order_scene
    from statmc_tpu_torch.scene.api import parse_scene
    from statmc_tpu_torch.scene.build import build_scene

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "staircase-proxy.pbrt")
        with open(path, "w") as f:
            f.write(_scene_text(WIDTH, HEIGHT))
        s = _morton_order_scene(build_scene(parse_scene(path)))
    return s.tri_p0, s.tri_e1, s.tri_e2


def _rays(rng, lo, hi):
    """2^20 rays inside [lo, hi]: a third unbounded (t_max = INF, the
    integrator's no-limit value), a third finite, a third dead (0)."""
    import numpy as np

    o = (lo + rng.random((N_RAYS, 3)) * (hi - lo)).astype(np.float32)
    d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kind = np.arange(N_RAYS) % 3
    t_max = np.where(kind == 0, 1e30, np.where(
        kind == 1, rng.uniform(0.5, 20.0, N_RAYS), 0.0)).astype(np.float32)
    return o, d, t_max


def _grazing_rays(rng, lo, hi):
    """_rays' t_max mix on 2^20 rays that skim the terrain floor: origins
    over the scene box at heights 0-0.2 (the heightfield spans 0-0.15),
    nearly horizontal directions.  Each crosses many subgroup boxes of the
    floor, so many 512-ray blocks vote for more than MAXS subtiles and
    walk densely."""
    import numpy as np

    o, d, t_max = _rays(rng, lo, hi)
    o[:, 1] = rng.random(N_RAYS) * 0.2
    d *= np.array([1.0, 0.02, 1.0], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, t_max


def phase_b1(rng, card):
    """Kernel B1 against its plain version on two tables."""
    import numpy as np
    import torch

    from statmc_tpu_torch.accel import fused as F

    p0, e1, e2 = _staircase_tris()
    tables = {"staircase": (p0, e1, e2)}
    n = F.FUSED_MAX_TRIS
    tables["random16k"] = (
        (rng.uniform(-8, 8, (n, 3))).astype(np.float32),
        rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
        rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32))
    out = {}
    for name, (a, b, c) in tables.items():
        ft = F.FusedTris.from_tris(a, b, c).to_device("cuda")
        lo = (a.min(0) - 1.0).astype(np.float32)
        hi = (a.max(0) + 1.0).astype(np.float32)
        o, d, t_max = (torch.as_tensor(x, device="cuda")
                       for x in _rays(rng, lo, hi))
        raye, rayp = (x.contiguous() for x in F.ray_features(o, d))
        args = (ft.edge_table, ft.plane_table, raye, rayp, t_max, ft.packed,
                ft.n_tris)
        t_k, id_k = F.intersect_tiles(*args)
        (t_p, id_p), plain_ms = _once_ms(lambda: F.intersect_plain(*args[:5]))
        bits_k, bits_p = t_k.view(torch.int32), t_p.view(torch.int32)
        if not (torch.equal(id_k, id_p) and torch.equal(bits_k, bits_p)):
            raise AssertionError(
                f"B1 {name}: ids differ on {int((id_k != id_p).sum())} rays,"
                f" t bits on {int((bits_k != bits_p).sum())}")
        err = float((t_k - t_p).abs().max())
        ms = _median_ms(lambda: F.intersect_tiles(*args))
        hits = int((id_k >= 0).sum())
        # Work these rays need: every live ray against every triangle.
        live = int((t_max > 0).sum())
        nbytes = _nbytes(raye, rayp, t_max, ft.packed, t_k, id_k)
        bound_ms, bound_by = _bound(live * ft.n_tris * B1_OPS, nbytes)
        eager_ms, _ = _bound(live * ft.n_tris * EAGER_OPS, nbytes)
        print(f"B1 {name}: {ft.n_tris} tris, {N_RAYS} rays ({live} live), "
              f"{hits} hits, (t, id) bit-identical; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms (once), bound {bound_ms:.3f} ms "
              f"({bound_by}; {bound_ms / ms:.3f} of the kernel's time; "
              f"{eager_ms:.3f} ms, {eager_ms / ms:.3f}, at {EAGER_OPS} "
              f"operations a pair) [{card}]", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain_ms, err=err,
                         bound_ms=bound_ms, bound_by=bound_by)
    # The bound's 67 TFLOP/s assumes the card's boost clock (1,980 MHz).
    print(f"B1 {name}: SM clock and power under ~2 s of launches: "
          f"{_clocks_under(lambda: F.intersect_tiles(*args), ms)} [{card}]",
          flush=True)
    return out


def _filter_inputs(rng):
    import numpy as np
    import torch

    H, W, C, G, N = HEIGHT, WIDTH, 3, 6, 16
    xs = rng.gamma(4.0, 0.25, size=(H, W, C)).astype(np.float32)
    mc = 2.0 * (np.sqrt(xs) - 1.0)
    d2 = (rng.gamma(2.0, 0.01, size=(H, W, C)) / N).astype(np.float32)
    gb = rng.random((H, W, G)).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device="cuda")

    return (t(mc), t(d2), t(xs), t(gb),
            torch.ones((H, W), device="cuda"))


def phase_b2(rng, card, other):
    """Kernel B2 against its plain version at the production shape, in
    each of its forms."""
    mc, d2, fm, gb, valid = _filter_inputs(rng)
    gf = (-0.5 / 0.02 ** 2,) * 3 + (-0.5 / 0.1 ** 2,) * 3
    ds = -0.5 / 10.0 ** 2
    return _b2_all_forms("B2", card, other, (mc, d2, fm, gb, valid, RADIUS,
                                             ds, gf), min_wsum=1.0 - 1e-5)


def _b2_forms_tested():
    """B2's forms other than the default f32 one (filter_cuda.FORMS)."""
    from statmc_tpu_torch.denoise import filter_cuda as FC

    return list(FC.FORMS)[1:]


def _b2_check(name, card, other, args, min_wsum=None, form="f32",
              f32_out=None, full_plain=True, hold=None, pairs_of=None):
    """B2 in `form` (a key of filter_cuda.FORMS) against its plain version
    on `args` (run_filter's arguments without normalize), normalized and
    not: max |dout|, times, the in-image pairs and the share this form
    accepts, and the bound at that share.  The f32 form's plain version
    runs on the whole image; another form's on a B2_CROP crop of it with
    a halo of r (whose centre must equal the whole image's kernel output
    bit for bit), and, when full_plain, once more on the whole image,
    normalized, for its time.  Another form's normalized output is also
    held against f32_out, the f32 kernel's: its relative error (mean, max)
    and the shift of the image's mean, the mean held below `hold` when
    given.  pairs_of caches _filter_pairs by acceptance test.  Returns
    {normalize: results}, the f32 form's normalized output under "out"."""
    import torch

    from statmc_tpu_torch.denoise import filter_cuda as FC

    kw = FC.FORMS[form]
    mc, d2 = args[0], args[1]
    H, W, _ = mc.shape
    r = args[5]
    bf16 = bool(kw.get("range_bf16")) and args[3].shape[2] > 0
    test = ("bf16" if kw.get("accept_bf16") else
            "expand" if kw.get("accept_expand") else "f32")
    pairs_of = {} if pairs_of is None else pairs_of
    if test not in pairs_of:
        pairs_of[test] = _filter_pairs(mc, d2, r, **{
            k: v for k, v in kw.items() if k != "range_bf16"})
    pairs, accepted = pairs_of[test]
    ops = (pairs * B2_TEST_OPS[test]
           + accepted * B2_WEIGHT_OPS["bf16" if bf16 else "f32"])
    held, where = args, ""
    if form != "f32":
        (ch, cw), (y0, x0) = B2_CROP, ((H - B2_CROP[0]) // 2,
                                       (W - B2_CROP[1]) // 2)
        assert min(y0, x0) >= r, "the crop's halo must lie in the image"
        held = tuple(x[y0 - r:y0 + ch + r, x0 - r:x0 + cw + r].contiguous()
                     for x in args[:5]) + tuple(args[5:])
        where = (f" on a {cw}x{ch} crop with its halo, its centre equal to "
                 "the whole image's bit for bit")
    out = {}
    for normalize in (True, False):
        o_full, w_full = FC.run_filter(*args, normalize, **kw)
        o_k, w_k = (o_full, w_full) if form == "f32" else FC.run_filter(
            *held, normalize, **kw)
        (o_p, w_p), plain_ms = _once_ms(
            lambda: FC.run_filter_plain(*held, normalize, **kw))
        # The kernel sums the window in the plain version's order with the
        # same rounding per step; expf and the library exp may still
        # differ in the last bit, hence rtol 1e-4 / atol 1e-6; in the bf16
        # range forms that moves a weight by a bf16 ulp (2^-8 relative,
        # 2^-7 on the normalized output).
        rtol = (2.0 ** -7 if normalize else 2.0 ** -8) if bf16 else 1e-4
        torch.testing.assert_close(o_k, o_p, rtol=rtol, atol=1e-6)
        torch.testing.assert_close(w_k, w_p, atol=1e-6,
                                   rtol=2.0 ** -8 if bf16 else 1e-4)
        if form != "f32":
            c = (slice(y0, y0 + ch), slice(x0, x0 + cw))
            k = (slice(r, r + ch), slice(r, r + cw))
            if not (torch.equal(o_k[k], o_full[c])
                    and torch.equal(w_k[k], w_full[c])):
                raise AssertionError(f"{name}: the crop's centre differs "
                                     "from the whole image's output")
        if min_wsum is not None and float(w_full.min()) < min_wsum:
            raise AssertionError(f"{name}: min wsum {float(w_full.min())}")
        err = float((o_k - o_p).abs().max())
        ms = _median_ms(lambda: FC.run_filter(*args, normalize, **kw))
        ab = (_ab_ms(lambda: FC.run_filter(*args, normalize), other)
              if form == "f32" else (None, None))
        bound_ms, bound_by = _bound(ops, _nbytes(*args[:5], o_full, w_full))
        res = dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound_ms,
                   bound_by=bound_by, accepted=accepted / pairs, ab=ab)
        extra = ""
        if form != "f32":
            res["plain_crop_ms"] = plain_ms
            res["plain_ms"] = None
            if full_plain and normalize:
                _, res["plain_ms"] = _once_ms(
                    lambda: FC.run_filter_plain(*args, normalize, **kw))
            extra = (f", plain on the whole image {res['plain_ms']:.3f} ms "
                     "(once)" if res["plain_ms"] is not None else "")
        if form == "f32" and normalize:
            res["out"] = o_full
        if form != "f32" and normalize and f32_out is not None:
            rel = (o_full - f32_out).abs() / (f32_out.abs() + 1e-6)
            res.update(rel_mean=float(rel.mean()), rel_max=float(rel.max()),
                       mean_shift=float(o_full.mean() / f32_out.mean() - 1))
            extra += (f"; against the f32 kernel: relative error mean "
                      f"{res['rel_mean']:.3e}, max {res['rel_max']:.3e}, "
                      f"the image's mean moved {res['mean_shift']:+.3e}")
            if not torch.isfinite(o_full).all() or (
                    hold is not None and res["rel_mean"] >= hold):
                raise AssertionError(f"{name}: not finite, or mean relative "
                                     f"error {res['rel_mean']} >= {hold}")
        print(f"{name} normalize={normalize}: {W}x{H} C={mc.shape[2]} "
              f"CF={args[2].shape[2]} G={args[3].shape[2]} r={r}, max "
              f"|dout| {err:.3e}{where}, min wsum "
              f"{float(w_full.min()):.6f}; "
              f"{pairs} in-image pairs, {accepted / pairs:.4f} accepted; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (once"
              f"{', crop' if where else ''}){extra}, bound "
              f"{bound_ms:.3f} ms ({bound_by}; {bound_ms / ms:.3f} of the "
              f"kernel's time){_ab_text(ab)} [{card}]", flush=True)
        out[normalize] = res
    return out


def _b2_all_forms(name, card, other, args, min_wsum=None, full_plain=True,
                  hold=None):
    """_b2_check of every form on `args`: {form: {normalize: results}}."""
    pairs_of = {}
    res = {"f32": _b2_check(name, card, other, args, min_wsum=min_wsum,
                            pairs_of=pairs_of)}
    f32_out = res["f32"][True].pop("out")
    for form in _b2_forms_tested():
        res[form] = _b2_check(f"{name} {form}", card, None, args,
                              min_wsum=None if min_wsum is None
                              else 1.0 - 2.0 ** -8, form=form,
                              f32_out=f32_out, full_plain=full_plain,
                              hold=hold, pairs_of=pairs_of)
    return res


def _filter_pairs(mc, d2, radius, accept_expand=False, accept_bf16=False):
    """(in-image (pixel, neighbour) pairs, accepted ones) of the window of
    `radius`: the acceptance test (in the form the flags name) decides
    which pairs take the weight and its exponential."""
    from statmc_tpu_torch.denoise.filter_cuda import acceptance

    H, W, _ = mc.shape
    pairs = accepted = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            ys, yj = slice(max(0, -dy), H - max(0, dy)), slice(
                max(0, dy), H - max(0, -dy))
            xs, xj = slice(max(0, -dx), W - max(0, dx)), slice(
                max(0, dx), W - max(0, -dx))
            ok = acceptance(mc[ys, xs], d2[ys, xs], accept_expand,
                            accept_bf16)(mc[yj, xj], d2[yj, xj])
            pairs += ok.numel()
            accepted += int(ok.sum())
    return pairs, accepted


def _profile(fn, host: bool = True):
    """fn() under torch.profiler: (what it returns, the sums of
    `_trace_sums`, seconds spent reading the trace).  host=False records
    the device only: the kernels' times by name, without the host's ops,
    ranges and launches, at a fraction of the profiler's cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if host else [ProfilerActivity.CUDA]) as prof:
        log = fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups, launches, stages = _trace_sums(prof)
    return log, groups, launches, stages, time.perf_counter() - t0


def phase_main_path(card):
    """load(scene).render(iterations=2) on the card, launch counts
    read around it: B2's by form too, every one of them the default f32
    form's.  Returns the launch counts, the renderer (the profile phase
    runs its iteration 2 again), iteration 2's render_s and rays, the
    denoise's run_filter calls and B2's launches by form."""
    import numpy as np
    import torch
    from statmc_tpu_torch import spans

    from statmc_tpu_torch.denoise import filter_cuda as FC
    from statmc_tpu_torch.driver import load

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "staircase-proxy.pbrt")
        with open(path, "w") as f:
            f.write(_scene_text(WIDTH, HEIGHT))
        t0 = time.perf_counter()
        r = load(path, device="cuda")
        setup_s = time.perf_counter() - t0
        r.progress = False
        spans.reset("kernel.")
        logs = r.render(iterations=2, verbose=False)
        torch.cuda.synchronize()
        launches = {"B1": spans.counted("kernel.B1"),
                    "B2": spans.counted("kernel.B2"),
                    "R1": spans.counted("kernel.R1")}
        forms = FC.form_launches()
        filter_calls = _capture_filter_inputs(r)
        film = r.film_mean.cpu().numpy()
        film_f = r.film_f.cpu().numpy()
    for name, img in (("film", film), ("film-f", film_f)):
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError(f"{name}: not finite with mean > 0")
    if min(launches.values()) <= 0 or forms["f32"] != launches["B2"]:
        raise AssertionError(f"main path launch counts {launches}, B2's "
                             f"by form {forms}")
    prev = 0.0
    for log in logs:  # rays_total accumulates over iterations
        rays = log["rays_total"] - prev
        prev = log["rays_total"]
        print(f"main path iteration {log['iteration']}: {log['spp']} spp "
              f"total, {rays:.0f} rays in {log['render_s']:.3f} s = "
              f"{rays / log['render_s']:.1f} rays/s, denoise "
              f"{log['denoise_s'] * 1e3:.1f} ms [{card}]", flush=True)
    print(f"main path: {WIDTH}x{HEIGHT} spp {SPP} maxdepth {MAXDEPTH} "
          f"radius {RADIUS}, setup {setup_s:.1f} s, film mean "
          f"{film.mean():.5f}, film-f mean {film_f.mean():.5f}, launches "
          f"{launches}, B2's by form {forms}", flush=True)
    return launches, r, logs[-1]["render_s"], rays, filter_calls, forms


def _capture_filter_inputs(r):
    """The arguments that iteration 2's denoise passes to run_filter
    (denoise/filter.py), one tuple per call: r._denoise() once more on
    the moment states and film it filtered, with the module's run_filter
    wrapped to record them."""
    from statmc_tpu_torch.denoise import filter as FL

    calls, real = [], FL.run_filter

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    FL.run_filter = record
    try:
        r._denoise()
    finally:
        FL.run_filter = real
    return calls


def phase_b2_render(card, other, calls):
    """Kernel B2 against its plain version on the inputs of the staircase
    render's iteration-2 denoise (each call of it), in each of its forms:
    another form's output within a mean relative error of 2e-3 of the f32
    form's."""
    out = None
    for k, args in enumerate(calls):
        res = _b2_all_forms(f"B2 render inputs, call {k + 1} of "
                            f"{len(calls)}", card, other, tuple(args[:8]),
                            full_plain=False, hold=2e-3)
        out = out or res
    if out is None:
        raise AssertionError("B2 render inputs: the denoise made no call")
    return out


def phase_b2_range_bf16_render(card, r):
    """The staircase's iteration-2 denoise once more through
    Renderer(setup, denoiser=StatDenoiser(..., range_bf16=True)) on the
    main path's moment states and film: B2's launch counts, by form too,
    set to 0 just before and read just after (the range_bf16 form must
    launch, and no other); the film-f finite, not equal to the f32
    denoise's film-f, its relative error against it (mean, held below
    2e-3, and max) and the shift of its mean; the pass's seconds (host
    clock around a synchronize).  Returns (B2's launches by form,
    results)."""
    import torch
    from statmc_tpu_torch import spans

    from statmc_tpu_torch.denoise import filter_cuda as FC
    from statmc_tpu_torch.denoise.filter import StatDenoiser
    from statmc_tpu_torch.driver import Renderer

    s = r.s
    r16 = Renderer(s, denoiser=StatDenoiser(s.ecfg, s.width, s.height,
                                            range_bf16=True,
                                            device=s.device))
    r16.states, r16.film_sum, r16.film_w = r.states, r.film_sum, r.film_w
    spans.reset("kernel.")
    t0 = time.perf_counter()
    r16._denoise()
    torch.cuda.synchronize()
    denoise_s = time.perf_counter() - t0
    launches = spans.counted("kernel.B2")
    forms = FC.form_launches()
    f16, f32 = r16.film_f, r.film_f
    rel = (f16 - f32).abs() / (f32.abs() + 1e-6)
    res = dict(rel_mean=float(rel.mean()), rel_max=float(rel.max()),
               mean_shift=float(f16.mean() / f32.mean() - 1),
               denoise_s=denoise_s)
    print(f"B2 range_bf16 render: Renderer(denoiser=StatDenoiser("
          f"range_bf16=True)) on iteration 2's states, {WIDTH}x{HEIGHT} r="
          f"{RADIUS}: B2 launches {launches} ({forms}), film-f against the "
          f"f32 "
          f"denoise's: relative error mean {res['rel_mean']:.3e}, max "
          f"{res['rel_max']:.3e}, mean moved {res['mean_shift']:+.3e}; "
          f"denoise {denoise_s * 1e3:.1f} ms [{card}]", flush=True)
    if (forms["range_bf16"] <= 0 or launches != forms["range_bf16"]
            or not torch.isfinite(f16).all() or torch.equal(f16, f32)
            or res["rel_mean"] >= 2e-3):
        raise AssertionError(f"B2 range_bf16 render: launches {launches}, "
                             f"by form {forms}, film-f equal to the f32 "
                             f"one: {torch.equal(f16, f32)}, {res}")
    return forms, res


def _profile_denoise(r, tries: int = 3):
    """{kernel: [device ms, kernels]} of r's denoise pass under
    torch.profiler (device only), profiled again, up to `tries` times,
    while its trace lacks B2: a profile started just after an
    iteration's has been seen to keep 8 of the pass's 67 kernels (on an
    NVIDIA H100 80GB HBM3)."""
    for k in range(tries):
        _, den, _, _, _ = _profile(r._denoise, host=False)
        if den["B2"][1] > 0:
            break
        print(f"denoise profile {k + 1}: no B2 among its "
              f"{sum(n for _, n in den.values())} kernels; profiled again",
              flush=True)
    return den


def phase_staircase_profile(card, r, render_s):
    """The staircase main path's iteration 2 once more under
    torch.profiler (device activity only): B1's device time per
    iteration and the device's busy share of the unprofiled iteration
    (render_s); then that iteration's denoise pass once more, profiled on
    its own, for B2's device time (the trace of the ~270,000 kernels of
    an iteration has been seen to lose its last ~200 records, B2's among
    them).  Returns ({kernel: device ms per iteration}, the iteration's
    {kernels, device_ms, busy})."""
    log, groups, _, _, read_s = _profile(lambda: r.run_iteration(2),
                                         host=False)
    den = _profile_denoise(r)
    total = sum(ms for ms, _ in groups.values())
    print(f"staircase profile: iteration 2 again, {log['render_s']:.3f} s "
          f"render + {log['denoise_s'] * 1e3:.1f} ms denoise profiled, "
          f"trace read in {read_s:.1f} s; device time {total:.1f} ms in "
          f"{sum(n for _, n in groups.values())} kernels, busy "
          f"{total / 1e3 / render_s:.3f} of the unprofiled "
          f"{render_s:.3f} s; "
          + ", ".join(f"{g} {ms:.1f} ms ({n})"
                      for g, (ms, n) in groups.items() if n)
          + "; the denoise pass alone: " + ", ".join(
              f"{g} {ms:.1f} ms ({n})" for g, (ms, n) in den.items() if n)
          + f" [{card}]", flush=True)
    if groups["B1"][1] <= 0 or den["B2"][1] <= 0:
        raise AssertionError("staircase profile: B1 not in the iteration's"
                             " trace or B2 not in the denoise pass's")
    whole = {"kernels": sum(n for _, n in groups.values()),
             "device_ms": total, "busy": total / 1e3 / render_s}
    return ({"B1": groups["B1"][0], "B2": den["B2"][0],
             "R1": groups["R1"][0]}, whole)


def phase_small_reference(card, name, text, share=SMALL_SHARE,
                          max_drift=1e-3, kernels=()):
    """A small scene rendered on the card and on the CPU (the kernels'
    plain versions): equal sample counts, and buffers that agree up to
    the paths that an ulp sends elsewhere (tests/test_torch_slice.py
    explains why such paths exist between any two implementations).
    text: the scene, or a function of the scene's directory that writes
    its assets there and returns it.  kernels: the kernels (of B1-B4)
    that the card's render must launch, counted around it."""
    import numpy as np

    from statmc_tpu_torch.driver import load

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}-small.pbrt")
        with open(path, "w") as f:
            f.write(text(tmp) if callable(text) else text)
        bufs, rays = {}, {}
        for dev in ("cuda", "cpu"):
            r = load(path, device=dev)
            r.progress = False
            if dev == "cuda":
                _zero_counts()
            rays[dev] = r.render(verbose=False)[-1]["rays_total"]
            if dev == "cuda":
                launches = _read_counts()
            bufs[dev] = r.buffers()
    gpu, cpu = bufs["cuda"], bufs["cpu"]
    if gpu.keys() != cpu.keys():
        raise AssertionError(f"buffer names differ: {sorted(gpu)} vs "
                             f"{sorted(cpu)}")
    shares, bad = {}, []
    for k in sorted(cpu):
        a, b = cpu[k], gpu[k]
        if k.endswith("-n"):
            if not np.array_equal(a, b):
                raise AssertionError(f"{k}: sample counts differ")
            continue
        if not np.isfinite(b).all():
            raise AssertionError(f"{k}: not finite on the card")
        close = np.isclose(b, a, rtol=1e-4, atol=1e-6)
        shares[k] = float((close.all(-1) if close.ndim == 3
                           else close).mean())
        scale = float(np.abs(a).mean()) + 1e-12
        if (shares[k] < share
                or abs(b.mean() - a.mean()) > 1e-3 * scale):
            bad.append(f"{k}: {shares[k]:.4f} of pixels within rtol 1e-4, "
                       f"means {a.mean()} (cpu) vs {b.mean()} (card)")
    if bad:
        raise AssertionError("; ".join(bad) + "; every buffer's share: "
                             + ", ".join(f"{k} {v:.4f}"
                                         for k, v in shares.items()))
    drift = abs(rays["cuda"] - rays["cpu"]) / rays["cpu"]
    if drift > max_drift:
        raise AssertionError(f"rays_total {rays['cuda']} (card) vs "
                             f"{rays['cpu']} (cpu)")
    if any(launches[k] <= 0 for k in kernels):
        raise AssertionError(f"small {name}: launches {launches}")
    worst = min(shares, key=shares.get)
    print(f"small {name}: {SMALL_W}x{SMALL_H} card vs cpu, {len(cpu)} "
          f"buffers (shares: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                           shares.items())
          + f"), worst {worst} {shares[worst]:.4f} of pixels within "
          f"rtol 1e-4, rays_total {rays['cuda']:.0f} vs {rays['cpu']:.0f}, "
          f"card launches {launches} [{card}]", flush=True)


def scene_small():
    from statmc_tpu_torch.testscenes import scene_text

    return scene_text(width=SMALL_W, height=SMALL_H, spp=2, iterations=2,
                      maxdepth=4, denoise=True, filterradius=2)


def terrain_small():
    """19,554 triangles (n = 96): past FUSED_MAX_TRIS, so two-level."""
    from statmc_tpu_torch.testscenes import terrain_scene_text

    return terrain_scene_text(width=SMALL_W, height=SMALL_H, spp=2,
                              iterations=2, maxdepth=4, n=96, denoise=True)


def textured_small(tmp):
    """The textured staircase at 32x24: every texture kind, an
    environment map and a goniometric light, its images written into
    tmp (fused path, B1 and B2)."""
    from statmc_tpu_torch.testscenes import textured_scene_text

    return textured_scene_text(tmp, width=SMALL_W, height=SMALL_H, spp=2,
                               iterations=2, maxdepth=4, seed=SEED)


def _zero_counts():
    from statmc_tpu_torch.__main__ import launches

    launches(reset=True)


def _read_counts():
    from statmc_tpu_torch.__main__ import launches

    return launches()


def _albedo_detail(bufs):
    """How much the albedo G-buffer (t2) varies inside surfaces: the mean
    |difference| between neighbouring pixels that both hit something (a
    non-zero first-hit normal, t1), and the share of such pixels.  Both
    renders have the same geometry, so the textures' edges and noise add
    to it and the objects' outlines do not."""
    import numpy as np

    a, hit = bufs["t2-b0-mean"], np.abs(bufs["t1-b0-mean"]).sum(-1) > 0
    dx = np.abs(a[:, 1:] - a[:, :-1]).sum(-1)[hit[:, 1:] & hit[:, :-1]]
    dy = np.abs(a[1:] - a[:-1]).sum(-1)[hit[1:] & hit[:-1]]
    return float(np.concatenate([dx, dy]).mean()), float(hit.mean())


def phase_textured_terrain(card, plain, plain_s):
    """The terrain with textures of every kind, an environment map and a
    projection light (testscenes.textured_terrain_text: a 2048x2048
    imagemap floor at uscale = vscale = 8, a 2048x1024 EXR sky, a 512x512
    light image, all made from SEED and written by the port's own
    writers), 1280x720, 4 spp, maxdepth 8, denoised:
    ``load(scene).render(iterations=1)`` with every kernel's launch count
    set to 0 just before it and read just after.  plain: the untextured
    terrain's renderer, plain_s its iteration's render_s.  Returns (the
    renderer, launches, render_s)."""
    import numpy as np
    import torch

    from statmc_tpu_torch.accel import twolevel as TT
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.testscenes import textured_terrain_text

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        text = textured_terrain_text(
            tmp, width=WIDTH, height=HEIGHT, spp=FEATURE_SPP, iterations=1,
            maxdepth=TERRAIN_MAXDEPTH, denoise=True, seed=SEED)
        path = os.path.join(tmp, "textured-terrain.pbrt")
        with open(path, "w") as f:
            f.write(text)
        assets_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = load(path, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    if not isinstance(r.s.bvh, TT.TwoLevelTris):
        raise AssertionError(f"textured terrain: {type(r.s.bvh).__name__}")
    sc = r.s.scene
    if not (sc.has_textures and sc.env_light_id >= 0 and sc.has_image_lights):
        raise AssertionError("textured terrain: textures, environment map "
                             "or image light missing")
    r.progress = False
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_counts()
    log = r.render(iterations=1, verbose=False)[-1]
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() - held
    bufs = r.buffers()
    for name in ("film", "film-f"):
        img = bufs[name]
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError(f"textured terrain {name}: not finite with "
                                 "mean > 0")
    if min(launches[k] for k in ("B2", "B3", "B4")) <= 0:
        raise AssertionError(f"textured terrain launch counts {launches}")
    det_t, hit_t = _albedo_detail(bufs)
    det_p, hit_p = _albedo_detail(plain.buffers())
    if not det_t > det_p:
        raise AssertionError(f"textured terrain: albedo detail {det_t} not "
                             f"above the untextured terrain's {det_p}")
    tex = sc.textures
    atlas_mb = tex.atlas.numel() * 4 / 1e6
    env_mb = sc.env_map.numel() * 4 / 1e6
    cdf_mb = (sc.env_cond_cdf.numel() + sc.env_pdf_uv.numel()) * 4 / 1e6
    rays = log["rays_total"]
    print(f"textured terrain: {r.s.bvh.n_tris} tris, kinds "
          f"{list(tex.kinds_static)}, atlas {atlas_mb:.1f} MB, env map "
          f"{env_mb:.1f} MB, CDF + pdf {cdf_mb:.1f} MB; assets written in "
          f"{assets_s:.1f} s, setup {setup_s:.1f} s; {WIDTH}x{HEIGHT} spp "
          f"{FEATURE_SPP} maxdepth {TERRAIN_MAXDEPTH}: {rays:.0f} rays in "
          f"{log['render_s']:.3f} s = {rays / log['render_s']:.1f} rays/s "
          f"(untextured terrain in this run: {plain_s:.3f} s), denoise "
          f"{log['denoise_s'] * 1e3:.1f} ms, peak memory {peak / 2**30:.2f} "
          f"GiB; film mean {bufs['film'].mean():.5f}; albedo detail "
          f"{det_t:.5f} over {hit_t:.3f} of pixels against {det_p:.5f} over "
          f"{hit_p:.3f} untextured; launches {launches} [{card}]",
          flush=True)
    return r, launches, log["render_s"]


def phase_textured_profile(card, r, render_s, plain):
    """The textured terrain's iteration once more under torch.profiler:
    kernels and device time against the untextured terrain's (plain:
    {kernels, device_ms, busy} from its profile), the device's busy share
    of the unprofiled iteration (render_s), and the device ms inside the
    ``textures.sample_texture`` and ``lights.env_map`` ranges.  Returns
    {kernel: device ms in the iteration}."""
    log, groups, launches, stages, read_s = _profile(
        lambda: r.run_iteration(1))
    total = sum(ms for ms, _ in groups.values())
    kernels = sum(n for _, n in groups.values())
    tex = stages.get("textures.sample_texture", [0, 0.0, 0.0])
    env = stages.get("lights.env_map", [0, 0.0, 0.0])
    print(f"textured profile: iteration 1 again, {log['render_s']:.3f} s "
          f"profiled, trace read in {read_s:.1f} s; device time "
          f"{total:.1f} ms in {kernels} kernels ({launches} launched "
          f"through the runtime), busy {total / 1e3 / render_s:.3f} of the "
          f"unprofiled {render_s:.3f} s (untextured terrain: "
          f"{plain['device_ms']:.1f} ms in {plain['kernels']} kernels, busy "
          f"{plain['busy']:.3f}); sample_texture {tex[0]} calls, "
          f"{tex[2]:.1f} ms device ({tex[2] / max(total, 1e-9):.3f}) / "
          f"{tex[1]:.1f} ms host; env map {env[0]} calls, {env[2]:.1f} ms "
          f"device ({env[2] / max(total, 1e-9):.3f}) / {env[1]:.1f} ms "
          "host; "
          + ", ".join(f"{g} {ms:.1f} ms ({n})"
                      for g, (ms, n) in groups.items() if n)
          + f" [{card}]", flush=True)
    if tex[0] <= 0 or env[0] <= 0 or tex[2] <= 0 or env[2] <= 0:
        raise AssertionError("textured profile: no sample_texture or env-map"
                             " range with device time in the trace")
    return {k: groups[k][0] for k in ("B2", "B3", "B4")}


def _terrain_renderer():
    """(load(terrain) on the card at bench.py's terrain settings, the
    seconds it took)."""
    import torch

    from statmc_tpu_torch.accel import twolevel as TT
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.testscenes import terrain_scene_text

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "terrain-proxy.pbrt")
        with open(path, "w") as f:
            f.write(terrain_scene_text(
                width=WIDTH, height=HEIGHT, spp=TERRAIN_SPP, iterations=1,
                maxdepth=TERRAIN_MAXDEPTH))
        t0 = time.perf_counter()
        r = load(path, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    if not isinstance(r.s.bvh, TT.TwoLevelTris):
        raise AssertionError(f"terrain: accelerator {type(r.s.bvh).__name__}")
    r.progress = False
    return r, setup_s


def phase_terrain_main_path(card):
    """load(terrain).render(iterations=1) on the card; B3's and B4's
    launch counts read around it.  Returns the renderer (its setup feeds
    the B3/B4 phase)."""
    import numpy as np
    import torch
    from statmc_tpu_torch import spans


    held = torch.cuda.memory_allocated()  # the staircase renderer's
    r, setup_s = _terrain_renderer()
    torch.cuda.reset_peak_memory_stats()
    spans.reset("kernel.")
    log = r.render(iterations=1, verbose=False)[-1]
    torch.cuda.synchronize()
    launches = {"B3": spans.counted("kernel.B3"),
                "B4": spans.counted("kernel.B4")}
    peak = torch.cuda.max_memory_allocated() - held
    film = r.film_mean.cpu().numpy()
    if not (np.isfinite(film).all() and film.mean() > 0):
        raise AssertionError("terrain film: not finite with mean > 0")
    if min(launches.values()) <= 0:
        raise AssertionError(f"terrain main path launch counts {launches}")
    rays = log["rays_total"]
    print(f"terrain main path: {r.s.bvh.n_tris} tris ({r.s.bvh.n_sub} "
          f"subtiles, fsub {r.s.bvh.fsub}), {WIDTH}x{HEIGHT} spp "
          f"{TERRAIN_SPP} maxdepth {TERRAIN_MAXDEPTH}, setup {setup_s:.1f} s, "
          f"{rays:.0f} rays in {log['render_s']:.3f} s = "
          f"{rays / log['render_s']:.1f} rays/s, peak memory "
          f"{peak / 2**30:.2f} GiB, film mean {film.mean():.5f}, launches "
          f"{launches} [{card}]", flush=True)
    return r, launches, log["render_s"], rays


def _trace_sums(prof):
    """Sums over a finished torch.profiler run, read from its raw events
    (the profiler's own event tree takes minutes to build for the ~10^6
    events of an iteration): {B1, B2, B3, B4, other: [device ms,
    kernels]}, the kernels launched through the CUDA runtime, and per
    ``twolevel.*``
    range name [calls, host ms, device ms of the kernels that the ops
    inside it launched]."""
    import bisect

    import torch

    cuda = torch.autograd.DeviceType.CUDA
    groups = {k: [0.0, 0] for k in (*KERNEL_NAMES, "other")}
    by_op, ops, ranges, launches = {}, [], [], 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue  # the device-side span of a range, not a kernel
            ms = e.duration_ns() / 1e6
            g = groups[next((k for k, v in KERNEL_NAMES.items()
                             if v in name), "other")]
            g[0] += ms
            g[1] += 1
            op = e.linked_correlation_id()  # the CPU op that launched it
            if op > 0:
                by_op[op] = by_op.get(op, 0.0) + ms
        elif name in ("cudaLaunchKernel", "cuLaunchKernel",
                      "cudaLaunchKernelExC"):
            launches += 1
        elif e.linked_correlation_id() == 0:  # a CPU op or a range
            ops.append((e.start_ns(), e.correlation_id()))
            if name.startswith(RANGES):
                ranges.append((e.start_ns(), e.end_ns(), name))
    stages, spans = {}, {}
    for a, b, name in sorted(ranges):
        st = stages.setdefault(name, [0, 0.0, 0.0])
        st[0] += 1
        st[1] += (b - a) / 1e6
        spans.setdefault(name, []).append((a, b))
    starts = {name: [a for a, _ in sp] for name, sp in spans.items()}
    for t, op in ops:  # ranges of one name do not overlap: bisect per name
        ms = by_op.pop(op, None) if op > 0 else None
        if ms is None:
            continue
        for name, sp in spans.items():
            k = bisect.bisect_right(starts[name], t) - 1
            if k >= 0 and t <= sp[k][1]:
                stages[name][2] += ms
    return groups, launches, stages


def phase_terrain_profile(card, r, render_s):
    """The terrain main path's iteration once more under torch.profiler:
    device time by kernel (B3, B4, the rest) and by stage of
    intersect_twolevel (its ``twolevel.*`` ranges, summed over the
    iteration's calls), and the device's busy share of the unprofiled
    iteration (render_s).  Returns ({kernel: device ms per iteration},
    the rays of each of the iteration's B3 calls, recorded by wrapping
    accel/twolevel.py's slab_rays, which makes them, and the iteration's
    {kernels, device_ms, busy})."""
    from statmc_tpu_torch.accel import twolevel as TT

    cull_rays, real = [], TT.slab_rays

    def record(o, d, t_max):
        cull_rays.append(real(o, d, t_max))
        return cull_rays[-1]

    TT.slab_rays = record
    try:
        log, groups, launches, stages, read_s = _profile(
            lambda: r.run_iteration(1))
    finally:
        TT.slab_rays = real
    total = sum(ms for ms, _ in groups.values())
    print(f"terrain profile: iteration 1 again, {log['render_s']:.3f} s "
          f"profiled, trace read in {read_s:.1f} s; "
          f"device time {total:.1f} ms in "
          f"{sum(n for _, n in groups.values())} kernels ({launches} "
          f"launched through the runtime), busy {total / 1e3 / render_s:.3f}"
          f" of the unprofiled {render_s:.3f} s; "
          + ", ".join(f"{g} {ms:.1f} ms ({n})"
                      for g, (ms, n) in groups.items() if n)
          + f" [{card}]", flush=True)
    # B3 and B4 launch through the kernel library's statically linked
    # CUDA runtime, whose launches the profiler may not link to the
    # enclosing range; the cull and walk ranges launch no other kernel,
    # so each takes at least its kernel's time.
    own = {"twolevel.cull": groups["B3"][0], "twolevel.walk": groups["B4"][0]}
    dev = {k: max(v[2], own.get(k, 0.0)) for k, v in stages.items()}
    whole = sum(dev.values())
    calls = max((v[0] for v in stages.values()), default=0)
    print("terrain profile, intersect_twolevel stages (device ms / host ms "
          f"under the profiler, {calls} calls): "
          + ", ".join(f"{k[9:]} {dev[k]:.1f} / {v[1]:.1f}"
                      for k, v in stages.items())
          + f"; all stages {whole:.1f} ms device, "
          f"{whole / max(total, 1e-9):.3f} of the iteration's [{card}]",
          flush=True)
    if not stages or groups["B3"][1] <= 0 or groups["B4"][1] <= 0:
        raise AssertionError("terrain profile: no two-level stages or "
                             "kernels in the trace")
    whole = {"kernels": sum(n for _, n in groups.values()),
             "device_ms": total, "busy": total / 1e3 / render_s}
    return {k: groups[k][0] for k in ("B3", "B4")}, cull_rays, whole


def phase_b3_main_rays(card, bounds, calls, other):
    """Kernel B3 on the rays of every B3 call of one terrain iteration:
    its votes against the two-stage plain cull, its time over all the
    calls one after another, and what the design does there."""
    import torch

    from statmc_tpu_torch.accel import twolevel as TT

    def run_all():
        for rays in calls:
            TT.cull(bounds, rays)

    ms = _median_ms(run_all, warmup=1, reps=5)
    ab = _ab_ms(run_all, other)
    total = dict(reject=0, sweep=0, pairs=0, boxes=0, votes=0)
    rows = []
    for k, rays in enumerate(calls):
        work = _cull_work(bounds, rays)
        vote = TT.cull(bounds, rays)
        if not torch.equal(vote, work["vote"]):
            raise AssertionError(f"B3 main-path call {k}: votes differ on "
                                 f"{int((vote != work['vote']).sum())} pairs")
        for key in total:
            total[key] += work[key]
        G = rays.shape[0]
        rows.append((work["sweep"], k, G, int((rays[..., 6] > 0).sum()),
                     work["boxes"] / G, work["votes"] / G))
    G = sum(r.shape[0] for r in calls)
    print(f"B3 main-path rays: {len(calls)} calls, {G} blocks, votes equal "
          f"to the two-stage plain cull on every call; "
          f"{_cull_work_text(total, G)}; kernel {ms:.3f} ms over all calls"
          f"{_ab_text(ab)} [{card}]", flush=True)
    print("B3 main-path rays, the calls with the most per-ray tests (call, "
          "blocks, live rays, surviving boxes and votes per block, per-ray "
          "tests): " + "; ".join(
              f"{k} {g} {live} {b:.1f} {v:.1f} {t}"
              for t, k, g, live, b, v in sorted(rows, reverse=True)[:6]),
          flush=True)
    return dict(ms=ms, ab=ab, **total)


def _cull_tests(bounds, rays):
    """Box tests the cull needs for these rays: per (block, subgroup), the
    live rays up to the first one that votes (the sweep stops there), or
    all live rays when none does."""
    import torch

    from statmc_tpu_torch.accel.twolevel import slab_votes

    G, RT = rays.shape[0], rays.shape[1]
    total = 0
    step = max(1, (1 << 25) // (RT * bounds.shape[0]))
    for g0 in range(0, G, step):
        r = rays[g0:g0 + step]
        v = slab_votes(bounds, r)  # [g, RT, nf]
        live = torch.cumsum(r[..., 6] > 0, 1)  # [g, RT]
        first = torch.argmax(v.to(torch.uint8), 1)  # [g, nf]
        tests = torch.where(v.any(1), torch.gather(live, 1, first),
                            live[:, -1:])
        total += int(tests.sum())
    return total


def _cull_work(bounds, rays):
    """What the redesigned B3 does on these rays, counted with its plain
    twin (accel/twolevel.py:cull_reject): {reject: one test per non-empty
    sub-block and box; sweep: per box, the rays of its surviving
    sub-blocks in the kernel's order (sub-block, then block order) up to
    the first one that votes, or all of them; pairs: surviving (sub-block,
    box) pairs; boxes: boxes with a surviving sub-block; votes; vote: the
    two-stage cull's [G, nf] votes}."""
    import torch

    from statmc_tpu_torch.accel import twolevel as TT

    G, RT, nf = rays.shape[0], rays.shape[1], bounds.shape[0]
    work = dict(reject=0, sweep=0, pairs=0, boxes=0, votes=0)
    votes = []
    step = max(1, (1 << 25) // (RT * nf))
    for g0 in range(0, G, step):
        r = rays[g0:g0 + step]
        sub, keep = TT.cull_reject(bounds, r)
        ns = keep.shape[1]
        nonempty = torch.nn.functional.one_hot(sub + 1, ns + 1)[
            ..., 1:].any(1)
        order = torch.argsort(torch.where(sub >= 0, sub, ns), dim=1, stable=True)
        s_ord = sub.gather(1, order)[..., None].expand(-1, -1, nf)
        v = TT.slab_votes(bounds, r).gather(1, order[..., None].expand(
            -1, -1, nf))
        swept = keep.gather(1, s_ord.clamp(min=0)) & (s_ord >= 0)
        hit = swept & v
        upto = torch.cumsum(swept, 1)
        first = torch.argmax(hit.to(torch.uint8), 1, keepdim=True)
        tests = torch.where(hit.any(1), upto.gather(1, first)[:, 0],
                            upto[:, -1])
        work["reject"] += int(nonempty.sum()) * nf
        work["sweep"] += int(tests.sum())
        work["pairs"] += int(keep.sum())
        work["boxes"] += int(keep.any(1).sum())
        votes.append(hit.any(1))
        work["votes"] += int(votes[-1].sum())
    work["vote"] = torch.cat(votes) if votes else None
    return work


def _cull_work_text(work, G):
    return (f"reject tests {work['reject']}, per-ray tests {work['sweep']}; "
            f"per block {work['boxes'] / G:.1f} boxes survive "
            f"({work['pairs'] / G:.1f} (sub-block, box) pairs), "
            f"{work['votes'] / G:.1f} vote")


def _pick_blocks(n_eff, G):
    """SUBSET block ids: up to a quarter from the dense-walk blocks, the
    rest spread evenly over all blocks."""
    import torch

    from statmc_tpu_torch.accel.twolevel import MAXS

    dense = torch.nonzero(n_eff > MAXS)[:, 0]
    take = dense[torch.linspace(0, len(dense) - 1, min(len(dense),
                                                       SUBSET // 4),
                                device=dense.device).long()] if len(
        dense) else dense
    rest = torch.linspace(0, G - 1, SUBSET - len(take),
                          device=n_eff.device).long()
    return torch.unique(torch.cat([take, rest]))


def phase_b3_b4(rng, card, setup, other):
    """Kernels B3 and B4 against their plain versions on the terrain
    table, with the camera rays and random rays grazing the floor: B3 on
    every block, B4 on SUBSET blocks."""
    import numpy as np
    import torch

    from statmc_tpu_torch.accel import twolevel as TT
    from statmc_tpu_torch.render import camera as CAM

    tl = setup.bvh
    dev = tl.table.device
    P = WIDTH * HEIGHT
    ids = torch.arange(P, device=dev)
    pxy = torch.stack([(ids % WIDTH).float() + 0.5,
                       (ids // WIDTH).float() + 0.5], -1)
    o_c, d_c = CAM.generate_rays(setup.cam, pxy)
    lo = tl.world_lo.cpu().numpy()
    hi = lo + tl.world_ext.cpu().numpy()
    o_r, d_r, tm_r = (torch.as_tensor(x, device=dev)
                      for x in _grazing_rays(rng, lo, hi))
    sets = {"camera": (o_c, d_c, torch.full((P,), 1e30, device=dev), True),
            "grazing": (o_r, d_r, tm_r, False)}
    out = {}
    for name, (o, d, t_max, sort) in sets.items():
        _, o_p, d_p, tm_p = TT.blocks(tl, o, d, t_max, sort)
        rays = TT.slab_rays(o_p, d_p, tm_p)
        feat = TT.block_features(o_p, d_p)
        tmb = tm_p.reshape(-1, TT.RT_WALK)
        G = rays.shape[0]
        vote = TT.cull(tl.bounds, rays)
        order, n_eff, mask = TT.worklists(tl, vote)
        t_k, id_k = TT.walk(tl.table, order, n_eff, mask, feat, tmb,
                            tl.fsub, tl.packed)
        sub = _pick_blocks(n_eff, G)
        vote_p, cull_plain_ms = _once_ms(
            lambda: TT.cull_plain(tl.bounds, rays))
        if not torch.equal(vote_p, vote):
            raise AssertionError(f"B3 {name}: votes differ on "
                                 f"{int((vote_p != vote).sum())} pairs")
        (t_p, id_p), walk_plain_ms = _once_ms(lambda: TT.walk_plain(
            tl.table, order[sub], n_eff[sub], mask[sub], feat[sub],
            tmb[sub], tl.fsub))
        bits_p, bits_k = t_p.view(torch.int32), t_k[sub].view(torch.int32)
        if not (torch.equal(id_p, id_k[sub]) and torch.equal(bits_p, bits_k)):
            raise AssertionError(
                f"B4 {name}: ids differ on {int((id_p != id_k[sub]).sum())}"
                f" rays, t bits on {int((bits_p != bits_k).sum())}")
        if name == "grazing" and not bool((n_eff[sub] > TT.MAXS).any()):
            raise AssertionError("B4 grazing: no dense-walk block compared")
        cull_err = float((vote_p.float() - vote.float()).abs().max())
        walk_err = float((t_p - t_k[sub]).abs().max())
        cull_ms = _median_ms(lambda: TT.cull(tl.bounds, rays))
        cull_ab = _ab_ms(lambda: TT.cull(tl.bounds, rays), other)
        walk_ms = _median_ms(lambda: TT.walk(tl.table, order, n_eff, mask,
                                             feat, tmb, tl.fsub, tl.packed))
        # B4 on its plain version's blocks: like-for-like times.
        walk_sub = (tl.table, order[sub], n_eff[sub], mask[sub], feat[sub],
                    tmb[sub], tl.fsub, tl.packed)
        walk_sub_ms = _median_ms(lambda: TT.walk(*walk_sub))
        # Worklist statistics and the work these rays need.
        count = vote.reshape(G, tl.n_sub, tl.fsub).any(-1).sum(1)
        dense = n_eff > TT.MAXS
        live = (tmb > 0).sum(1)
        walked = ~dense & (count > 0)
        fine = vote.sum(1)
        sub_sg = count * tl.fsub  # subgroups in the walked subtiles
        gated = float(1 - fine[walked].sum() / max(int(sub_sg[walked].sum()),
                                                    1))
        req = torch.where(dense, tl.n_sub * tl.fsub, fine) * (
            TT.ST // tl.fsub)  # triangles each block's walk tests
        pairs = int((live * req).sum())
        tests = _cull_tests(tl.bounds, rays)
        work = _cull_work(tl.bounds, rays)
        b3_bytes = _nbytes(tl.bounds, rays, vote)
        b3 = _bound(work["reject"] * B3_REJECT_OPS + work["sweep"] * B3_OPS,
                    b3_bytes)
        b3_flat, _ = _bound(tests * B3_OPS, b3_bytes)
        b4_bytes = _nbytes(tl.packed, order, n_eff, mask, feat, tmb, t_k,
                           id_k)
        b4 = _bound(pairs * B4_OPS, b4_bytes)
        b4_eager, _ = _bound(pairs * EAGER_OPS, b4_bytes)
        print(f"B3/B4 {name}: {o.shape[0]} rays ({int(live.sum())} live) in "
              f"{G} blocks, sort={sort}; worklist mean "
              f"{float(count.float().mean()):.1f} max {int(count.max())} of "
              f"{tl.n_sub} subtiles, {int(dense.sum())} dense-walk blocks, "
              f"mask gates off {gated:.4f} of the walked subgroups; "
              f"{tests} box tests in a flat sweep, {pairs} (ray, triangle) "
              f"pairs", flush=True)
        print(f"B3 {name}: votes equal on all {G} blocks; "
              f"{_cull_work_text(work, G)}; kernel {cull_ms:.3f} ms, plain "
              f"{cull_plain_ms:.3f} ms (once), bound {b3[0]:.3f} ms "
              f"({b3[1]}; {b3[0] / cull_ms:.3f} of the kernel's time; "
              f"{b3_flat:.3f} ms, {b3_flat / cull_ms:.3f}, at the flat "
              f"sweep's {tests} tests){_ab_text(cull_ab)} [{card}]",
              flush=True)
        print(f"B4 {name}: (t, id) bit-identical on {len(sub)} blocks "
              f"({int(dense[sub].sum())} dense), {int((id_k >= 0).sum())} "
              f"hits; kernel {walk_ms:.3f} ms ({G} blocks), {walk_sub_ms:.3f}"
              f" ms and plain {walk_plain_ms:.3f} ms (once) on the "
              f"{len(sub)} compared blocks, bound {b4[0]:.3f} ms ({b4[1]}, "
              f"{G} blocks; {b4[0] / walk_ms:.3f} of the kernel's time; "
              f"{b4_eager:.3f} ms, {b4_eager / walk_ms:.3f}, at {EAGER_OPS} "
              f"operations a pair) [{card}]", flush=True)
        out[name] = dict(blocks=G, plain_blocks=len(sub), cull_ms=cull_ms,
                         walk_ms=walk_ms, walk_sub_ms=walk_sub_ms,
                         cull_plain_ms=cull_plain_ms,
                         walk_plain_ms=walk_plain_ms, cull_err=cull_err,
                         walk_err=walk_err, b3=b3, b4=b4)
    return out


# The reference renderer's fixture scenes (tests/fixtures/refparity/):
# base seed, film and moment tolerances (tests/test_refparity.py), width,
# tracked bounces.
REFPARITY = {"tiny": (0, 2e-6, 2e-5, 16, 1),
             "mirrorbox": (7, 2e-5, 5e-5, 16, 1),
             "fourtile": (11, 5e-5, 2e-4, 32, 1),
             "arealight": (3, 1e-5, 3e-4, 16, 1),
             "tracked": (5, 2e-4, 5e-4, 16, 3)}
LD_SAMPLERS = ("halton", "sobol", "02sequence")
CROP, CROP_RADIUS = 96, 5  # B2 backward against autodiff


def _with_sampler(text, sampler):
    if 'Sampler "random"' not in text:
        raise AssertionError("scene text without a random sampler")
    return text.replace('Sampler "random"', f'Sampler "{sampler}"')


def _write_scene(tmp, name, text):
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_samplers(card):
    """One iteration of the 1280x720 staircase under random and each LD
    sampler, once each (random, halton, sobol, 02sequence; B1's launches
    counted around each), then the 32x24 proxy under every sampler mode
    on the card and on the CPU.  Returns {sampler: rays/s}.  (Until the
    mesh phases joined the run, each sampler ran twice, in turns back;
    its second run was cut to keep the run inside its time limit.)"""
    import numpy as np
    from statmc_tpu_torch import spans

    from statmc_tpu_torch.driver import load

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        order = ("random",) + LD_SAMPLERS
        for sampler in order:
            path = _write_scene(tmp, f"{sampler}.pbrt", _with_sampler(
                _scene_text(WIDTH, HEIGHT, SAMPLER_SPP), sampler))
            r = load(path, device="cuda")
            r.progress = False
            spans.reset("kernel.")
            log = r.render(iterations=1, verbose=False)[-1]
            launches = spans.counted("kernel.B1")
            film = r.film_mean.cpu().numpy()
            if not (np.isfinite(film).all() and film.mean() > 0
                    and launches > 0):
                raise AssertionError(f"{sampler}: film or launches")
            rate = log["rays_total"] / log["render_s"]
            runs.setdefault(sampler, []).append(rate)
            print(f"sampler {sampler}: {WIDTH}x{HEIGHT} spp {SAMPLER_SPP} "
                  f"maxdepth "
                  f"{MAXDEPTH}, iteration 1: {log['rays_total']:.0f} rays "
                  f"in {log['render_s']:.3f} s = {rate:.1f} rays/s, B1 "
                  f"launches {launches} [{card}]", flush=True)
            del r
    rates = {k: statistics.mean(v) for k, v in runs.items()}
    print("samplers, rays/s against random's: "
          + ", ".join(f"{k} {rates[k] / rates['random']:.3f} ("
                      + ", ".join(f"{x:.0f}" for x in runs[k]) + ")"
                      for k in order) + f" [{card}]", flush=True)
    for sampler in LD_SAMPLERS + ("lockstep",):
        phase_small_reference(card, f"staircase-{sampler}",
                              _with_sampler(scene_small(), sampler))
    return rates


def phase_b2_backward(card):
    """denoise/grad.py's FilterApply on the card: its backward pass is B2
    with normalize=False on g / max(wsum, 1e-20).  At 1280x720, r = 20,
    G = 6, CF = 3 against the plain version's VJP on the same inputs
    (rtol 1e-4 / atol 1e-6); on a 96x96 crop at r = 5 against
    filter_apply_diff's autograd (rtol 1e-3 / atol 1e-5).  Times: the
    backward kernel alone and forward + backward (CUDA events, median of
    10 after 3 warm-ups), with the backward's bound."""
    import numpy as np
    import torch
    from statmc_tpu_torch import spans

    from statmc_tpu_torch.denoise import filter_cuda as FC
    from statmc_tpu_torch.denoise import grad as TG

    # A generator of its own, so that the later phases' inputs stay those
    # of earlier runs.
    rng = np.random.default_rng(5)
    mc, d2, fm, gb, valid = _filter_inputs(rng)
    gf = (-0.5 / 0.02 ** 2,) * 3 + (-0.5 / 0.1 ** 2,) * 3
    ds = -0.5 / 10.0 ** 2
    g = torch.as_tensor(rng.standard_normal(fm.shape).astype(np.float32),
                        device="cuda")
    x = fm.clone().requires_grad_(True)
    spans.reset("kernel.")
    TG.filter_apply(x, mc, d2, gb, valid, RADIUS, ds, gf).backward(g)
    torch.cuda.synchronize()
    launches = spans.counted("kernel.B2")
    if launches != 2:
        raise AssertionError(f"FilterApply: {launches} B2 launches, not 2")
    _, wsum_p = FC.run_filter_plain(mc, d2, fm, gb, valid, RADIUS, ds, gf)
    gg_p = (g / torch.clamp(wsum_p, min=1e-20)[..., None]).contiguous()
    (grad_p, _), plain_ms = _once_ms(lambda: FC.run_filter_plain(
        mc, d2, gg_p, gb, valid, RADIUS, ds, gf, normalize=False))
    torch.testing.assert_close(x.grad, grad_p, rtol=1e-4, atol=1e-6)
    err = float((x.grad - grad_p).abs().max())

    _, wsum = FC.run_filter(mc, d2, fm, gb, valid, RADIUS, ds, gf)
    gg = (g / torch.clamp(wsum, min=1e-20)[..., None]).contiguous()
    bwd_args = (mc, d2, gg, gb, valid, RADIUS, ds, gf, False)
    ms = _median_ms(lambda: FC.run_filter(*bwd_args))

    def fwd_bwd():
        y = fm.detach().requires_grad_(True)
        TG.filter_apply(y, mc, d2, gb, valid, RADIUS, ds, gf).backward(g)

    fb_ms = _median_ms(fwd_bwd)
    pairs, accepted = _filter_pairs(mc, d2, RADIUS)
    grad_k, _ = FC.run_filter(*bwd_args)
    bound_ms, bound_by = _bound(
        pairs * B2_OPS_REJECT + accepted * (B2_OPS_ACCEPT - B2_OPS_REJECT),
        _nbytes(mc, d2, gg, gb, valid, grad_k, wsum))

    c = (slice(0, CROP), slice(0, CROP))
    crop = [t[c].contiguous() for t in (fm, mc, d2, gb, valid, g)]
    xk = crop[0].clone().requires_grad_(True)
    xd = crop[0].clone().requires_grad_(True)
    TG.filter_apply(xk, *crop[1:5], CROP_RADIUS, ds, gf).backward(crop[5])
    TG.filter_apply_diff(xd, *crop[1:5], CROP_RADIUS, ds, gf).backward(
        crop[5])
    torch.testing.assert_close(xk.grad, xd.grad, rtol=1e-3, atol=1e-5)
    crop_err = float((xk.grad - xd.grad).abs().max())
    print(f"B2 backward: {WIDTH}x{HEIGHT} r={RADIUS} G=6 CF=3, FilterApply "
          f"launched B2 {launches} times (forward, backward); gradient "
          f"against the plain VJP max |d| {err:.3e}; {CROP}x{CROP} crop "
          f"r={CROP_RADIUS} against filter_apply_diff max |d| "
          f"{crop_err:.3e}; backward kernel {ms:.3f} ms, plain {plain_ms:.3f}"
          f" ms (once), bound {bound_ms:.3f} ms ({bound_by}; "
          f"{bound_ms / ms:.3f} of the kernel's time; {pairs} in-image "
          f"pairs, {accepted / pairs:.4f} accepted); forward + backward "
          f"{fb_ms:.3f} ms [{card}]", flush=True)
    return dict(launches=launches, ms=ms, plain_ms=plain_ms, err=err,
                crop_err=crop_err, bound_ms=bound_ms, bound_by=bound_by,
                fwd_bwd_ms=fb_ms)


def _b1_on_calls(calls, max_plain=None):
    """Kernel B1 against intersect_plain on the inputs of each recorded
    intersect_fused call (the table, and the rays' features as that call
    makes them): ids equal on every ray and t equal as bits.  max_plain:
    a call with more rays has its plain version run on that many of them
    (a seeded choice; each ray's result depends on that ray alone), the
    kernel on all.  Returns (calls, live rays of the smallest and of the
    largest call, calls with 1-4 live rays)."""
    import torch

    from statmc_tpu_torch.accel import fused as F

    lives = []
    gen = torch.Generator().manual_seed(SEED)
    for k, (ft, o, d, t_max) in enumerate(calls):
        raye, rayp = (x.contiguous() for x in F.ray_features(o, d))
        args = (ft.edge_table, ft.plane_table, raye, rayp, t_max)
        t_k, id_k = F.intersect_tiles(*args, ft.packed, ft.n_tris)
        if max_plain is not None and o.shape[0] > max_plain:
            sub = torch.randperm(o.shape[0], generator=gen)[:max_plain].to(
                o.device)
            args = args[:2] + tuple(x[sub].contiguous() for x in args[2:])
            t_k, id_k = t_k[sub], id_k[sub]
        t_p, id_p = F.intersect_plain(*args, ft.n_tris)
        if not (torch.equal(id_k, id_p)
                and torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))):
            raise AssertionError(f"B1 on replay call {k}: ids differ on "
                                 f"{int((id_k != id_p).sum())} rays, t bits "
                                 f"on {int((t_k != t_p).sum())}")
        lives.append((t_max > 0).sum())
    lives = torch.stack(lives).cpu()
    return (len(calls), int(lives.min()), int(lives.max()),
            int(((lives >= 1) & (lives <= 4)).sum()))


def phase_reference_parity(card):
    """render_lockstep_exact of the five fixture scenes on the card, each
    held to the C++ reference's own PFMs at tests/test_refparity.py's
    tolerances (film, n exact, mean / m2 / m3, film-mean, and tracked's
    bounces 1 and 2 at 1e-3); the inputs of every B1 call of the replay
    are recorded, and B1 is held on each against its plain version, bit
    for bit.  Returns ({scene: seconds}, {scene: B1 calls checked})."""
    import numpy as np
    from statmc_tpu_torch import spans

    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.io.pfm import read_pfm
    from statmc_tpu_torch.render import intersect as TI
    from statmc_tpu_torch.render.lockstep_exact import moments_from_samples

    fix = os.path.join(REPO, "tests", "fixtures", "refparity")
    times, checked = {}, {}
    real = TI.intersect_fused
    for stem, (seed, film_tol, mom_tol, wh, tracked) in REFPARITY.items():
        def ref(name):
            return read_pfm(os.path.join(fix, f"{stem}-4-{name}.pfm"))

        calls = []

        def record(ft, o, d, t_max):
            calls.append((ft, o.clone(), d.clone(), t_max.clone()))
            return real(ft, o, d, t_max)

        r = load(os.path.join(fix, f"{stem}.pbrt"), base_seed=seed,
                 device="cuda")
        TI.intersect_fused = record
        try:
            spans.reset("kernel.")
            t0 = time.perf_counter()
            rep = r.render_lockstep_exact(spp=4)
            times[stem] = time.perf_counter() - t0
            launches = spans.counted("kernel.B1")
        finally:
            TI.intersect_fused = real
        n_calls, live_lo, live_hi, few = _b1_on_calls(calls)
        del calls
        checked[stem] = n_calls
        if n_calls != launches:
            raise AssertionError(f"{stem}: {n_calls} intersect_fused calls, "
                                 f"{launches} B1 launches")
        shape = (wh, wh, 3)
        worst = {"film": (float(np.abs(rep.film.reshape(shape)
                                       - ref("film")).max()), film_tol)}
        n, mean, m2, m3 = moments_from_samples(rep.radiance)
        if not np.array_equal(n.reshape(wh, wh), ref("t0-b0-n")):
            raise AssertionError(f"{stem}: sample counts differ")
        _, fmean, _, _ = moments_from_samples(rep.radiance, bc_lambda=None)
        checks = [("mean", mean), ("m2", m2), ("m3", m3),
                  ("film-mean", fmean)]
        for name, x in checks:
            worst[name] = (float(np.abs(x.reshape(shape)
                                        - ref(f"t0-b0-{name}")).max()),
                           mom_tol)
        for b in range(1, tracked):
            _, bm, bm2, bm3 = moments_from_samples(rep.radiance_b[:, :, b])
            for name, x in (("mean", bm), ("m2", bm2), ("m3", bm3)):
                worst[f"b{b}-{name}"] = (float(np.abs(
                    x.reshape(shape) - ref(f"t0-b{b}-{name}")).max()), 1e-3)
        bad = {k: v for k, v in worst.items() if not v[0] <= v[1]}
        if bad or launches <= 0:
            raise AssertionError(f"{stem}: beyond tolerance {bad}, B1 "
                                 f"launches {launches}")
        print(f"reference parity {stem}: {wh}x{wh} 4 spp, seed {seed}, "
              f"{times[stem]:.2f} s, B1 launches {launches}, B1 bit-identical"
              f" to plain on the inputs of all {n_calls} calls ({live_lo}-"
              f"{live_hi} live rays a call, {few} calls with 1-4), n exact, "
              f"max |d| (tolerance) " + ", ".join(
                  f"{k} {v[0]:.2e} ({v[1]:.0e})" for k, v in worst.items())
              + f" [{card}]", flush=True)
    return times, checked


def phase_checkpoint(card):
    """A 2-iteration small staircase on the card, interrupted after
    iteration 1, saved, restored into a fresh renderer and finished:
    film, film-f, ray total, counters and every state equal the
    uninterrupted render bit for bit, and the resumed iteration launched
    B1 and B2.  Returns their launches in it."""
    import torch
    from statmc_tpu_torch import spans

    from statmc_tpu_torch.driver import load

    with tempfile.TemporaryDirectory() as tmp:
        path = _write_scene(tmp, "small.pbrt", scene_small())
        full = load(path, base_seed=5, device="cuda")
        full.progress = False
        full.render(iterations=2, verbose=False)
        a = load(path, base_seed=5, device="cuda")
        a.progress = False
        a.render(iterations=1, verbose=False)
        ck = os.path.join(tmp, "ckpt.pt")
        a.save_checkpoint(ck, next_iteration=2)
        b = load(path, base_seed=5, device="cuda")
        b.progress = False
        nxt = b.restore_checkpoint(ck)
        spans.reset("kernel.")
        b.render(iterations=2, verbose=False, start_iteration=nxt)
        launches = {"B1": spans.counted("kernel.B1"),
                    "B2": spans.counted("kernel.B2"),
                    "R1": spans.counted("kernel.R1")}
    pairs = [("film", b.film_mean, full.film_mean),
             ("film-f", b.film_f, full.film_f),
             ("ray_total", b.ray_total, full.ray_total)]
    pairs += [(f"stat {k}", b.stats[k], v) for k, v in full.stats.items()]
    pairs += [(f"state {t} {k}", b.states[t][k], v)
              for t, st in full.states.items() for k, v in st.items()]
    bad = [n for n, x, y in pairs if not torch.equal(x, y)]
    if nxt != 2 or bad or min(launches.values()) <= 0:
        raise AssertionError(f"checkpoint resume: next {nxt}, differ {bad}, "
                             f"launches {launches}")
    print(f"checkpoint: {SMALL_W}x{SMALL_H} staircase, iteration 1 saved, "
          f"restored and finished: {len(pairs)} tensors equal the "
          f"uninterrupted render bit for bit; resumed iteration's launches "
          f"{launches} [{card}]", flush=True)
    return launches


def _config_block(name, maxdepth, denoiseimage=None):
    """configs/<name>.pbrt (its Integrator and Sampler blocks) with
    maxdepth cut, and denoiseimage set if asked."""
    with open(os.path.join(REPO, "configs", f"{name}.pbrt")) as f:
        text = f.read()
    cuts = [('"integer  maxdepth"           [65]',
             f'"integer  maxdepth"           [{maxdepth}]')]
    if denoiseimage is not None:
        flag = "true" if denoiseimage else "false"
        cuts.append(('"bool     denoiseimage"     ["false"]',
                     f'"bool     denoiseimage"     ["{flag}"]'))
    for old, new in cuts:
        if old not in text:
            raise AssertionError(f"configs/{name}.pbrt: no {old}")
        text = text.replace(old, new)
    return text


def phase_cli(card):
    """python -m statmc_tpu_torch on the card in a subprocess: the
    1280x720 staircase with configs/render-for-ours.pbrt's block
    (calcstats, every buffer written, filter radius 20; cut to maxdepth
    8 and its 4 spp, as the staircase main path runs), 2 iterations;
    then --denoise on its directory with configs/denoise.pbrt's block.
    Every PFM finite; film-f of each iteration within rtol 1e-4 / atol
    1e-5 of the same render denoised in memory (the render-for-ours block
    with denoiseimage on: ACRR and SMIS are off, so the filter changes
    no draw).  The launch counts are each subprocess's own, from its
    ``Kernel launches:`` line on standard error: B1 and R1 must have run
    in the render, B2 in the --denoise run."""
    import numpy as np

    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.io.pfm import read_pfm

    world = _scene_text(WIDTH, HEIGHT)
    world = world[world.index("Film "):]
    stem = "staircase-proxy"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {
            "render": _config_block("render-for-ours", MAXDEPTH),
            "denoise": _config_block("denoise", MAXDEPTH),
            "memory": _config_block("render-for-ours", MAXDEPTH, True)}
        paths = {k: _write_scene(tmp, f"{k}.pbrt", v + world)
                 for k, v in scenes.items()}
        outdir = os.path.join(tmp, "out")
        runs = {}
        for name, extra in (("render", ["--writeimages", "--baseseed", "3"]),
                            ("denoise", ["--denoise"])):
            cmd = [sys.executable, "-m", "statmc_tpu_torch", paths[name],
                   "--outdir", outdir, "--iterations", "2"] + extra
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                  text=True, timeout=600)
            runs[name] = (time.perf_counter() - t0, proc.stdout)
            if proc.returncode != 0:
                raise AssertionError(f"CLI {name}: rc {proc.returncode}\n"
                                     f"{proc.stdout[-2000:]}"
                                     f"{proc.stderr[-4000:]}")
            tag = "Kernel launches: "
            counts = [ln[len(tag):] for ln in proc.stderr.splitlines()
                      if ln.startswith(tag)]
            if len(counts) != 1:
                raise AssertionError(f"CLI {name}: no launch counts\n"
                                     f"{proc.stderr[-2000:]}")
            out[name] = json.loads(counts[0])
        if (out["render"]["B1"] <= 0 or out["render"]["R1"] <= 0
                or out["denoise"]["B2"] <= 0):
            raise AssertionError(f"CLI launch counts {out}")
        files = sorted(os.listdir(outdir))
        by_spp = {spp: sorted(f[len(f"{stem}-{spp}-"):-4] for f in files
                              if f.startswith(f"{stem}-{spp}-"))
                  for spp in (SPP, 2 * SPP)}
        need = {"film", "film-f", "t0-b0-n", "t0-b0-mean", "t0-b0-m2",
                "t0-b0-m3", "t0-b0-film-mean", "t0-b0-film-m2"}
        if by_spp[SPP] != by_spp[2 * SPP] or not need <= set(by_spp[SPP]):
            raise AssertionError(f"CLI file set: {by_spp}")
        for f in files:
            if not np.isfinite(read_pfm(os.path.join(outdir, f))).all():
                raise AssertionError(f"CLI {f}: not finite")

        r = load(paths["memory"], base_seed=3, device="cuda")
        r.progress = False
        rd = load(paths["denoise"], device="cuda")
        worst = 0.0
        for i in (1, 2):
            r.run_iteration(i)
            disk = read_pfm(os.path.join(
                outdir, f"{stem}-{r.total_spp(i)}-film-f.pfm"))
            mem = r.film_f.cpu().numpy().reshape(disk.shape)
            np.testing.assert_allclose(disk, mem, rtol=1e-4, atol=1e-5)
            worst = max(worst, float(np.abs(disk - mem).max()))
        # In this process too; it writes its own film and film-f over the
        # subprocess's, which were read above.
        rd.denoise_from_disk(outdir, 2)
        np.testing.assert_allclose(rd.film_f.cpu().numpy().reshape(
            disk.shape), disk, rtol=1e-4, atol=1e-5)
    stats = runs["render"][1][runs["render"][1].index("Statistics:"):]
    print(f"CLI: python -m statmc_tpu_torch, {WIDTH}x{HEIGHT}, "
          "configs/render-for-ours.pbrt cut to maxdepth "
          f"{MAXDEPTH} and {SPP} spp, 2 iterations: rc 0 in "
          f"{runs['render'][0]:.1f} s, {len(files)} PFMs ("
          f"{len(by_spp[SPP])} per iteration, all finite); --denoise with "
          f"configs/denoise.pbrt: rc 0 in {runs['denoise'][0]:.1f} s; film-f"
          f" against the in-memory denoise max |d| {worst:.3e}; launches "
          f"in the subprocesses: render {out['render']}, --denoise "
          f"{out['denoise']} [{card}]", flush=True)
    print("CLI statistics: " + " | ".join(
        ln.strip() for ln in stats.strip().splitlines()), flush=True)
    return out


# ---------------------------------------------------------------------------
# Hair (Marschner) and subsurface scattering (BSSRDF probe chains).

HAIR_SSS_SHARE = 0.05  # first-hit share that hair and SSS must each reach
HAIR_SMALL_CURVES = 128  # the small card-against-CPU staircase's tuft
PROBE_STEPS = 4  # render/sss.py: the probe chain's closest-hit calls
# Rays of a recorded main-path B1 call on which its plain version runs
# (plain B1 over 921,600 rays x 13,358 triangles takes ~12 s).
PROBE_PLAIN_RAYS = 1 << 15
# The hair + SSS small staircase's share of pixels within rtol 1e-4 (card
# against CPU, equal ray totals): 0.9779 at worst (its m3; every other
# buffer >= 0.987) on an NVIDIA H100 80GB HBM3 at 700 W.  The hair
# ribbons turn the card's ulps into larger differences than the other
# scenes' (>= 0.99): SMALL_SHARE is not met.  The JAX package agrees with
# itself on less of such a scene: compiled at -O0, on 0.9089 of a 24x16
# hair + SSS staircase's pixels (tests/test_torch_hair_sss_witness.py).
HAIR_SMALL_SHARE = 0.97


def _hair_sss_text(which, width=WIDTH, height=HEIGHT, **kw):
    """The full-width hair + SSS staircase (768 curves, fused path) or
    terrain (2,048 curves, two-level path) at the untextured scenes'
    settings, denoised."""
    from statmc_tpu_torch.testscenes import (hair_sss_scene_text,
                                             hair_sss_terrain_text)

    if which == "staircase":
        return hair_sss_scene_text(width=width, height=height,
                                   spp=FEATURE_SPP, iterations=2,
                                   maxdepth=MAXDEPTH,
                                   filterradius=RADIUS, seed=SEED, **kw)
    return hair_sss_terrain_text(width=width, height=height,
                                 spp=FEATURE_SPP, iterations=1,
                                 maxdepth=TERRAIN_MAXDEPTH, seed=SEED, **kw)


def _first_hit_shares(r):
    """(hair, subsurface) shares of the camera rays' first hits through
    the pixel centres."""
    import torch

    from statmc_tpu_torch.render import camera as CAM
    from statmc_tpu_torch.render.intersect import intersect_scene
    from statmc_tpu_torch.scene import build as sb

    s = r.s
    P = s.width * s.height
    ids = torch.arange(P, device=s.device)
    pxy = torch.stack([(ids % s.width).float() + 0.5,
                       (ids // s.width).float() + 0.5], -1)
    o, d = CAM.generate_rays(s.cam, pxy)
    hit = intersect_scene(s.scene, o, d,
                          torch.full((P,), 1e30, device=s.device), s.bvh)
    mt = torch.where(hit.found, s.scene.mat_type[hit.mat_id.long()], -1)
    return (float((mt == sb.MAT_HAIR).float().mean()),
            float(((mt == sb.MAT_KDSUBSURFACE)
                   | (mt == sb.MAT_SUBSURFACE)).float().mean()))


@contextlib.contextmanager
def _patched(*patches):
    """Set each (object, attribute, value) for the duration, then put
    the old values back."""
    old = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in old:
            setattr(obj, name, value)


def _hair_sss_counters(r, its):
    """Patches that append one dict a render iteration of r to `its` and
    count in it, each with one reduction a call and no synchronisation:
    lanes whose material ran the Marschner model (the bounce's hair
    hits), lanes where the SSS block fired, those whose Sample_Sp
    returned ok, and the probe chain's live rays."""
    from statmc_tpu_torch.render import bsdf as B
    from statmc_tpu_torch.render import sss as SSS
    from statmc_tpu_torch.scene import build as sb

    real = (B.gather_materials, SSS.sample_sp, SSS.intersect_probe,
            r.run_iteration)

    def add(key, x):
        its[-1][key] = its[-1].get(key, 0) + x

    def gather(*a, **k):
        m = real[0](*a, **k)
        if m.hair_h is not None:
            add("marschner", (m.mat_type == sb.MAT_HAIR).sum())
        return m

    def sample_sp(*a, **k):
        res = real[1](*a, **k)
        add("fired", a[-1].sum())
        add("ok", res.ok.sum())
        return res

    def probe(scene, bvh, o, d, t_max):
        add("probe_rays", (t_max > 0).sum())
        return real[2](scene, bvh, o, d, t_max)

    def run_iteration(i):
        its.append({})
        return real[3](i)

    return ((B, "gather_materials", gather), (SSS, "sample_sp", sample_sp),
            (SSS, "intersect_probe", probe),
            (r, "run_iteration", run_iteration))


def _counters_text(its):
    return "; ".join(
        f"iteration {i + 1}: Marschner lanes {int(it.get('marschner', 0))}, "
        f"SSS fired {int(it.get('fired', 0))}, Sample_Sp ok "
        f"{int(it.get('ok', 0)) / max(int(it.get('fired', 0)), 1):.4f}, "
        f"probe rays {int(it.get('probe_rays', 0))}"
        for i, it in enumerate(its))


def phase_hair_sss(card, which, plain_s, plain_rays):
    """load(the hair + SSS `which`).render() on the card at full width:
    the kernels of its path launched (B1 and B2 on the staircase, B2, B3
    and B4 on the terrain; every count set to 0 just before the render
    and read just after), film and film-f finite with mean > 0, hair and
    subsurface materials each on >= HAIR_SSS_SHARE of the first hits;
    rays/s beside the untextured scene's (plain_s, plain_rays: its last
    iteration in this run), peak device memory and the per-iteration
    hair/SSS counters.
    Returns (renderer, launches, last iteration's log, its rays/s)."""
    import numpy as np
    import torch

    from statmc_tpu_torch.accel import fused as F
    from statmc_tpu_torch.accel import twolevel as TT
    from statmc_tpu_torch.driver import load

    need = ("B1", "B2") if which == "staircase" else ("B2", "B3", "B4")
    with tempfile.TemporaryDirectory() as tmp:
        path = _write_scene(tmp, f"hair-sss-{which}.pbrt",
                            _hair_sss_text(which))
        t0 = time.perf_counter()
        r = load(path, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    acc = F.FusedTris if which == "staircase" else TT.TwoLevelTris
    if not (isinstance(r.s.bvh, acc) and r.s.scene.has_hair
            and r.s.icfg.enable_sss):
        raise AssertionError(f"hair sss {which}: {type(r.s.bvh).__name__}, "
                             f"hair {r.s.scene.has_hair}, sss "
                             f"{r.s.icfg.enable_sss}")
    r.progress = False
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    its = []
    with _patched(*_hair_sss_counters(r, its)):
        _zero_counts()
        logs = r.render(verbose=False)
        torch.cuda.synchronize()
        launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() - held
    bufs = r.buffers()
    for name in ("film", "film-f"):
        if not (np.isfinite(bufs[name]).all() and bufs[name].mean() > 0):
            raise AssertionError(f"hair sss {which} {name}: not finite with "
                                 "mean > 0")
    if min(launches[k] for k in need) <= 0:
        raise AssertionError(f"hair sss {which} launch counts {launches}")
    hair, sss = _first_hit_shares(r)
    if min(hair, sss) < HAIR_SSS_SHARE:
        raise AssertionError(f"hair sss {which}: first-hit shares hair "
                             f"{hair:.4f}, SSS {sss:.4f}")
    if min(int(it.get("ok", 0)) for it in its) <= 0:
        raise AssertionError(f"hair sss {which}: no Sample_Sp succeeded")
    prev, rates = 0.0, []
    for log in logs:
        rays = log["rays_total"] - prev
        prev = log["rays_total"]
        rates.append(rays / log["render_s"])
    print(f"hair sss {which}: {r.s.bvh.n_tris} tris, {WIDTH}x{HEIGHT}, "
          f"setup {setup_s:.1f} s; last iteration {rays:.0f} rays in "
          f"{logs[-1]['render_s']:.3f} s = {rates[-1]:.1f} rays/s (untextured "
          f"{which} in this run: {plain_rays:.0f} rays in {plain_s:.3f} s = "
          f"{plain_rays / plain_s:.1f} rays/s, ratio "
          f"{rates[-1] / (plain_rays / plain_s):.3f}), denoise "
          f"{logs[-1]['denoise_s'] * 1e3:.1f} ms, peak memory "
          f"{peak / 2**30:.2f} GiB; first hits: hair {hair:.4f}, SSS "
          f"{sss:.4f}; film mean {bufs['film'].mean():.5f}; launches "
          f"{launches} [{card}]", flush=True)
    print(f"hair sss {which} counters: {_counters_text(its)} [{card}]",
          flush=True)
    if which == "terrain":
        _print_terrain_worklists(card, r)
    return r, launches, logs[-1], rates[-1]


def _print_terrain_worklists(card, r):
    """B3's surviving boxes per block and B4's dense-walk blocks on the
    hair + SSS terrain's camera rays (sorted, as the main path sorts
    them): what the tuft's long thin triangles do to the worklists."""
    import torch

    from statmc_tpu_torch.accel import twolevel as TT
    from statmc_tpu_torch.render import camera as CAM

    tl, P = r.s.bvh, WIDTH * HEIGHT
    ids = torch.arange(P, device=tl.table.device)
    pxy = torch.stack([(ids % WIDTH).float() + 0.5,
                       (ids // WIDTH).float() + 0.5], -1)
    o, d = CAM.generate_rays(r.s.cam, pxy)
    _, o_p, d_p, tm_p = TT.blocks(tl, o, d, torch.full(
        (P,), 1e30, device=o.device))
    vote = TT.cull(tl.bounds, TT.slab_rays(o_p, d_p, tm_p))
    _, n_eff, _ = TT.worklists(tl, vote)
    boxes = vote.sum(1).float()
    print(f"hair sss terrain worklists (camera rays): surviving boxes per "
          f"block mean {float(boxes.mean()):.1f} max {int(boxes.max())} of "
          f"{vote.shape[1]}, dense-walk blocks {int((n_eff > TT.MAXS).sum())} "
          f"of {vote.shape[0]} [{card}]", flush=True)
    return boxes


class _Stop(Exception):
    pass


def _record_step_calls(r, module, name):
    """The inputs of every call of `module`.`name` (intersect_fused or
    intersect_twolevel, as render/intersect.py calls it) in the first
    bounce step of r's iteration 1, and which of them the SSS block made
    (its 4 probe calls, the exit vertex's shadow and BSDF-MIS rays); the
    iteration is stopped after that step."""
    from statmc_tpu_torch.render import integrator as TI
    from statmc_tpu_torch.render import sss as SSS

    calls, in_sss = [], [False]
    call, step = getattr(module, name), TI._bounce_step

    def record(acc, o, d, t_max):
        calls.append((acc, o.clone(), d.clone(), t_max.clone(), in_sss[0]))
        return call(acc, o, d, t_max)

    def sss(fn):
        def wrapped(*a, **k):
            in_sss[0] = True
            try:
                return fn(*a, **k)
            finally:
                in_sss[0] = False
        return wrapped

    def first_step(*a, **k):
        step(*a, **k)
        raise _Stop()

    with _patched((module, name, record), (TI, "_bounce_step", first_step),
                  (SSS, "sample_sp", sss(SSS.sample_sp)),
                  (SSS, "estimate_direct_sw", sss(SSS.estimate_direct_sw))):
        try:
            r.run_iteration(1)
        except _Stop:
            pass
    return calls


def phase_sss_probe_calls(card, rs, rt):
    """The kernels on the inputs of every intersect call of one bounce
    step of each full-width hair + SSS render (rs the staircase's, rt the
    terrain's renderer), bit for bit: B1 on the staircase's calls; on the
    terrain's, B3's votes on every block and B4's (t, id) on every block
    that holds a live ray.  The SSS block's calls have few live rays,
    starting just inside a surface with short t_max; they are held on all
    their rays.  A staircase call the SSS block did not make (each of
    921,600 rays) is held on PROBE_PLAIN_RAYS of them, and B4 on SUBSET
    blocks of such a terrain call.
    Returns the calls checked per configuration."""
    import torch

    from statmc_tpu_torch.accel import twolevel as TT
    from statmc_tpu_torch.render import intersect as TX

    out = {}
    calls = _record_step_calls(rs, TX, "intersect_fused")
    sss = [c for c in calls if c[4]]
    rest = [c for c in calls if not c[4]]
    _b1_on_calls([c[:4] for c in sss])
    _b1_on_calls([c[:4] for c in rest], max_plain=PROBE_PLAIN_RAYS)
    n_calls = len(calls)
    lives = [int((c[3] > 0).sum()) for c in sss]
    sizes = [c[1].shape[0] for c in sss]
    tmax = max(float(c[3][c[3] > 0].max()) for c in sss[:PROBE_STEPS]
               if (c[3] > 0).any())
    if len(sss) < 6 or max(lives) <= 0:
        raise AssertionError(f"SSS probe calls (staircase): {len(sss)} SSS "
                             f"calls, live rays {lives}")
    print(f"SSS probe calls, staircase: B1 bit-identical to plain on the "
          f"{n_calls} intersect calls of one bounce step: the SSS block's "
          f"{len(sss)} calls on all their rays ({lives} live rays of "
          f"{sizes}; the probes' t_max <= {tmax:.4f}), the step's other "
          f"{len(rest)} calls of {[c[1].shape[0] for c in rest]} rays on "
          f"{PROBE_PLAIN_RAYS} seeded rays each [{card}]", flush=True)
    out["staircase"] = n_calls

    calls = _record_step_calls(rt, TX, "intersect_twolevel")
    sss_text = []
    for k, (tl, o, d, t_max, in_sss) in enumerate(calls):
        _, o_p, d_p, tm_p = TT.blocks(tl, o, d, t_max)
        rays = TT.slab_rays(o_p, d_p, tm_p)
        vote = TT.cull(tl.bounds, rays)
        if not torch.equal(vote, TT.cull_plain(tl.bounds, rays)):
            raise AssertionError(f"B3 on terrain step call {k}: votes differ")
        order, n_eff, mask = TT.worklists(tl, vote)
        feat = TT.block_features(o_p, d_p)
        tmb = tm_p.reshape(-1, TT.RT_WALK)
        t_k, id_k = TT.walk(tl.table, order, n_eff, mask, feat, tmb,
                            tl.fsub, tl.packed)
        # Every live block of the SSS block's calls; SUBSET blocks of the
        # others (phase B3/B4 holds those rays' kind on whole sets).
        sub = torch.nonzero((tmb > 0).any(1))[:, 0]
        if not in_sss and sub.numel() > SUBSET:
            sub = _pick_blocks(n_eff, tmb.shape[0])
        if sub.numel():
            t_p, id_p = TT.walk_plain(tl.table, order[sub], n_eff[sub],
                                      mask[sub], feat[sub], tmb[sub],
                                      tl.fsub)
            if not (torch.equal(id_p, id_k[sub]) and torch.equal(
                    t_p.view(torch.int32), t_k[sub].view(torch.int32))):
                raise AssertionError(f"B4 on terrain step call {k}: (t, id) "
                                     "differ")
        if in_sss:
            boxes = vote[sub].sum(1).float() if sub.numel() else vote[:1, 0]
            sss_text.append(
                f"{int((t_max > 0).sum())} live in {sub.numel()} blocks, "
                f"boxes/block {float(boxes.mean()):.1f}, dense "
                f"{int((n_eff[sub] > TT.MAXS).sum())}")
    if len(sss_text) < 6:
        raise AssertionError(f"SSS probe calls (terrain): {len(sss_text)} "
                             "SSS calls")
    print(f"SSS probe calls, terrain: B3 votes on every block and B4 (t, id)"
          f" bit-identical to plain on all {len(calls)} intersect calls of "
          f"one bounce step (B4 on every block with a live ray of the SSS "
          f"block's calls, on {SUBSET} blocks of the others); the SSS "
          f"block's calls: " + "; ".join(sss_text) + f" [{card}]",
          flush=True)
    out["terrain"] = len(calls)
    return out


def phase_hair_sss_profile(card, r, render_s, plain):
    """One sample of the hair + SSS staircase (of iteration 2's
    FEATURE_SPP; cut from the whole iteration to make room for the
    albedo-LUT phase) under torch.profiler: kernels, device ms and busy
    share of a sample's part of the unprofiled iteration, beside a
    sample's part of the untextured staircase's profiled iteration
    (plain: {kernels, device_ms, busy}), device ms inside the hair.* and
    sss.* ranges, B1's ms; B2's from the denoise pass profiled on its
    own.  Returns {kernel: device ms}."""
    spp = r.s.ecfg.pixel_samples
    t0 = time.perf_counter()
    _, groups, launches, stages, read_s = _profile(lambda: _one_sample(r))
    profiled_s = time.perf_counter() - t0 - read_s
    den = _profile_denoise(r)
    total = sum(ms for ms, _ in groups.values())
    kernels = sum(n for _, n in groups.values())
    names = ("hair.eval_f", "hair.sample_wi", "sss.sample_sp", "sss.probe",
             "sss.direct")
    rng = {k: stages.get(k, [0, 0.0, 0.0]) for k in names}
    print(f"hair sss profile: 1 of the staircase's {spp} samples, "
          f"{profiled_s:.3f} s profiled, trace read in {read_s:.1f} s; "
          f"device time {total:.1f} ms in {kernels} kernels ({launches} "
          f"launched through the runtime), busy "
          f"{total / 1e3 / (render_s / spp):.3f} of a sample's share of the "
          f"unprofiled {render_s:.3f} s (untextured staircase, a sample of "
          f"its {SPP}: {plain['device_ms'] / SPP:.1f} ms in "
          f"{plain['kernels'] / SPP:.0f} kernels, busy {plain['busy']:.3f}); "
          + ", ".join(f"{k} {v[0]} calls, {v[2]:.1f} ms device "
                      f"({v[2] / max(total, 1e-9):.3f}) / {v[1]:.1f} ms host"
                      for k, v in rng.items())
          + "; " + ", ".join(f"{g} {ms:.1f} ms ({n})"
                             for g, (ms, n) in groups.items() if n)
          + f"; B2 in the denoise pass {den['B2'][0]:.1f} ms [{card}]",
          flush=True)
    if any(v[0] <= 0 or v[2] <= 0 for v in rng.values()) \
            or groups["B1"][1] <= 0:
        raise AssertionError("hair sss profile: a hair/SSS range without "
                             "device time, or no B1, in the trace")
    return {"B1": groups["B1"][0], "B2": den["B2"][0]}


def phase_hair_sss_terrain_profile(card, r):
    """The hair + SSS terrain's iteration once more under torch.profiler,
    device activity only: {kernel: device ms}."""
    _, groups, _, _, _ = _profile(lambda: r.run_iteration(1), host=False)
    print("hair sss terrain profile (device only): " + ", ".join(
        f"{g} {ms:.1f} ms ({n})" for g, (ms, n) in groups.items() if n)
        + f" [{card}]", flush=True)
    return {k: groups[k][0] for k in ("B2", "B3", "B4")}


def hair_sss_small():
    """The hair + SSS staircase at 32x24 (a 128-curve tuft; fused path,
    B1 and B2)."""
    from statmc_tpu_torch.testscenes import hair_sss_scene_text

    return hair_sss_scene_text(width=SMALL_W, height=SMALL_H, spp=2,
                               iterations=2, maxdepth=4, filterradius=2,
                               curves=HAIR_SMALL_CURVES, seed=SEED)


# ---------------------------------------------------------------------------
# volpath with participating media and the Fourier BSDF

VOLPATH_GRID = 128  # the full-width smoke's density grid per side
# The volpath staircase's samples a pixel: cut from SPP (4) to 1 to keep
# the whole run inside its time limit once the realistic, kd-tree, ao
# and sppm phases joined it (its per-sample driver's rays/s does not
# depend on the count; its kernels an iteration fall to a quarter).
VOLPATH_SPP = 1
FOURIER_SHARE = 0.05  # first-hit share that the Fourier materials reach
VOLPATH_TERRAIN_N = 96  # the two-level volpath terrain's heightfield side


def _volpath_text(tmp, width=WIDTH, height=HEIGHT, **kw):
    """The full-width volpath staircase (a haze, a 128^3 smoke behind a
    null box, Fourier spheres and boxes) at the untextured staircase's
    settings, one iteration, denoised; its .bsdf tables written into
    tmp."""
    from statmc_tpu_torch.testscenes import volpath_scene_text

    kw = {**dict(spp=VOLPATH_SPP, iterations=1, maxdepth=MAXDEPTH,
                 grid=VOLPATH_GRID, filterradius=RADIUS, seed=SEED), **kw}
    return volpath_scene_text(tmp, width=width, height=height, **kw)


def _fourier_first_hits(r):
    """The share of the camera rays' first hits (pixel centres) on a
    Fourier material."""
    import torch

    from statmc_tpu_torch.render import camera as CAM
    from statmc_tpu_torch.render.intersect import intersect_scene
    from statmc_tpu_torch.scene import build as sb

    s = r.s
    P = s.width * s.height
    ids = torch.arange(P, device=s.device)
    pxy = torch.stack([(ids % s.width).float() + 0.5,
                       (ids // s.width).float() + 0.5], -1)
    o, d = CAM.generate_rays(s.cam, pxy)
    hit = intersect_scene(s.scene, o, d,
                          torch.full((P,), 1e30, device=s.device), s.bvh)
    mt = torch.where(hit.found, s.scene.mat_type[hit.mat_id.long()], -1)
    return float((mt == sb.MAT_FOURIER).float().mean())


def _volpath_stats(stats, K):
    """A text and {paths, scattered, in_grid, tracking} of the records
    render/volume.py's track_stats gathered over a render: per bounce
    step (summed over its samples) the lanes it ran on, its intersect
    calls (the camera path's and every walk segment's), the walks'
    segments against K, the lanes that entered delta and ratio tracking;
    and the tracking loops' iterations (mean, max) against their caps."""
    from statmc_tpu_torch.render import volume as TV

    steps, paths = {}, [0, 0, 0]
    its = {"delta": [], "ratio": []}
    cur = None
    for rec in stats:
        kind = rec[0]
        if kind == "step":
            cur = steps.setdefault(rec[2], dict(lanes=0, isect=0, walks=0,
                                                segs=0, max_segs=0,
                                                delta=0, ratio=0))
            cur["lanes"] += rec[1]
            cur["isect"] += 1
        elif kind == "paths":
            paths = [a + b for a, b in zip(paths, rec[1:])]
        elif kind == "walk":
            cur["isect"] += rec[2]
            cur["walks"] += 1
            cur["segs"] += rec[2]
            cur["max_segs"] = max(cur["max_segs"], rec[2])
        else:
            cur[kind] += rec[1]
            its[kind].append(rec[2])
    text = "; ".join(
        f"step {k}: {v['lanes']} lanes, {v['isect']} intersect calls, "
        f"{v['walks']} walks of {v['segs'] / max(v['walks'], 1):.2f} "
        f"segments (max {v['max_segs']} of K = {K}), delta tracking "
        f"{v['delta']} lanes, ratio {v['ratio']}"
        for k, v in sorted(steps.items()))
    caps = {"delta": TV.GRID_SAMPLE_STEPS, "ratio": TV.GRID_TR_STEPS}
    loops = "; ".join(
        f"{k} tracking: {len(v)} loops, iterations mean "
        f"{sum(v) / max(len(v), 1):.2f} max {max(v, default=0)} of "
        f"{caps[k]}" for k, v in its.items())
    return text, loops, dict(paths=paths[0], scattered=paths[1],
                             in_grid=paths[2], loops={k: len(v) for k, v
                                                      in its.items()})


def phase_volpath(card, plain_s, plain_rays):
    """load(the full-width volpath staircase).render() on the card: B1
    and B2 launched (every count set to 0 just before the render and
    read just after), every buffer finite, film and film-f with mean >
    0, Fourier materials on >= FOURIER_SHARE of the first hits, some
    camera paths with a medium vertex and some in the smoke; rays/s
    beside the untextured staircase's (plain_s, plain_rays: its last
    iteration in this run), peak device memory and the tracking records
    (_volpath_stats).  Returns (renderer, launches, log, rays/s)."""
    import numpy as np
    import torch

    from statmc_tpu_torch.accel import fused as F
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.render import volume as TV

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = _write_scene(tmp, "volpath.pbrt", _volpath_text(tmp))
        text_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = load(path, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    s = r.s
    if not (isinstance(s.bvh, F.FusedTris) and s.icfg.volumetric
            and s.icfg.has_grid_media and s.scene.fourier is not None
            and s.icfg.null_extra == 8):
        raise AssertionError(f"volpath: {type(s.bvh).__name__}, volumetric "
                             f"{s.icfg.volumetric}, grid "
                             f"{s.icfg.has_grid_media}, null_extra "
                             f"{s.icfg.null_extra}")
    r.progress = False
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    stats = []
    with _patched((TV, "track_stats", stats)):
        _zero_counts()
        logs = r.render(verbose=False)
        torch.cuda.synchronize()
        launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() - held
    bufs = r.buffers()
    bad = [k for k, v in bufs.items() if not np.isfinite(v).all()]
    if bad or min(bufs["film"].mean(), bufs["film-f"].mean()) <= 0:
        raise AssertionError(f"volpath: buffers not finite {bad}, or film "
                             "mean not > 0")
    if min(launches["B1"], launches["B2"]) <= 0:
        raise AssertionError(f"volpath launch counts {launches}")
    fourier = _fourier_first_hits(r)
    text, loops, summary = _volpath_stats(stats, 1 + s.icfg.null_extra)
    scat = summary["scattered"] / max(summary["paths"], 1)
    smoke = summary["in_grid"] / max(summary["paths"], 1)
    if fourier < FOURIER_SHARE or scat < 0.05 or smoke <= 0 \
            or min(summary["loops"].values()) <= 0:
        raise AssertionError(f"volpath: Fourier first hits {fourier:.4f}, "
                             f"paths with a medium vertex {scat:.4f}, in "
                             f"the smoke {smoke:.4f}, loops "
                             f"{summary['loops']}")
    log = logs[-1]
    rate = log["rays_total"] / log["render_s"]
    plain = plain_rays / plain_s
    print(f"volpath: {s.bvh.n_tris} tris, {WIDTH}x{HEIGHT}, {VOLPATH_SPP} spp, "
          f"maxdepth {MAXDEPTH}, {VOLPATH_GRID}^3 smoke; scene text "
          f"{text_s:.1f} s, setup {setup_s:.1f} s; {log['rays_total']:.0f} "
          f"rays in {log['render_s']:.3f} s = {rate:.1f} rays/s (untextured "
          f"staircase in this run: {plain:.1f} rays/s, ratio "
          f"{rate / plain:.3f}), denoise {log['denoise_s'] * 1e3:.1f} ms, "
          f"peak memory {peak / 2**30:.2f} GiB; camera paths with a medium "
          f"vertex {scat:.4f}, that entered the smoke {smoke:.4f} (of "
          f"{summary['paths']}); Fourier first hits {fourier:.4f}; film "
          f"mean {bufs['film'].mean():.5f}; launches {launches} [{card}]",
          flush=True)
    print(f"volpath steps: {text} [{card}]", flush=True)
    print(f"volpath loops: {loops} [{card}]", flush=True)
    return r, launches, log, rate


def _one_sample(r):
    """One sample per pixel from sample 0 through r's chunk function, on
    its states, film and counters (the realistic staircase's profiled
    sample)."""
    r.film_sum.zero_()
    r.film_w.zero_()
    return r.chunk_fn(r.states, r.film_sum, r.film_w, r.ray_total, r.stats,
                      r.base_key, 0, r.avg_ls, r.win_b, r.win_l, False, 1)


def phase_volpath_profile(card, r, render_s, plain):
    """The volpath iteration (VOLPATH_SPP = 1 sample) once more under
    torch.profiler, host and device: kernels, device ms by kernel (B1's
    and B2's with their launches) and busy share of the unprofiled
    render_s, beside the untextured staircase's iteration (plain:
    {kernels, device_ms, busy}), and the device ms inside the volume.*
    and fourier.* ranges as shares of the iteration's device time.
    Returns {kernel: device ms of the iteration}."""
    import torch

    _, whole, launches, stages, read_s = _profile(lambda: r.run_iteration(1))
    total = sum(ms for ms, _ in whole.values())
    kernels = sum(n for _, n in whole.values())
    names = sorted(k for k in stages if k.startswith(("volume.",
                                                      "fourier.")))
    print(f"volpath profile: the iteration ({VOLPATH_SPP} spp, {WIDTH}x"
          f"{HEIGHT}, host and device, trace read in {read_s:.1f} s): "
          f"device time {total:.1f} ms in {kernels} kernels ({launches} "
          f"launched through the runtime), busy {total / 1e3 / render_s:.3f}"
          f" of the unprofiled {render_s:.3f} s (untextured staircase "
          f"iteration: {plain['device_ms']:.1f} ms in {plain['kernels']} "
          f"kernels, busy {plain['busy']:.3f}); " + ", ".join(
              f"{g} {ms:.1f} ms ({n})" for g, (ms, n) in whole.items() if n)
          + "; " + ", ".join(
              f"{k} {stages[k][0]} calls, {stages[k][2]:.1f} ms device "
              f"({stages[k][2] / max(total, 1e-9):.3f} of the iteration's) "
              f"/ {stages[k][1]:.1f} ms host" for k in names)
          + f" [{card}]", flush=True)
    if whole["B1"][1] <= 0 or whole["B2"][1] <= 0 or not any(
            stages[k][2] > 0 for k in names if k.startswith("volume.")) \
            or not any(stages[k][2] > 0 for k in names
                       if k.startswith("fourier.")):
        raise AssertionError("volpath profile: no B1, no B2, or a volume.* "
                             "or fourier.* range without device time")
    torch.cuda.synchronize()
    return {"B1": whole["B1"][0], "B2": whole["B2"][0]}


def _record_volpath_step(r, module, name):
    """The inputs of every call of `module`.`name` (intersect_fused or
    intersect_twolevel) in the first bounce step of r's iteration 1, and
    whether a transmittance walk made it; the iteration is stopped after
    that step."""
    from statmc_tpu_torch.render import volume as TV

    calls, in_walk = [], [False]
    call, step, walk = getattr(module, name), TV._volpath_step, \
        TV.transmittance_walk

    def record(acc, o, d, t_max):
        calls.append((acc, o.clone(), d.clone(), t_max.clone(), in_walk[0]))
        return call(acc, o, d, t_max)

    def walking(*a, **k):
        in_walk[0] = True
        try:
            return walk(*a, **k)
        finally:
            in_walk[0] = False

    def first_step(*a, **k):
        step(*a, **k)
        raise _Stop()

    with _patched((module, name, record), (TV, "_volpath_step", first_step),
                  (TV, "transmittance_walk", walking)):
        try:
            r.run_iteration(1)
        except _Stop:
            pass
    return calls


def phase_volpath_walk_calls(card, r):
    """B1 against its plain version, bit for bit, on the inputs of every
    intersect call of the volpath render's first bounce step: the walks'
    calls (shadow, phase-MIS and BSDF-MIS rays, each segment across a
    null boundary) on all their rays, the camera path's call on
    PROBE_PLAIN_RAYS seeded rays.  Returns the calls checked."""
    from statmc_tpu_torch.render import intersect as TX

    calls = _record_volpath_step(r, TX, "intersect_fused")
    walks = [c[:4] for c in calls if c[4]]
    rest = [c[:4] for c in calls if not c[4]]
    if len(walks) < 4 or not rest:
        raise AssertionError(f"volpath walk calls: {len(walks)} walk calls, "
                             f"{len(rest)} others")
    n, lo, hi, _ = _b1_on_calls(walks)
    _b1_on_calls(rest, max_plain=PROBE_PLAIN_RAYS)
    print(f"volpath walk calls: B1 bit-identical to plain on the {len(calls)}"
          f" intersect calls of one bounce step: the walks' {n} calls on all "
          f"their {walks[0][1].shape[0]} rays ({lo}-{hi} live), the camera "
          f"path's {len(rest)} call(s) on {PROBE_PLAIN_RAYS} seeded rays "
          f"[{card}]", flush=True)
    return len(calls)


def volpath_small(tmp):
    """The volpath staircase at 32x24 (a 16^3 smoke, 2 spp, 2 iterations,
    maxdepth 4, as the other small scenes), its tables written into tmp
    (fused path, B1 and B2)."""
    return _volpath_text(tmp, width=SMALL_W, height=SMALL_H, spp=2,
                         iterations=2, maxdepth=4, grid=16, filterradius=2)


def phase_volpath_twolevel(card):
    """The volpath terrain (haze and a null-bounded 16^3 smoke) at n = 96
    (19,566 triangles with the smoke box, two-level) and 64x36, 1 spp (a
    bounce step's ~50,000 launches do not shrink with the image), on the
    card: B3 and
    B4 launched in its render (counts set to 0 just before, read just
    after), the film finite with mean > 0; then B3's votes on every
    block and B4's (t, id) on every block with a live ray, against their
    plain versions bit for bit, on every intersect call of its first
    bounce step (the walks' included); that iteration's device time by
    kernel (profiled, device only).  Returns (launches, {kernel: ms})."""
    import numpy as np
    import torch

    from statmc_tpu_torch.accel import twolevel as TT
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.render import intersect as TX
    from statmc_tpu_torch.testscenes import volpath_terrain_text

    with tempfile.TemporaryDirectory() as tmp:
        path = _write_scene(tmp, "volpath-terrain.pbrt", volpath_terrain_text(
            width=64, height=36, spp=1, iterations=1, maxdepth=MAXDEPTH,
            n=VOLPATH_TERRAIN_N, grid=16, denoise=False, seed=SEED))
        r = load(path, device="cuda")
    if not (isinstance(r.s.bvh, TT.TwoLevelTris) and r.s.icfg.volumetric):
        raise AssertionError(f"volpath two-level: {type(r.s.bvh).__name__}")
    r.progress = False
    _zero_counts()
    log = r.render(verbose=False)[-1]
    torch.cuda.synchronize()
    launches = _read_counts()
    film = r.film_mean.cpu().numpy()
    if min(launches["B3"], launches["B4"]) <= 0 or not (
            np.isfinite(film).all() and film.mean() > 0):
        raise AssertionError(f"volpath two-level: launches {launches}, film "
                             f"mean {film.mean()}")
    calls = _record_volpath_step(r, TX, "intersect_twolevel")
    walk_calls, blocks = 0, 0
    for k, (tl, o, d, t_max, in_walk) in enumerate(calls):
        _, o_p, d_p, tm_p = TT.blocks(tl, o, d, t_max)
        rays = TT.slab_rays(o_p, d_p, tm_p)
        vote = TT.cull(tl.bounds, rays)
        if not torch.equal(vote, TT.cull_plain(tl.bounds, rays)):
            raise AssertionError(f"B3 on volpath terrain call {k}: votes "
                                 "differ")
        order, n_eff, mask = TT.worklists(tl, vote)
        feat = TT.block_features(o_p, d_p)
        tmb = tm_p.reshape(-1, TT.RT_WALK)
        t_k, id_k = TT.walk(tl.table, order, n_eff, mask, feat, tmb,
                            tl.fsub, tl.packed)
        sub = torch.nonzero((tmb > 0).any(1))[:, 0]
        if sub.numel():
            t_p, id_p = TT.walk_plain(tl.table, order[sub], n_eff[sub],
                                      mask[sub], feat[sub], tmb[sub],
                                      tl.fsub)
            if not (torch.equal(id_p, id_k[sub]) and torch.equal(
                    t_p.view(torch.int32), t_k[sub].view(torch.int32))):
                raise AssertionError(f"B4 on volpath terrain call {k}: "
                                     "(t, id) differ")
        walk_calls += in_walk
        blocks += sub.numel()
    if walk_calls < 4:
        raise AssertionError(f"volpath two-level: {walk_calls} walk calls")
    _, groups, _, _, _ = _profile(lambda: r.run_iteration(1), host=False)
    print(f"volpath two-level: {r.s.bvh.n_tris} tris, 64x36, 1 spp, "
          f"{log['rays_total']:.0f} rays in {log['render_s']:.3f} s, film "
          f"mean {film.mean():.5f}, launches {launches}; B3 votes on every "
          f"block and B4 (t, id) on the {blocks} blocks with a live ray "
          f"bit-identical to plain on all {len(calls)} intersect calls of "
          f"one bounce step ({walk_calls} of them the walks'); profiled "
          f"iteration (device only): " + ", ".join(
              f"{g} {ms:.1f} ms ({n})" for g, (ms, n) in groups.items() if n)
          + f" [{card}]", flush=True)
    return launches, {k: groups[k][0] for k in ("B3", "B4")}


# ---------------------------------------------------------------------------
# The realistic camera, the kd-tree and the ao / sppm integrators.

LENS = os.path.join(REPO, "tests", "fixtures", "biconvex.dat")
AO_SAMPLES = 64  # occlusion probes a camera sample (the JAX default)
AO_TERRAIN_SPP = 1
SPPM_MAXDEPTH, SPPM_RADIUS = 5, 0.05
# The small card-against-CPU sppm staircase: one photon a pixel is 4,096
# photons at 32x24, so its radius is wider to gather some.
SPPM_SMALL_RADIUS = 0.3


def _new_path(card, name, text, need=(), never=(), iterations=None):
    """load(text).render() on the card with every launch count set to 0
    just before the render and read just after: the kernels in `need`
    must launch, those in `never` must not; every buffer finite and the
    film's mean > 0.  Returns (renderer, logs, launches, setup s, peak
    device memory in GiB)."""
    import numpy as np
    import torch

    from statmc_tpu_torch.driver import load

    with tempfile.TemporaryDirectory() as tmp:
        path = _write_scene(tmp, f"{name}.pbrt", text)
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        r = load(path, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    r.progress = False
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    logs = r.render(iterations=iterations, verbose=False)
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    bufs = r.buffers()
    bad = [k for k, v in bufs.items() if not np.isfinite(v).all()]
    if bad or bufs["film"].mean() <= 0:
        raise AssertionError(f"{name}: buffers not finite {bad}, or film "
                             "mean not > 0")
    if any(launches[k] <= 0 for k in need) or any(launches[k] for k in never):
        raise AssertionError(f"{name}: launches {launches}, must launch "
                             f"{need}, must not launch {never}")
    return r, logs, launches, setup_s, peak


def _device_profile(fn):
    """fn() under torch.profiler, device only: (kernels, device ms,
    {B1..B4: device ms}, s to read the trace)."""
    _, groups, _, _, read_s = _profile(fn, host=False)
    return (sum(n for _, n in groups.values()),
            sum(ms for ms, _ in groups.values()),
            {k: groups[k][0] for k in KERNEL_NAMES if groups[k][1]}, read_s)


def _rate_text(log, rays, plain, what):
    rate = rays / log["render_s"]
    return rate, (f"{rays:.0f} rays in {log['render_s']:.3f} s = {rate:.1f} "
                  f"rays/s ({what} in this run: {plain:.1f} rays/s, ratio "
                  f"{rate / plain:.3f})")


def phase_realistic(card, plain_s, plain_rays):
    """The staircase through Camera "realistic" (tests/fixtures/
    biconvex.dat, focused on the stairs) at the main path's settings (4
    spp, 2 iterations, maxdepth 8, denoised): B1 and B2 launch; the share
    of camera rays the lens lets through; rays/s beside the staircase's;
    (phase_new_profiles profiles one sample.)  Returns (renderer,
    launches, render s, rays/s, alive share)."""
    import torch

    from statmc_tpu_torch.core import rng as crng
    from statmc_tpu_torch.render import camera as CAM
    from statmc_tpu_torch.testscenes import realistic_scene_text

    r, logs, launches, setup_s, peak = _new_path(
        card, "realistic", realistic_scene_text(
            LENS, width=WIDTH, height=HEIGHT, spp=SPP, iterations=2,
            maxdepth=MAXDEPTH, denoise=True, filterradius=RADIUS),
        need=("B1", "B2"))
    s = r.s
    if s.cam.lens is None or not r.chunk_fn.__qualname__.startswith(
            "make_chunk_fn"):
        raise AssertionError("realistic: no lens, or not the per-sample "
                             "driver")
    # The camera rays of sample 0, with the render's own draws.
    ids = torch.arange(r.P, dtype=torch.int32, device="cuda")
    keys = crng.pixel_keys(r.base_key, ids, 0)
    pxy = torch.stack([(ids % s.width).float(), (ids // s.width).float()],
                      -1)
    _, _, w = CAM.generate_rays_weighted(
        s.cam, pxy + crng.uniform_2d(keys, 0, crng.SLOT_CAMERA),
        crng.uniform_2d(keys, 0, crng.SLOT_LENS))
    alive = float((w > 0).float().mean())
    if not 0.05 < alive <= 1.0:
        raise AssertionError(f"realistic: alive share {alive}")
    log = logs[-1]
    rays = log["rays_total"] - logs[0]["rays_total"]
    rate, text = _rate_text(log, rays, plain_rays / plain_s,
                            "staircase iteration 2")
    print(f"realistic: {s.width}x{s.height}, {SPP} spp, 2 iterations, "
          f"maxdepth {MAXDEPTH}, lens {os.path.basename(LENS)} (rear z "
          f"{s.cam.lens.rear_z:.5f} m after focus); setup {setup_s:.1f} s "
          f"(lens system and pupil bounds included); iteration 2: {text}; "
          f"camera rays alive {alive:.4f}; peak memory {peak:.2f} GiB; film "
          f"mean {r.buffers()['film'].mean():.5f}; launches {launches} "
          f"[{card}]", flush=True)
    return r, launches, log["render_s"], rate, alive


def phase_kdtree(card, plain_s, plain_rays):
    """The staircase under `Accelerator "kdtree"` (KDTREE_SPP spp, 1
    iteration, maxdepth 8, denoised): B2 launches and B1 never; the SAH
    build's seconds, nodes, depth and widest leaf; the walk's steps a call
    (mean, max) against its cap and lane-steps a ray (kdtree.walk_stats);
    rays/s beside the staircase's.  Returns (renderer, launches, render
    s, rays/s, walk summary)."""
    from statmc_tpu_torch.accel import kdtree as KD
    from statmc_tpu_torch.testscenes import kdtree_scene_text

    build = {}
    real_build = KD.build_kdtree

    def timed_build(*a, **k):
        t0 = time.perf_counter()
        out = real_build(*a, **k)
        build["s"] = time.perf_counter() - t0
        return out

    walks = []
    with _patched((KD, "build_kdtree", timed_build), (KD, "walk_stats",
                                                      walks)):
        r, logs, launches, setup_s, peak = _new_path(
            card, "kdtree", kdtree_scene_text(
                width=WIDTH, height=HEIGHT, spp=KDTREE_SPP, iterations=1,
                maxdepth=MAXDEPTH, denoise=True, filterradius=RADIUS),
            need=("B2",), never=("B1",))
    kd = r.s.bvh
    if not isinstance(kd, KD.KdTreeTris) or not walks:
        raise AssertionError("kdtree: not the kd walk")
    steps = [w["steps"] for w in walks]
    walk = {"calls": len(walks), "mean_steps": sum(steps) / len(steps),
            "max_steps": max(steps), "cap": walks[0]["cap"],
            "lane_steps_per_ray": sum(w["lane_steps"] for w in walks)
            / max(sum(w["rays"] for w in walks), 1),
            "build_s": build["s"], "nodes": kd.n_nodes, "depth": kd.depth(),
            "max_leaf": kd.max_leaf}
    if walk["max_steps"] >= walk["cap"]:
        raise AssertionError(f"kdtree: a walk reached its cap {walk}")
    log = logs[-1]
    rate, text = _rate_text(log, log["rays_total"], plain_rays / plain_s,
                            "staircase iteration 2")
    print(f"kdtree: {kd.tri_p0.shape[0]} tris, SAH build {build['s']:.1f} s "
          f"({kd.n_nodes} nodes, depth {walk['depth']}, widest leaf "
          f"{kd.max_leaf}), setup {setup_s:.1f} s; {WIDTH}x{HEIGHT}, "
          f"{KDTREE_SPP} spp, maxdepth {MAXDEPTH}: {text}; denoise "
          f"{log['denoise_s'] * 1e3:.1f} ms; walk: {len(walks)} calls, "
          f"{walk['mean_steps']:.1f} steps a call on average, "
          f"{walk['max_steps']} at most, cap {walk['cap']}, "
          f"{walk['lane_steps_per_ray']:.2f} steps a ray; peak memory "
          f"{peak:.2f} GiB; film mean {r.buffers()['film'].mean():.5f}; "
          f"launches {launches} [{card}]", flush=True)
    return r, launches, log["render_s"], rate, walk


def phase_ao(card, which, plain_s, plain_rays):
    """Integrator "ao" (64 cosine probes a camera sample) on the
    staircase (4 spp; B1 launches) or the terrain (1 spp; B3 and B4
    launch): rays/s beside the statpath scene's.  Returns (renderer,
    launches, render s, rays/s)."""
    from statmc_tpu_torch.testscenes import ao_scene_text

    terrain = which == "terrain"
    spp = AO_TERRAIN_SPP if terrain else SPP
    r, logs, launches, setup_s, peak = _new_path(
        card, f"ao-{which}", ao_scene_text(
            nsamples=AO_SAMPLES, cossample=True, terrain=terrain,
            width=WIDTH, height=HEIGHT, spp=spp),
        need=("B3", "B4") if terrain else ("B1",))
    log = logs[-1]
    rate, text = _rate_text(log, log["rays_total"], plain_rays / plain_s,
                            f"statpath {which}")
    film = r.buffers()["film"]
    print(f"ao {which}: {WIDTH}x{HEIGHT}, {spp} spp x {AO_SAMPLES} cosine "
          f"probes, setup {setup_s:.1f} s; {text}; peak memory {peak:.2f} "
          f"GiB; film mean {film.mean():.5f}; launches {launches} [{card}]",
          flush=True)
    return r, launches, log["render_s"], rate


def _sppm_pass(r, i):
    """Pass i of r with the deposit's records and the visible points
    counted: (log, per-deposit stats, visible points)."""
    from statmc_tpu_torch.render import sppm as SP

    deps, vps = [], []
    real = SP.SPPMRenderer.camera_pass

    def counted(self, key):
        c = real(self, key)
        vps.append(int(c["have"].sum()))
        return c

    with _patched((SP, "deposit_stats", deps),
                  (SP.SPPMRenderer, "camera_pass", counted)):
        log = r.run_iteration(i)
    return log, deps, vps[0]


def phase_sppm(card, plain_s, plain_rays):
    """Integrator "sppm" on the staircase: maxdepth 5, one photon a pixel
    (921,600 a pass), radius 0.05, 2 passes; B1 launches.  Per pass the
    candidate pairs the grid tested and the pairs it kept, photons per
    visible point, the radius's shrink, and pass 1 run twice (a second
    renderer) equal bit for bit; rays/s (the JAX package's count:
    photons x maxdepth + 2 P a pass) beside the staircase's.  Returns
    (renderer, launches, pass 2's render s, rays/s, summary)."""
    import numpy as np
    import torch

    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.testscenes import sppm_scene_text

    text = sppm_scene_text(maxdepth=SPPM_MAXDEPTH, radius=SPPM_RADIUS,
                           iterations=2, width=WIDTH, height=HEIGHT, spp=1,
                           denoise=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = _write_scene(tmp, "sppm.pbrt", text)
        t0 = time.perf_counter()
        r = load(path, device="cuda")
        twin = load(path, device="cuda")
        setup_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    passes = []
    r0 = float(r.radius.mean())
    for i in (1, 2):
        log, deps, n_vp = _sppm_pass(r, i)
        passes.append({
            "render_s": log["render_s"], "visible_points": n_vp,
            "vertices": sum(d["vertices"] for d in deps),
            "tested": sum(d["tested"] for d in deps),
            "kept": sum(d["kept"] for d in deps),
            "mean_radius": float(r.radius.mean())})
        if i == 1:
            state1 = [x.clone() for x in (r.radius, r.n_acc, r.tau, r.Ld)]
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    twin.run_iteration(1)
    same = all(torch.equal(a, b) for a, b in zip(
        state1, (twin.radius, twin.n_acc, twin.tau, twin.Ld)))
    film = r.buffers()["film"]
    if not (np.isfinite(film).all() and film.mean() > 0) or not same \
            or launches["B1"] <= 0 or passes[0]["kept"] <= 0:
        raise AssertionError(f"sppm: film mean {film.mean()}, pass 1 twice "
                             f"bit for bit {same}, launches {launches}, "
                             f"passes {passes}")
    for p in passes:
        p["photons_per_vp"] = p["kept"] / max(p["visible_points"], 1)
    rays = r.n_photons * SPPM_MAXDEPTH + 2 * r.P
    rate, rtext = _rate_text({"render_s": passes[1]["render_s"]}, rays,
                             plain_rays / plain_s, "staircase iteration 2")
    summary = {"passes": passes, "radius_0": r0,
               "shrink": passes[1]["mean_radius"] / passes[0]["mean_radius"],
               "bitwise": same}
    print(f"sppm: {WIDTH}x{HEIGHT}, {r.n_photons} photons a pass, maxdepth "
          f"{SPPM_MAXDEPTH}, radius {SPPM_RADIUS}, setup {setup_s:.1f} s; "
          + "; ".join(
              f"pass {i + 1}: {p['render_s']:.3f} s, {p['visible_points']} "
              f"visible points, {p['vertices']} photon vertices deposited, "
              f"{p['tested']} pairs tested, {p['kept']} kept, "
              f"{p['photons_per_vp']:.2f} photons a visible point, mean "
              f"radius {p['mean_radius']:.5f}" for i, p in enumerate(passes))
          + f"; radius shrink pass 1 -> 2 {summary['shrink']:.4f}; pass 1 "
          f"twice bit for bit {same}; pass 2: {rtext} (nominal rays); peak "
          f"memory {peak:.2f} GiB; film mean {film.mean():.5f}; launches "
          f"{launches} [{card}]", flush=True)
    del twin
    return r, launches, passes[1]["render_s"], rate, summary


def phase_new_profiles(card, runs):
    """Each of runs {name: (renderer, iteration, its unprofiled render
    s)} rendered once more under torch.profiler, device only (after every
    unprofiled render of these paths): kernels, device ms, busy share and
    B1-B4's ms.  Iteration None profiles one sample of the iteration,
    beside its share of the render s; a callable is run on the renderer
    (MLT's steps), beside the given s.  Returns {name: {kernel: ms}}."""
    import torch

    out = {}
    for name, (r, i, render_s) in runs.items():
        if i is None:  # one sample of the iteration (the realistic one's)
            what, fn = f"1 of {r.s.ecfg.pixel_samples} samples", _one_sample
            render_s /= r.s.ecfg.pixel_samples
        elif callable(i):  # a few steps (MLT's)
            what, fn = "steps", i
        else:
            what, fn = f"iteration {i}", lambda r: r.run_iteration(i)
        t0 = time.perf_counter()
        kernels, dev_ms, ms, read_s = _device_profile(lambda: fn(r))
        print(f"{name} profile: {what} (device only, "
              f"{time.perf_counter() - t0:.1f} s, of which the trace read "
              f"{read_s:.1f} s): {kernels} kernels, {dev_ms:.1f} ms, busy "
              f"{dev_ms / 1e3 / render_s:.3f} of the unprofiled "
              f"{render_s:.3f} s, " + ", ".join(
                  f"{k} {v:.1f} ms" for k, v in ms.items()) + f" [{card}]",
              flush=True)
        out[name] = dict(ms, kernels=kernels)
        torch.cuda.synchronize()
    return out


def realistic_small():
    from statmc_tpu_torch.testscenes import realistic_scene_text

    return realistic_scene_text(LENS, width=SMALL_W, height=SMALL_H, spp=2,
                                iterations=2, maxdepth=4, filterradius=2)


def kdtree_small():
    from statmc_tpu_torch.testscenes import kdtree_scene_text

    return kdtree_scene_text(width=SMALL_W, height=SMALL_H, spp=2,
                             iterations=2, maxdepth=4, filterradius=2)


def ao_small():
    from statmc_tpu_torch.testscenes import ao_scene_text

    return ao_scene_text(nsamples=16, width=SMALL_W, height=SMALL_H, spp=2,
                         iterations=2)


def sppm_small():
    from statmc_tpu_torch.testscenes import sppm_scene_text

    return sppm_scene_text(maxdepth=SPPM_MAXDEPTH, radius=SPPM_SMALL_RADIUS,
                           iterations=2, width=SMALL_W, height=SMALL_H,
                           spp=1, denoise=False)


def _print_build(cuda_build):
    """What the compiler and the runtime report for kernels B1 and B4:
    ptxas -v (registers, spills, shared memory; only when this process
    ran the build) and resident blocks per SM."""
    for line in (cuda_build.ptxas_log or "").splitlines():
        if any(k in line for k in ("error", "warning", "spill", "Used")):
            print(f"ptxas: {line.strip()}", flush=True)
    for kernel in ("fused_intersect", "twolevel_walk"):
        blocks, regs = cuda_build.occupancy(kernel)
        print(f"occupancy {kernel}: {regs} registers a thread, {blocks} "
              f"blocks of 128 threads resident per SM", flush=True)


# The iteration each new path profiles: sppm's third pass (after the two
# measured); None: one sample, the realistic staircase's (one of its 4
# samples, to make room for the albedo-LUT phase).  The kd-tree is not
# profiled: its one sample's ~1 million eager kernels took ~60 s under the
# profiler, the time that B3's check on every main-path call takes.
_PROFILED = {"realistic": None, "ao_staircase": 1, "ao_terrain": 1,
             "sppm": 3}


def _new_paths(card, phase, stair_s, stair_rays, terrain_s, terrain_rays):
    """The renders of the realistic camera, the kd-tree, ao (staircase and
    terrain) and sppm at full width, unprofiled.  Returns {name: result
    tuple} (each begins with its renderer)."""
    return {
        "realistic": phase("realistic", phase_realistic, card, stair_s,
                           stair_rays),
        "kdtree": phase("kdtree", phase_kdtree, card, stair_s, stair_rays),
        "ao_staircase": phase("ao staircase", phase_ao, card, "staircase",
                              stair_s, stair_rays),
        "ao_terrain": phase("ao terrain", phase_ao, card, "terrain",
                            terrain_s, terrain_rays),
        "sppm": phase("sppm", phase_sppm, card, stair_s, stair_rays)}


def _new_smalls(card, phase):
    """The four small card-against-CPU renders of the new paths."""
    phase("realistic small", phase_small_reference, card, "realistic",
          realistic_small(), SMALL_SHARE, 0.0, ("B1", "B2"))
    phase("kdtree small", phase_small_reference, card, "kdtree",
          kdtree_small(), SMALL_SHARE, 0.0, ("B2",))
    phase("ao small", phase_small_reference, card, "ao", ao_small(),
          SMALL_SHARE, 0.0, ("B1",))
    phase("sppm small", phase_small_reference, card, "sppm", sppm_small(),
          SMALL_SHARE, 0.0, ("B1",))


def _new_results(new, new_ms):
    """The new paths' entries of the workflow line, and per kernel its
    launches and profiled ms on each new path."""
    workflow = {f"{k}_rays_per_s": v[3] for k, v in new.items()}
    workflow.update({"realistic_alive_share": new["realistic"][4],
                     "kdtree_walk": new["kdtree"][4],
                     "sppm": new["sppm"][4],
                     "new_kernels_profiled": {
                         k if _PROFILED[k] else f"{k}_one_sample":
                         v["kernels"] for k, v in new_ms.items() if v}})
    per_kernel = {b: {} for b in KERNEL_NAMES}
    for name, v in new.items():
        for b in KERNEL_NAMES:
            per_kernel[b][f"{name}_launches"] = v[1][b]
            per_kernel[b][f"{name}_main_path_ms"] = new_ms[name].get(b)
    return workflow, per_kernel


BDPT_MAXDEPTH = 5
# The small card-against-CPU MLT renders (maxdepth 3): N_CHAINS and
# N_BOOTSTRAP cut on both sides (8,192 and 65,536 at full width) so that
# the CPU half stays short; MLT_SMALL_STEPS mutation steps after the
# bootstrap.
MLT_SMALL_CHAINS, MLT_SMALL_BOOTSTRAP, MLT_SMALL_STEPS = 512, 1024, 3
MLT_PROFILED_STEPS = 2  # mutation steps under the profiler
# The full-width MLT iteration's mutations a pixel, cut from 1 (113 steps)
# to keep the whole run inside its time limit once B2's other forms joined
# it; steps/s and mutations/s hardly depend on the count.
MLT_PIXEL_SHARE = 0.5


def _bdpt_splats(r, i):
    """Iteration i of the BDPT renderer r with its t = 1 splats recorded:
    (log, splat lanes, distinct splat pixels) summed over the iteration."""
    from statmc_tpu_torch.render import bdpt as BD

    stats = []
    with _patched((BD, "splat_stats", stats)):
        log = r.run_iteration(i)
    return log, sum(x[0] for x in stats), sum(x[1] for x in stats)


def phase_bdpt(card, plain_s, plain_rays):
    """Integrator "bdpt" on the staircase at full width: maxdepth 5, 1
    spp, 2 iterations; B1 launches and B2-B4 do not (counts set to 0 just
    before iteration 1, read just after iteration 2).  Per iteration the
    t = 1 splat lanes and pixels a sample; rays/s (the JAX package's
    nominal count) beside the staircase's; peak memory; the film's mean;
    iteration 1 run twice (a second renderer) equal bit for bit.  Returns
    (renderer, launches, iteration 2's render s, rays/s, summary)."""
    import numpy as np
    import torch

    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.testscenes import bdpt_scene_text

    text = bdpt_scene_text(maxdepth=BDPT_MAXDEPTH, iterations=2,
                           width=WIDTH, height=HEIGHT, spp=1, denoise=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = _write_scene(tmp, "bdpt.pbrt", text)
        t0 = time.perf_counter()
        r = load(path, device="cuda")
        setup_s = time.perf_counter() - t0
        twin = load(path, device="cuda")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    its = []
    for i in (1, 2):
        log, lanes, pixels = _bdpt_splats(r, i)
        its.append({"render_s": log["render_s"], "splat_lanes": lanes,
                    "splat_pixels": pixels})
        if i == 1:
            state1 = (r.film_sum.clone(), r.splat_sum.clone())
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    twin.run_iteration(1)
    same = (torch.equal(state1[0], twin.film_sum)
            and torch.equal(state1[1], twin.splat_sum))
    film = r.buffers()["film"]
    if (not (np.isfinite(film).all() and film.mean() > 0) or not same
            or launches["B1"] <= 0
            or any(launches[k] for k in ("B2", "B3", "B4"))
            or its[0]["splat_lanes"] <= 0):
        raise AssertionError(f"bdpt: film mean {film.mean()}, iteration 1 "
                             f"twice bit for bit {same}, launches "
                             f"{launches}, iterations {its}")
    rays = float(r.ray_total) / 2
    rate, rtext = _rate_text({"render_s": its[1]["render_s"]}, rays,
                             plain_rays / plain_s, "staircase iteration 2")
    summary = {"iterations": its, "peak_gib": peak, "bitwise": same,
               "film_mean": float(film.mean()),
               "strategies": len(r.strategies()) + BDPT_MAXDEPTH}
    print(f"bdpt: {WIDTH}x{HEIGHT}, maxdepth {BDPT_MAXDEPTH}, 1 spp, "
          f"{summary['strategies']} strategies a sample, setup {setup_s:.1f} "
          "s; " + "; ".join(
              f"iteration {i + 1}: {t['render_s']:.3f} s, {t['splat_lanes']}"
              f" splat lanes on {t['splat_pixels']} pixels a sample"
              for i, t in enumerate(its))
          + f"; iteration 2: {rtext} (nominal rays); iteration 1 twice bit "
          f"for bit {same}; peak memory {peak:.2f} GiB; film mean "
          f"{film.mean():.5f}; launches {launches} [{card}]", flush=True)
    del twin
    return r, launches, its[1]["render_s"], rate, summary


def phase_bdpt_terrain(card, plain_s, plain_rays):
    """Integrator "bdpt" on the terrain at full width (maxdepth 5, 1 spp,
    1 iteration): B3 and B4 launch, B1 and B2 do not; rays/s beside the
    statpath terrain's.  Returns (renderer, launches, render s, rays/s)."""
    from statmc_tpu_torch.testscenes import bdpt_scene_text

    r, logs, launches, setup_s, peak = _new_path(
        card, "bdpt-terrain", bdpt_scene_text(
            maxdepth=BDPT_MAXDEPTH, iterations=1, terrain=True, width=WIDTH,
            height=HEIGHT, spp=1),
        need=("B3", "B4"), never=("B1", "B2"))
    log = logs[-1]
    rate, text = _rate_text(log, log["rays_total"], plain_rays / plain_s,
                            "statpath terrain")
    print(f"bdpt terrain: {WIDTH}x{HEIGHT}, maxdepth {BDPT_MAXDEPTH}, 1 spp, "
          f"setup {setup_s:.1f} s; {text} (nominal rays); peak memory "
          f"{peak:.2f} GiB; film mean {r.buffers()['film'].mean():.5f}; "
          f"launches {launches} [{card}]", flush=True)
    return r, launches, log["render_s"], rate


def phase_mlt(card, plain_s, plain_rays):
    """Integrator "mlt" (bidirectional, maxdepth 5) on the staircase at
    full width: the bootstrap (65,536 paths, 8,192 chains seeded), then
    half a mutation a pixel (57 steps of 8,192 chains: the iteration's
    target of mutations cut by MLT_PIXEL_SHARE to keep the whole run
    inside its time limit); B1 launches (counts set to 0 before the
    bootstrap, read after the last step).  b, the
    acceptance rate, the share of large steps, steps a second, mutations
    a second beside the staircase's rays/s, peak memory.  Returns
    (renderer, launches, the steps' s, mutations/s, summary)."""
    import numpy as np
    import torch

    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.render import pssmlt as PM
    from statmc_tpu_torch.testscenes import mlt_scene_text

    text = mlt_scene_text(maxdepth=BDPT_MAXDEPTH, iterations=1, width=WIDTH,
                          height=HEIGHT, spp=1, denoise=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = _write_scene(tmp, "mlt.pbrt", text)
        t0 = time.perf_counter()
        r = load(path, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    r._bootstrap()
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    steps = []
    with _patched((PM, "step_stats", steps),
                  (r, "P", int(r.P * MLT_PIXEL_SHARE))):
        log = r.run_iteration(1)
    launches = _read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    film = r.buffers()["film"]
    n = len(steps)
    C = PM.N_CHAINS
    acc = sum(x["accepted"] for x in steps) / (n * C)
    large = sum(x["large"] for x in steps) / (n * C)
    nonzero = sum(x["proposed_nonzero"] for x in steps) / (n * C)
    if (not (np.isfinite(film).all() and film.mean() > 0) or r.b <= 0
            or launches["B1"] <= 0 or not 0 < acc < 1):
        raise AssertionError(f"mlt: film mean {film.mean()}, b {r.b}, "
                             f"launches {launches}, acceptance {acc}")
    rate, rtext = _rate_text(log, r.n_mut, plain_rays / plain_s,
                             "staircase iteration 2")
    summary = {"b": r.b, "acceptance": acc, "large_share": large,
               "proposed_nonzero": nonzero, "steps": n,
               "steps_per_s": n / log["render_s"], "bootstrap_s": boot_s,
               "dims": r.D, "peak_gib": peak, "film_mean": float(film.mean())}
    print(f"mlt: {WIDTH}x{HEIGHT}, bidirectional, maxdepth {BDPT_MAXDEPTH}, "
          f"{r.D} dims, setup {setup_s:.1f} s; bootstrap "
          f"{PM.N_BOOTSTRAP} paths in {boot_s:.2f} s, b {r.b:.6f}; {n} steps "
          f"of {C} chains in {log['render_s']:.2f} s "
          f"({n / log['render_s']:.2f} steps/s): "
          f"{rtext.replace('rays', 'mutations', 2)}; acceptance "
          f"{acc:.4f}, large steps {large:.4f}, proposals with y > 0 "
          f"{nonzero:.4f}; peak memory {peak:.2f} GiB; film mean "
          f"{film.mean():.5f}; launches {launches} [{card}]", flush=True)
    return r, launches, log["render_s"], rate, summary


def _mlt_steps(r, n):
    """n more mutation steps of the MLT renderer r (a profiled run)."""
    from statmc_tpu_torch.core import rng as crng

    for k in crng.split(crng.fold_in(r.key, 99), n):
        r._chains = r.step(r._chains, k)


def bdpt_small():
    from statmc_tpu_torch.testscenes import bdpt_scene_text

    return bdpt_scene_text(maxdepth=4, iterations=2, width=SMALL_W,
                           height=SMALL_H, spp=1)


def phase_mlt_small(card):
    """MLT at 32x24 (maxdepth 3) on the card and on the CPU, in both
    mutation modes, with N_CHAINS and N_BOOTSTRAP cut to
    MLT_SMALL_CHAINS and MLT_SMALL_BOOTSTRAP on both sides: b within rtol
    1e-4; the bootstrap's chains, the first step's proposals, accepts and
    its splat per pixel (rtol 1e-4) on >= SMALL_SHARE; after
    MLT_SMALL_STEPS steps the share of chains still identical >= 0.9 (an
    ulp of f can flip an accept, and then a chain parts) and the film's
    mean within 2%; B1 launches on the card."""
    import numpy as np
    import torch

    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.render import pssmlt as PM
    from statmc_tpu_torch.testscenes import mlt_scene_text

    out = {}
    for bidi in (True, False):
        text = mlt_scene_text(bidi, maxdepth=3, iterations=1, width=SMALL_W,
                              height=SMALL_H, spp=1, denoise=False)
        runs = {}
        with tempfile.TemporaryDirectory() as tmp, _patched(
                (PM, "N_CHAINS", MLT_SMALL_CHAINS),
                (PM, "N_BOOTSTRAP", MLT_SMALL_BOOTSTRAP)):
            path = _write_scene(tmp, "mlt-small.pbrt", text)
            for dev in ("cuda", "cpu"):
                r = load(path, device=dev)
                if dev == "cuda":
                    _zero_counts()
                r._bootstrap()
                U0 = r._chains[0].cpu()
                props = []
                real_f = r._f
                r._f = lambda U: props.append(U.cpu()) or real_f(U)
                r.run_iteration(1)
                first = ([x.cpu() for x in r._chains], r.splat.cpu().clone())
                for i in range(2, MLT_SMALL_STEPS + 1):
                    r.run_iteration(i)
                if dev == "cuda":
                    launches = _read_counts()
                runs[dev] = {"b": r.b, "U0": U0, "prop": props[0],
                             "first": first, "U": r._chains[0].cpu(),
                             "film": r.film_mean.cpu().numpy()}
        g, c = runs["cuda"], runs["cpu"]
        rows = lambda a, b: float((a == b).all(-1).float().mean())
        acc_g = (g["first"][0][0] == g["prop"]).all(-1)
        acc_c = (c["first"][0][0] == c["prop"]).all(-1)
        close = np.isclose(g["first"][1].numpy(), c["first"][1].numpy(),
                           rtol=1e-4, atol=1e-6).all(-1)
        res = {"b": (g["b"], c["b"]), "seeded": rows(g["U0"], c["U0"]),
               "proposals": rows(g["prop"], c["prop"]),
               "accepts": float((acc_g == acc_c).float().mean()),
               "splat_pixels": float(close.mean()),
               "identical_after": rows(g["U"], c["U"]),
               "film_means": (float(g["film"].mean()),
                              float(c["film"].mean()))}
        bad = (abs(res["b"][0] - res["b"][1]) > 1e-4 * res["b"][1]
               or min(res["seeded"], res["proposals"], res["accepts"],
                      res["splat_pixels"]) < SMALL_SHARE
               or res["identical_after"] < 0.9
               or abs(res["film_means"][0] - res["film_means"][1])
               > 0.02 * res["film_means"][1]
               or not np.isfinite(g["film"]).all() or launches["B1"] <= 0)
        print(f"mlt small, bidirectional {bidi}: {SMALL_W}x{SMALL_H}, "
              f"{MLT_SMALL_CHAINS} chains, {MLT_SMALL_BOOTSTRAP}-path "
              f"bootstrap, card vs cpu: b {res['b'][0]:.7f} vs "
              f"{res['b'][1]:.7f}; seeded chains equal {res['seeded']:.4f}, "
              f"step 1: proposals equal {res['proposals']:.4f}, accepts "
              f"equal {res['accepts']:.4f}, splat pixels within rtol 1e-4 "
              f"{res['splat_pixels']:.4f}; after {MLT_SMALL_STEPS} steps "
              f"{res['identical_after']:.4f} of the chains identical, film "
              f"means {res['film_means'][0]:.6f} vs {res['film_means'][1]:.6f}"
              f"; card launches {launches} [{card}]", flush=True)
        if bad:
            raise AssertionError(f"mlt small, bidirectional {bidi}: {res}")
        out["bidirectional" if bidi else "unidirectional"] = res
    return out


def _bdpt_mlt_paths(card, phase, stair_s, stair_rays, terrain_s,
                    terrain_rays):
    """The bdpt and mlt renders at full width, unprofiled: bdpt on the
    staircase and the terrain, mlt on the staircase."""
    return {
        "bdpt": phase("bdpt", phase_bdpt, card, stair_s, stair_rays),
        "bdpt_terrain": phase("bdpt terrain", phase_bdpt_terrain, card,
                              terrain_s, terrain_rays),
        "mlt": phase("mlt", phase_mlt, card, stair_s, stair_rays)}


def _bdpt_mlt_profiled(runs):
    """phase_new_profiles' entries of the bdpt and mlt paths: BDPT's one sample
    (iteration 3 at 1 spp) on each scene, MLT_PROFILED_STEPS MLT steps
    (against the measured steps' time for as many)."""
    b, bt, m = runs["bdpt"], runs["bdpt_terrain"], runs["mlt"]
    return {"bdpt": (b[0], 3, b[2]), "bdpt_terrain": (bt[0], 2, bt[2]),
            "mlt": (m[0], lambda r: _mlt_steps(r, MLT_PROFILED_STEPS),
                    m[2] * MLT_PROFILED_STEPS / m[4]["steps"])}


def _bdpt_mlt_results(runs, ms):
    """The workflow line's entries of the bdpt and mlt paths, and per
    kernel its launches and profiled ms on each."""
    workflow = {"bdpt_rays_per_s": runs["bdpt"][3],
                "bdpt_terrain_rays_per_s": runs["bdpt_terrain"][3],
                "mlt_mutations_per_s": runs["mlt"][3],
                "bdpt": runs["bdpt"][4], "mlt": runs["mlt"][4],
                "mlt_b": runs["mlt"][4]["b"],
                "mlt_acceptance": runs["mlt"][4]["acceptance"],
                "bdpt_mlt_kernels_profiled": {k: v["kernels"]
                                              for k, v in ms.items()}}
    per_kernel = {b: {} for b in KERNEL_NAMES}
    for name, v in runs.items():
        for b in KERNEL_NAMES:
            per_kernel[b][f"{name}_launches"] = v[1][b]
            per_kernel[b][f"{name}_main_path_ms"] = ms[name].get(b)
    return workflow, per_kernel


# ---------------------------------------------------------------------------
# The mesh (statmc_tpu_torch/parallel/): ranks over torch.distributed.

# Samples a pixel of both mesh phases and of their one-device reference
# (the main path's 4, cut to keep the whole run inside its time limit;
# rays/s hardly depends on the count).
MESH_SPP = 2
# After iteration 2, the share of pixels of film, film-f and the ACRR
# feedback within rtol 1e-4 / atol 1e-5 of the one-device render: an RR
# or ACRR decision may flip on the rounding of Chan's merge against the
# serial Meng update.  The 2x2 mesh's feedback is held to the one-device
# render that took the mesh's iteration-1 feedback (phase_mesh_reference):
# at one or two samples a pixel m3 is 0 but for its rounding, which
# differs between the two updates, and the skew correction turns that
# into other acceptance decisions in iteration 1's denoise.
MESH_SHARE = 0.995
MESH_TIMEOUT = 400  # s: a mesh run that takes longer fails its phase
# The buffers the mesh phases compare: film, film-f, and the Radiance
# counts and denoised means (the ACRR feedback's source).
MESH_REGEX = "film|film-f|t0-b[0-9]+-(n|film-mean-f)"


def _mesh_text():
    from statmc_tpu_torch.testscenes import scene_text

    return scene_text(
        width=WIDTH, height=HEIGHT, spp=MESH_SPP, iterations=2,
        maxdepth=MAXDEPTH, denoise=True, filtersd=10.0, filterradius=RADIUS,
        extra_integrator='"bool acrr" ["true"] "bool smis" ["true"] '
                         f'"string outputregex" ["{MESH_REGEX}"] ')


def _halo_slab(x, lo, hi):
    """Rows [lo, hi) of x, zeros for the rows past its edges."""
    import torch

    H = x.shape[0]
    parts = [x.new_zeros((max(0, -lo), *x.shape[1:])),
             x[max(lo, 0):min(hi, H)],
             x.new_zeros((max(0, hi - H), *x.shape[1:]))]
    return torch.cat(parts).contiguous()


def phase_r1(card):
    """Kernel R1 against its plain version (core/rng.py:site_hash_plain,
    the int64 emulation the port ran before R1) at P = 921,600 lanes (one
    1280x720 wavefront): a 2D draw site (uniform_2d, the bounce index an
    int32 [P] as trace_wavefront passes it) and pixel_keys (a [P] sample
    index), bit for bit, one launch a call.  Times: R1's device time a
    launch (torch.profiler, over R1_REPS calls), beside its bound (integer
    operations over PEAK_INT_OPS, bytes over PEAK_BYTES); a call's time
    from CUDA events around it, median of 10 (for R1 the wrapper's host
    time: the card finishes the kernel sooner), and the plain version's;
    and the device kernels one call of each launches: the ops a draw site
    launches on the card before and after R1."""
    import torch

    from statmc_tpu_torch import spans
    from statmc_tpu_torch.core import rng as crng

    P = WIDTH * HEIGHT
    g = torch.Generator(device="cuda").manual_seed(17)
    keys = torch.randint(0, 1 << 32, (P, 2), generator=g, device="cuda")
    keys[:4] = torch.tensor([[0, 0], [0xFFFFFFFF, 0xFFFFFFFF],
                             [0, 0xFFFFFFFF], [0xFFFFFFFF, 0]])
    sis = torch.randint(0, MAXDEPTH + 1, (P,), generator=g, device="cuda",
                        dtype=torch.int32)
    pid = torch.arange(P, dtype=torch.int32, device="cuda")
    sample = torch.randint(0, 16, (P,), generator=g, device="cuda",
                           dtype=torch.int32)
    base = crng.base_key(2**31 + 5, device="cuda")
    sites = {
        # name: (kernel, plain, hashes a lane, counters a lane, bytes)
        "uniform_2d": (lambda: crng.uniform_2d(keys, sis, crng.SLOT_BSDF),
                       lambda: crng.site_hash_plain(
                           keys, (sis, crng.SLOT_BSDF), (2,)),
                       4, 2, P * (16 + 4 + 8)),
        "pixel_keys": (lambda: crng.pixel_keys(base, pid, sample),
                       lambda: crng.site_hash_plain(base, (sample, pid)),
                       2, 0, P * (4 + 4 + 16) + 16),
    }
    out = {}
    for name, (kernel, plain, hashes, ctrs, nbytes) in sites.items():
        before = spans.counted("kernel.R1")
        got = kernel()
        if spans.counted("kernel.R1") != before + 1:
            raise AssertionError(f"R1 {name}: not one launch a call")
        want = plain()
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            raise AssertionError(f"R1 {name}: differs from the plain "
                                 f"version on {int((got != want).sum())} "
                                 "words")
        call_ms = _median_ms(kernel)
        plain_ms = _median_ms(plain, warmup=1, reps=5)
        _, groups, _, _, _ = _profile(
            lambda: [kernel() for _ in range(R1_REPS)], host=False)
        if groups["R1"][1] != R1_REPS:
            raise AssertionError(f"R1 {name}: {groups['R1'][1]} kernels in "
                                 f"the trace of {R1_REPS} calls")
        ms = groups["R1"][0] / R1_REPS
        ops = P * (hashes * R1_HASH_OPS + ctrs * R1_UNIFORM_OPS)
        t_ops, t_bytes = ops / PEAK_INT_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms, bound_by = max((t_ops, "integer operations"),
                                 (t_bytes, "bytes"))
        kernels = {}
        for side, fn in (("plain", plain), ("R1", kernel)):
            _, groups, launched, _, _ = _profile(fn)
            kernels[side] = (sum(n for _, n in groups.values()), launched)
        print(f"R1 {name}: {P} lanes bit-identical to the plain version; "
              f"kernel {ms:.4f} ms on the device, bound {bound_ms:.4f} ms "
              f"({bound_by}; {bound_ms / ms:.3f} of the kernel's time; "
              f"{ops / P:.0f} integer operations and {nbytes / P:.1f} B a "
              f"lane: {t_ops:.4f} ms by operations, {t_bytes:.4f} ms by "
              f"bytes); a call {call_ms:.4f} ms, the plain version's "
              f"{plain_ms:.3f} ms (CUDA events); device kernels (runtime "
              f"launches) a call: plain {kernels['plain'][0]} "
              f"({kernels['plain'][1]}), R1 {kernels['R1'][0]} "
              f"({kernels['R1'][1]}) [{card}]", flush=True)
        out[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         kernels_plain=kernels["plain"][0],
                         kernels_r1=kernels["R1"][0])
    return out


def phase_b2_halo(rng, card):
    """Kernel B2 on the mesh's halo slabs: phase_b2's 1280x720, r = 20
    inputs cut into 2 and 4 row slabs, each extended by r rows of its
    neighbours and zeros with valid = 0 past the image's edges (what the
    row-sharded denoise gives each rank).  On every slab the kernel meets
    its plain version as phase_b2 requires; the slabs' centre rows equal
    the whole image's kernel output bit for bit.  Returns {slabs: kernel
    ms over all slabs, plain ms, max |dout|, bound}."""
    import torch

    from statmc_tpu_torch.denoise import filter_cuda as FC

    mc, d2, fm, gb, valid = _filter_inputs(rng)
    gf = (-0.5 / 0.02 ** 2,) * 3 + (-0.5 / 0.1 ** 2,) * 3
    ds, r = -0.5 / 10.0 ** 2, RADIUS
    whole, _ = FC.run_filter(mc, d2, fm, gb, valid, r, ds, gf)
    out = {}
    for n in (2, 4):
        hl = HEIGHT // n
        slabs = [tuple(_halo_slab(x, k * hl - r, (k + 1) * hl + r)
                       for x in (mc, d2, fm, gb, valid)) for k in range(n)]
        crops, err, plain_ms, pairs, accepted = [], 0.0, 0.0, 0, 0
        nbytes = 0
        for args in slabs:
            o_k, w_k = FC.run_filter(*args, r, ds, gf)
            nbytes += _nbytes(*args, o_k, w_k)
            (o_p, w_p), p_ms = _once_ms(
                lambda: FC.run_filter_plain(*args, r, ds, gf))
            torch.testing.assert_close(o_k, o_p, rtol=1e-4, atol=1e-6)
            torch.testing.assert_close(w_k, w_p, rtol=1e-4, atol=1e-6)
            err = max(err, float((o_k - o_p).abs().max()))
            plain_ms += p_ms
            crops.append(o_k[r:r + hl])
            p, a = _filter_pairs(args[0], args[1], r)
            pairs, accepted = pairs + p, accepted + a
        if not torch.equal(torch.cat(crops), whole):
            raise AssertionError(f"B2 halo, {n} slabs: the centre rows "
                                 "differ from the whole image's output")
        ms = _median_ms(lambda: [FC.run_filter(*a, r, ds, gf)
                                 for a in slabs])
        bound_ms, bound_by = _bound(
            pairs * B2_OPS_REJECT + accepted * (B2_OPS_ACCEPT - B2_OPS_REJECT),
            nbytes)
        print(f"B2 halo slabs: {WIDTH}x{HEIGHT} r={r} in {n} slabs of "
              f"{hl}+2x{r} rows, valid = 0 past the edges: max |dout| "
              f"{err:.3e}, centre rows equal the whole image's bit for bit;"
              f" kernel {ms:.3f} ms over the {n} slabs, plain "
              f"{plain_ms:.3f} ms (once each), bound {bound_ms:.3f} ms "
              f"({bound_by}; {bound_ms / ms:.3f} of the kernel's time) "
              f"[{card}]", flush=True)
        out[n] = dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound_ms,
                      bound_by=bound_by)
    return out


def _cli_lines(text, tag):
    return [ln[len(tag):] for ln in text.splitlines() if ln.startswith(tag)]


def phase_mesh_cli(card, path, tmp, n_spp, n_px):
    """python -m statmc_tpu_torch --mesh SPPxPX --writeimages in a
    subprocess: a world of n_spp * n_px ranks over NCCL, one card a rank,
    renders and denoises the 1280x720 staircase with ACRR and SMIS
    (MESH_SPP spp, 2 iterations).  B1 and B2 must launch on every rank
    (its ``Kernel launches by rank:`` line).  Returns the output
    directory, rank 0's launches, every rank's, and per-iteration times,
    rays and collectives."""
    tag = f"{n_spp}x{n_px}"
    outdir = os.path.join(tmp, f"mesh{tag}")
    cmd = [sys.executable, "-m", "statmc_tpu_torch", path, "--mesh", tag,
           "--writeimages", "--outdir", outdir]
    t0 = time.perf_counter()
    # In a session of its own, so that a timeout stops the ranks the
    # command started along with it.
    with subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True,
                          start_new_session=True) as p:
        try:
            stdout, stderr = p.communicate(timeout=MESH_TIMEOUT)
        finally:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    proc = subprocess.CompletedProcess(cmd, p.returncode, stdout, stderr)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"mesh {tag}: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    counts = _cli_lines(proc.stderr, "Kernel launches: ")
    by_rank = _cli_lines(proc.stderr, "Kernel launches by rank: ")
    if len(counts) != 1 or len(by_rank) != 1:
        raise AssertionError(f"mesh {tag}: launch lines\n"
                             f"{proc.stderr[-2000:]}")
    launches, by_rank = json.loads(counts[0]), json.loads(by_rank[0])
    if len(by_rank) != n_spp * n_px or any(
            c["B1"] <= 0 or c["B2"] <= 0 for c in by_rank):
        raise AssertionError(f"mesh {tag}: launches by rank {by_rank}")
    its = [{"render_s": int(a) * 1e-9, "denoise_s": int(b) * 1e-9,
            "rays_total": int(c), "comm_s": {
                k: v * 1e-9 for k, v in json.loads(d).items()}}
           for a, b, c, d in zip(
               _cli_lines(proc.stdout, "Rendering time [ns]: "),
               _cli_lines(proc.stdout, "CUDA time [ns]: "),
               _cli_lines(proc.stdout, "Rays traced: "),
               _cli_lines(proc.stdout, "Collectives time [ns]: "))]
    if len(its) != 2:
        raise AssertionError(f"mesh {tag}: iteration lines\n{proc.stdout}")
    print(f"mesh {tag}: python -m statmc_tpu_torch --mesh {tag} (NCCL, "
          f"{n_spp * n_px} rank(s), one card each), {WIDTH}x{HEIGHT}, "
          f"{MESH_SPP} spp, 2 iterations, denoised: rc 0 in {wall:.1f} s; "
          f"launches by rank {by_rank} [{card}]", flush=True)
    return {"outdir": outdir, "launches": launches, "by_rank": by_rank,
            "its": its, "wall_s": wall}


def phase_mesh_2x2(card, path, tmp):
    """load(path, mesh=make_mesh(2, 2, devices=[cuda:0] * 4)) in four
    spawned ranks on one card over gloo (parallel/launch.py render_task):
    samples strided over 2 ranks, rows over 2 (the denoise on halo
    slabs, B2 with valid zeros).  B1 and B2 must launch on every rank.
    Returns rank 0's whole-image results per iteration, with every moment
    state."""
    import torch

    from statmc_tpu_torch.parallel import launch

    out = os.path.join(tmp, "mesh2x2.pt")
    t0 = time.perf_counter()
    launch.run_world(launch.render_task, 2, 2, (path, out, None, 0, True),
                     devices=["cuda:0"] * 4, timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    got = torch.load(out, weights_only=False)
    if any(c["B1"] <= 0 or c["B2"] <= 0 for c in got["launches"]):
        raise AssertionError(f"mesh 2x2: launches {got['launches']}")
    if got["denoise"] != "slabs":
        raise AssertionError(f"mesh 2x2: denoise {got['denoise']}")
    print(f"mesh 2x2 on one card: 4 ranks on cuda:0 over gloo, {WIDTH}x"
          f"{HEIGHT}, {MESH_SPP} spp, 2 iterations, denoised on halo row "
          f"slabs: {wall:.1f} s with the ranks' start; launches by rank "
          f"{got['launches']} [{card}]", flush=True)
    got["wall_s"] = wall
    return got


def _share(a, b):
    """Share of pixels (rows of [P, C]) within rtol 1e-4 / atol 1e-5."""
    import torch

    a = a.reshape(b.shape[0], -1)
    return float(torch.isclose(a, b.reshape(a.shape), rtol=1e-4,
                               atol=1e-5).all(-1).float().mean())


def _mesh_disk(outdir, n_spp, P, NB, NL):
    """A CLI mesh run's written buffers after the iteration that reaches
    n_spp samples a pixel: film, film-f, the Radiance n and film-mean-f
    by bounce, and the ACRR feedback from the latter (as
    driver._feedback)."""
    import torch

    from statmc_tpu_torch.core import spectrum as spec
    from statmc_tpu_torch.io.pfm import read_pfm

    def disk(name):
        return torch.as_tensor(read_pfm(os.path.join(
            outdir, f"staircase-proxy-{n_spp}-{name}.pfm")))

    fmf = torch.stack([disk(f"t0-b{b}-film-mean-f").reshape(P, 3)
                       for b in range(NB)])
    avg = spec.luminance(fmf).T
    avg = torch.nn.functional.pad(avg, (0, max(0, NL - avg.shape[1])))
    return {"film": disk("film").reshape(P, 3),
            "film_f": disk("film-f").reshape(P, 3), "avg_ls": avg[:, :NL],
            "film_mean_f": fmf,
            "n": torch.stack([disk(f"t0-b{b}-n").reshape(P, 1)
                              for b in range(NB)])}


def _snapshot(r):
    """What one iteration of the renderer r changes, copied."""
    return ({t: {k: v.clone() for k, v in st.items()}
             for t, st in r.states.items()},
            {k: getattr(r, k).clone() for k in (
                "film_sum", "film_w", "avg_ls", "win_b", "win_l",
                "ray_total")},
            {k: v.clone() for k, v in r.stats.items()})


def _restore(r, snap):
    states, tensors, stats = snap
    for t, st in states.items():
        for k, v in st.items():
            r.states[t][k].copy_(v)
    for k, v in tensors.items():
        setattr(r, k, v.clone())
    r.stats = {k: v.clone() for k, v in stats.items()}


def phase_mesh_reference(card, path, m1, m2, main_rate):
    """The one-device render of the mesh phases' file through the
    per-sample driver (driver.make_chunk_fn: the sample step the mesh
    strides, equal to path regeneration bit for bit), held against both
    meshes: n exact on every pixel; after iteration 1 the film within
    rtol 1e-4 / atol 1e-5 on every pixel; after iteration 2 the film,
    film-f and ACRR feedback (avg_ls; the 1x1 mesh's from its written
    film-mean-f) of the 1x1, and the film and film-f of the 2x2, on >=
    MESH_SHARE of the pixels; every share printed.

    The 2x2's feedback is held by its cause.  After iteration 1 every
    moment field of the 2x2 equals the reference's bit for bit but the
    Radiance m3; with the 2x2's m3 in the reference's states, the
    reference's own denoise gives the 2x2's film-f and feedback (avg_ls,
    win_b, win_l) bit for bit.  From there the reference renders
    iteration 2 again, with the mesh's feedback, and the 2x2's film,
    film-f and feedback meet it on >= MESH_SHARE of the pixels.  After
    iteration 2 the 2x2's film-f and feedback equal, on every pixel, what
    the whole-image filter gives on its gathered states: the halo slabs
    filter as the whole image does.  Prints the rays/s of both meshes
    beside the per-sample driver's (and path regeneration's, from the
    staircase main path at 4 spp), and each mesh's collectives' ms an
    iteration."""
    import torch

    from statmc_tpu_torch.driver import load, make_chunk_fn
    from statmc_tpu_torch.stats import estimator as E

    r = load(path, device="cuda")
    r.progress = False
    r.chunk_fn = make_chunk_fn(r.s)
    NL, P, H, W = r.s.icfg.n_ls, r.P, r.s.height, r.s.width
    NB = r.states[E.RADIANCE]["n"].shape[0]
    one = [_mesh_disk(m1["outdir"], r.total_spp(i), P, NB, NL)
           for i in (1, 2)]
    two = m2["iterations"]
    shares, logs = {}, []

    def ref():
        return {"film": r.film_mean.cpu(),
                "film_f": r.film_f.reshape(-1, 3).cpu(),
                "avg_ls": r.avg_ls.cpu()}

    def hold(tag, got, need):
        for k, v in ref().items():
            s = _share(got[k], v)
            shares[f"{tag} {k}"] = s
            if s < need.get(k, 0.0):
                raise AssertionError(f"mesh {tag} {k}: {s:.6f} of pixels, "
                                     f"need {need[k]}")

    def equal(tag, got, want):
        for k, v in want.items():
            if not torch.equal(got[k].cpu(), v.cpu()):
                raise AssertionError(f"mesh {tag}: {k} differs")

    for i in (1, 2):
        logs.append(r.run_iteration(i))
        n = r.states[E.RADIANCE]["n"].cpu()
        for mesh, got in (("1x1", one[i - 1]), ("2x2", two[i - 1])):
            if not torch.equal(got["n"].reshape(n.shape), n):
                raise AssertionError(f"mesh {mesh} iteration {i}: n differs")
            # Iteration 1's film-f and feedback are printed, not held.
            hold(f"{mesh} it{i}", got,
                 {"film": 1.0} if i == 1 else
                 {"film": MESH_SHARE, "film_f": MESH_SHARE,
                  "avg_ls": MESH_SHARE if mesh == "1x1" else 0.0})
        if i == 1:
            for t, st in r.states.items():
                for k, v in st.items():
                    if (t, k) != (E.RADIANCE, "m3"):
                        equal(f"2x2 it1 state {t}", two[0]["states"][t],
                              {k: v})
            it1 = _snapshot(r)
    # The whole-image filter on the 2x2's gathered iteration-2 states.
    states = {t: {k: v.cuda() for k, v in st.items()}
              for t, st in two[1]["states"].items()}
    derived, film_f = r._filter(states, two[1]["film"].cuda().reshape(
        H, W, 3), H)
    equal("2x2 it2 slabs against the whole-image filter", two[1],
          {"film_f": film_f.reshape(-1, 3), "avg_ls": r._feedback(derived)[0]})
    del states, derived, film_f
    # Iteration 1 again, with the 2x2's Radiance m3.
    _restore(r, it1)
    r.states[E.RADIANCE]["m3"].copy_(two[0]["states"][E.RADIANCE]["m3"])
    r._denoise()
    equal("2x2 it1 with its m3 in the one-device states", two[0],
          {"film_f": r.film_f.reshape(-1, 3), "avg_ls": r.avg_ls,
           "win_b": r.win_b, "win_l": r.win_l})
    r.run_iteration(2)
    hold("2x2 it2 against the one-device it2 from its it1 feedback", two[1],
         {k: MESH_SHARE for k in ("film", "film_f", "avg_ls")})
    rates = {"per_sample": (logs[1]["rays_total"] - logs[0]["rays_total"])
             / logs[1]["render_s"], "regeneration": main_rate}
    comm = {}
    for mesh, its in (("1x1", m1["its"]), ("2x2", [x["log"] for x in two])):
        rates[mesh], comm[mesh] = _mesh_rate(card, mesh, its, rates)
    print("mesh shares of pixels against the one-device render: "
          + json.dumps({k: round(v, 6) for k, v in shares.items()}),
          flush=True)
    return {"rays_per_s": rates, "collectives_ms": comm, "shares": shares,
            "one": one}


def _mesh_rate(card, mesh, its, rates):
    """A mesh's rays/s and collectives' ms in iteration 2, printed beside
    the one-device drivers' rays/s."""
    rays = its[1]["rays_total"] - its[0]["rays_total"]
    rate = rays / its[1]["render_s"]
    comm = {k: v * 1e3 for k, v in its[1]["comm_s"].items()}
    main_rate = rates["regeneration"]
    print(f"mesh {mesh} iteration 2: {rays:.0f} rays in "
          f"{its[1]['render_s']:.3f} s = {rate:.1f} rays/s, "
          f"{rate / rates['per_sample']:.3f}x the per-sample driver's "
          f"{rates['per_sample']:.1f} (path regeneration "
          + (f"{main_rate:.1f} at {SPP} spp" if main_rate
             else "not measured in this run")
          + "); collectives ms in it "
          + json.dumps({k: round(v, 3) for k, v in comm.items()})
          + f", denoise {its[1]['denoise_s'] * 1e3:.1f} ms [{card}]",
          flush=True)
    return rate, comm


def phase_mesh_cards(card, path, tmp, m1, m2, ref):
    """With 4 cards: --mesh 2x2 and --mesh 1x4 through the CLI, one card
    a rank over NCCL (all_gather, all_reduce and the halo's
    batch_isend_irecv between cards).  The 1x4 writes every buffer the
    1x1 wrote bit for bit (a "spp" group of one merges as the 1x1 does,
    and the halo slabs filter as the whole image does); the 2x2 gives
    the film, film-f, n and Radiance film-mean-f of the 2x2 on one card
    bit for bit (the same merge order over another transport).  Prints
    their rays/s and collectives' ms.  With fewer cards it says so and
    returns None."""
    import numpy as np
    import torch

    from statmc_tpu_torch.io.pfm import read_pfm

    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"mesh on 4 cards: not run, {cards} card(s) [{card}]",
              flush=True)
        return None
    one = ref["one"][0]
    P, NB, NL = one["film"].shape[0], one["n"].shape[0], one["avg_ls"].shape[1]
    out = {}
    for n_spp, n_px in ((2, 2), (1, 4)):
        tag = f"{n_spp}x{n_px}"
        got = phase_mesh_cli(card, path, tmp, n_spp, n_px)
        if tag == "1x4":
            names = sorted(os.listdir(m1["outdir"]))
            if sorted(os.listdir(got["outdir"])) != names:
                raise AssertionError("mesh 1x4: its buffers are not the "
                                     "1x1's")
            for name in names:
                if not np.array_equal(
                        read_pfm(os.path.join(got["outdir"], name)),
                        read_pfm(os.path.join(m1["outdir"], name))):
                    raise AssertionError(f"mesh 1x4: {name} differs from "
                                         "the 1x1's")
        else:
            for i, it in enumerate(m2["iterations"], 1):
                disk = _mesh_disk(got["outdir"], MESH_SPP * i, P, NB, NL)
                for k in ("film", "film_f", "n", "film_mean_f"):
                    if not torch.equal(disk[k], it[k].reshape(disk[k].shape)):
                        raise AssertionError(
                            f"mesh 2x2 over NCCL iteration {i}: {k} differs "
                            "from the 2x2 on one card's")
        got["rate"], got["comm"] = _mesh_rate(card, f"{tag} on 4 cards",
                                              got["its"], ref["rays_per_s"])
        out[tag] = got
    print("mesh on 4 cards: the 1x4's buffers equal the 1x1's and the "
          f"2x2's those of the 2x2 on one card, bit for bit [{card}]",
          flush=True)
    return out


def _mesh_phases(card, phase, main_rate):
    with tempfile.TemporaryDirectory() as tmp:
        path = _write_scene(tmp, "mesh.pbrt", _mesh_text())
        m1 = phase("mesh 1x1", phase_mesh_cli, card, path, tmp, 1, 1)
        m2 = phase("mesh 2x2 on one card", phase_mesh_2x2, card, path, tmp)
        res = phase("mesh reference", phase_mesh_reference, card, path, m1,
                    m2, main_rate)
        for it in m2["iterations"]:
            it["states"] = None
        m4 = phase("mesh on 4 cards", phase_mesh_cards, card, path, tmp, m1,
                   m2, res)
    del res["one"]
    res["launches"] = {"1x1": m1["launches"], "2x2": m2["launches"]}
    for k, v in (m4 or {}).items():
        res["launches"][f"{k}_4cards"] = v["by_rank"]
        res["rays_per_s"][f"{k}_4cards"] = v["rate"]
        res["collectives_ms"][f"{k}_4cards"] = v["comm"]
    return res


# The albedo-LUT phase: the samples a texel of the full tables, and the
# card-against-CPU tables (3 texels an axis, uber 2, at ALBEDO_SMALL_SAMPLES),
# whose texels must all agree within ALBEDO_ATOL; their share within rtol
# 1e-4 is reported against ALBEDO_SHARE (glass's small table, with 144
# texels in (0, 1e-3), reaches 96.98% on an NVIDIA H100 80GB HBM3).
ALBEDO_SAMPLES, ALBEDO_SMALL_SAMPLES = 1024, 64
ALBEDO_SHARE, ALBEDO_ATOL = 0.99, 1e-3
# The families whose default tables, copied from the JAX package, miss the
# compare's 0.05 in both packages alike: glass's and uber's grids between
# their texels, metal's compare through the noise of its 4,096-sample truth
# at grazing angles (tests/test_torch_albedo_lut.py,
# test_default_grid_misses_the_threshold and
# test_metal_truth_noisier_than_the_threshold; the reference only warns
# past LutCheckThreshold).  Their tool exits 1, as the JAX tool does; any
# other family over 0.05 fails the phase.
ALBEDO_GRID_MISSES = ("glass", "metal", "uber")


def phase_albedo_luts(card):
    """The albedo-LUT precompute (statmc_tpu_torch/tools/precomputealbedo)
    on the card for all nine families at their default sizes and
    ALBEDO_SAMPLES samples a texel, with --compare, --testlut and
    --benchmark: seconds, texels, BSDF samples/s, the compare error, the
    round trip, peak device memory above what was held before, M
    lookups/s and M rho()/s.  Each family's small table on the card and
    on the CPU (the same threefry draws): the share of texels within
    rtol 1e-4 against ALBEDO_SHARE, reported.  Then bsdftest's five
    materials on the card.  A compare error over 0.05 outside
    ALBEDO_GRID_MISSES, a failed round trip, a table not finite, a card
    texel more than ALBEDO_ATOL off the CPU's, a spread >= 0.05, a
    launch of B1-B4 (none is on this path) or none of R1 (the draws)
    raises.  Returns the workflow
    line's "albedo_lut" entry."""
    import torch

    from statmc_tpu_torch.render import albedo_lut as TA
    from statmc_tpu_torch.tools import bsdftest
    from statmc_tpu_torch.tools import precomputealbedo as PA

    out = {"families": {}, "bsdftest_spread": {}}
    _zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for fam in sorted(TA.FAMILY_AXES):
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = PA.run(PA.parse_args([
                "--family", fam, "--samples", str(ALBEDO_SAMPLES),
                "--compare", "--testlut", "--benchmark",
                "--out", os.path.join(tmp, f"{fam}.npz")]))
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            if not res["testlut"] or (res["compare"][0] > PA.COMPARE_THRESHOLD
                                      and fam not in ALBEDO_GRID_MISSES):
                raise AssertionError(
                    f"albedo LUTs {fam}: compare {res['compare']} (limit "
                    f"{PA.COMPARE_THRESHOLD}), round trip {res['testlut']}")
            n_axes = len(TA.FAMILY_AXES[fam])
            small = (2 if fam == "uber" else 3,) * n_axes
            gpu = TA.precompute_family_nd(fam, small, ALBEDO_SMALL_SAMPLES,
                                          device="cuda").data.cpu()
            cpu = TA.precompute_family_nd(fam, small, ALBEDO_SMALL_SAMPLES,
                                          device="cpu").data
            share = float(torch.isclose(gpu, cpu, rtol=1e-4, atol=0.0)
                          .float().mean())
            worst = float((gpu - cpu).abs().max())
            rate = res["texels"] * ALBEDO_SAMPLES / res["seconds"]
            row = {"sizes": list(res["lut"].sizes), "texels": res["texels"],
                   "seconds": res["seconds"], "bsdf_samples_per_s": rate,
                   "compare_max": res["compare"][0],
                   "compare_mean": res["compare"][1],
                   "round_trip": res["testlut"], "rc": res["rc"],
                   "peak_gib": peak,
                   "lookups_per_s": res["lookups_per_s"],
                   "rho_per_s": res["rho_per_s"],
                   "card_cpu_share": share, "card_cpu_max_abs": worst}
            out["families"][fam] = row
            print(f"albedo LUTs {fam}: {res['texels']} texels "
                  f"{tuple(row['sizes'])} x {ALBEDO_SAMPLES} samples in "
                  f"{res['seconds']:.3f} s = {rate / 1e6:.1f} M BSDF "
                  f"samples/s; compare max {res['compare'][0]:.4f} mean "
                  f"{res['compare'][1]:.4f} (tool exit {res['rc']}); round "
                  f"trip OK; peak "
                  f"{peak:.2f} GiB; {res['lookups_per_s'] / 1e6:.1f} M "
                  f"lookups/s, {res['rho_per_s'] / 1e6:.4f} M rho()/s (64 "
                  f"spp); card against CPU at {small} x "
                  f"{ALBEDO_SMALL_SAMPLES}: {share:.4f} of texels within "
                  f"rtol 1e-4 ({'held' if share >= ALBEDO_SHARE else 'missed'}"
                  f" {ALBEDO_SHARE}), max |d| {worst:.2e} [{card}]",
                  flush=True)
            if worst > ALBEDO_ATOL or not torch.isfinite(res["lut"].data).all():
                raise AssertionError(
                    f"albedo LUTs {fam}: card against CPU max |d| "
                    f"{worst:.3e} (need <= {ALBEDO_ATOL}), or the table is "
                    "not finite")
    for name in bsdftest.MATERIALS:
        spread = bsdftest.check(name, device="cuda")
        out["bsdftest_spread"][name] = spread
        if spread >= bsdftest.SPREAD_LIMIT:
            raise AssertionError(f"bsdftest {name}: spread {spread}")
    launches = _read_counts()
    if (any(launches[k] for k in ("B1", "B2", "B3", "B4"))
            or not launches["R1"]):
        raise AssertionError(f"albedo LUTs: B1-B4 launched or R1 did not: "
                             f"{launches}")
    fams = out["families"].values()
    texels = sum(v["texels"] for v in fams)
    seconds = sum(v["seconds"] for v in fams)
    out.update(texels=texels, seconds=seconds, card=card, launches=launches,
               bsdf_samples_per_s=texels * ALBEDO_SAMPLES / seconds)
    print(f"albedo LUTs: nine families, {texels} texels x {ALBEDO_SAMPLES} "
          f"samples in {seconds:.3f} s = {out['bsdf_samples_per_s'] / 1e6:.1f}"
          f" M BSDF samples/s; bsdftest on the card, max spread "
          f"{max(out['bsdftest_spread'].values()):.4f}; kernel launches "
          f"{launches} [{card}]", flush=True)
    return out


def main(only: frozenset = frozenset(), other_tree: str | None = None) -> int:
    """only: the groups of phases to run after phase 4b ("kernels",
    "mesh", "albedo"); all phases when empty."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from statmc_tpu_torch import cuda_build

    card = _card()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    cuda_build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{cuda_build.build_seconds if cuda_build.build_seconds else 0:.1f}"
          f" s) [{card}]", flush=True)
    _print_build(cuda_build)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    other = (phase("other tree's B2 and B3", _other_library, other_tree)
             if other_tree else None)
    b1 = phase("B1", phase_b1, rng, card)
    b2 = phase("B2", phase_b2, rng, card, other)
    # Inputs of phase B2's kind from a generator of their own, so the
    # later phases' random inputs stay those of earlier runs.
    b2h = phase("B2 halo slabs", phase_b2_halo, np.random.default_rng(SEED),
                card)
    r1 = phase("R1", phase_r1, card)
    if only:
        if "kernels" in only:
            phase("B2 backward", phase_b2_backward, card)
            phase("B3/B4", phase_b3_b4, rng, card,
                  phase("terrain setup", _terrain_renderer)[0].s, other)
        if "mesh" in only:
            _mesh_phases(card, phase, None)
        if "albedo" in only:
            phase("albedo LUTs", phase_albedo_luts, card)
        print(f"only {' and '.join(sorted(only))}: no result lines",
              flush=True)
        return 0
    # Both main paths run before the first profile: once torch.profiler
    # has run in a process, later launches cost the host more (a terrain
    # iteration took 6.2-7.2 s after a profile and 5.4-6.3 s before one,
    # in one run on an NVIDIA H100 80GB HBM3).
    launches, rs, stair_s, stair_rays, filter_calls, main_forms = phase(
        "staircase main path", phase_main_path, card)
    b2r = phase("B2 render inputs", phase_b2_render, card, other,
                filter_calls)
    del filter_calls
    b16_forms, b16 = phase("B2 range_bf16 render",
                              phase_b2_range_bf16_render, card, rs)
    phase("small staircase", phase_small_reference, card, "staircase",
          scene_small())
    rates = phase("samplers", phase_samplers, card)
    b2b = phase("B2 backward", phase_b2_backward, card)
    replay_s, replay_b1 = phase("reference parity", phase_reference_parity,
                                card)
    ck_launches = phase("checkpoint", phase_checkpoint, card)
    r, tl_launches, render_s, terrain_rays = phase(
        "terrain main path", phase_terrain_main_path, card)
    launches.update(tl_launches)
    rt, tx_launches, tx_s = phase("textured terrain", phase_textured_terrain,
                                  card, r, render_s)
    hs, hs_launches, hs_log, hs_rate = phase(
        "hair sss staircase", phase_hair_sss, card, "staircase", stair_s,
        stair_rays)
    ht, ht_launches, ht_log, ht_rate = phase(
        "hair sss terrain", phase_hair_sss, card, "terrain", render_s,
        terrain_rays)
    vp, vp_launches, vp_log, vp_rate = phase(
        "volpath", phase_volpath, card, stair_s, stair_rays)
    probe_checked = phase("SSS probe calls", phase_sss_probe_calls, card, hs,
                          ht)
    walk_checked = phase("volpath walk calls", phase_volpath_walk_calls, card,
                         vp)
    new = _new_paths(card, phase, stair_s, stair_rays, render_s,
                     terrain_rays)
    bm = _bdpt_mlt_paths(card, phase, stair_s, stair_rays, render_s,
                         terrain_rays)
    # Before the profiles, as the main paths: the mesh's rays/s stands
    # beside the per-sample driver's, timed in this process.
    albedo = phase("albedo LUTs", phase_albedo_luts, card)
    mesh = _mesh_phases(card, phase, stair_rays / stair_s)
    path_ms, stair_whole = phase("staircase profile", phase_staircase_profile,
                                 card, rs, stair_s)
    del rs
    terrain_ms, cull_calls, terrain_whole = phase(
        "terrain profile", phase_terrain_profile, card, r, render_s)
    path_ms.update(terrain_ms)
    tx_ms = phase("textured profile", phase_textured_profile, card, rt, tx_s,
                  terrain_whole)
    del rt
    hs_ms = phase("hair sss profile", phase_hair_sss_profile, card, hs,
                  hs_log["render_s"], stair_whole)
    del hs
    ht_ms = phase("hair sss terrain profile", phase_hair_sss_terrain_profile,
                  card, ht)
    del ht
    vp_ms = phase("volpath profile", phase_volpath_profile, card, vp,
                  vp_log["render_s"], stair_whole)
    del vp
    all_ms = phase("new paths profile", phase_new_profiles, card,
                   {**{k: (v[0], _PROFILED[k], v[2])
                       for k, v in new.items() if k in _PROFILED},
                    **_bdpt_mlt_profiled(bm)})
    new_ms = {k: all_ms.get(k, {}) for k in new}
    bm_ms = {k: all_ms[k] for k in bm}
    new = {k: (None, *v[1:]) for k, v in new.items()}  # the renderers go
    bm = {k: (None, *v[1:]) for k, v in bm.items()}
    phase("B3 main-path rays", phase_b3_main_rays, card, r.s.bvh.bounds,
          cull_calls, other)
    del cull_calls
    b34 = phase("B3/B4", phase_b3_b4, rng, card, r.s, other)
    del r
    phase("small terrain", phase_small_reference, card, "terrain",
          terrain_small())
    phase("textured small", phase_small_reference, card, "textured staircase",
          textured_small, TEXTURED_SHARE, 0.0, ("B1", "B2"))
    phase("hair sss small", phase_small_reference, card,
          "hair sss staircase", hair_sss_small(), HAIR_SMALL_SHARE, 0.0,
          ("B1", "B2"))
    vt_launches, vt_ms = phase("volpath two-level", phase_volpath_twolevel,
                               card)
    phase("volpath small", phase_small_reference, card, "volpath staircase",
          volpath_small, SMALL_SHARE, 1e-3, ("B1", "B2"))
    _new_smalls(card, phase)
    phase("bdpt small", phase_small_reference, card, "bdpt", bdpt_small(),
          SMALL_SHARE, 0.0, ("B1",))
    mlt_small = phase("mlt small", phase_mlt_small, card)
    cli = phase("CLI", phase_cli, card)
    cam = b34["camera"]
    new_workflow, new_kernels = _new_results(new, new_ms)
    bm_workflow, bm_kernels = _bdpt_mlt_results(bm, bm_ms)
    bm_workflow["mlt_small"] = mlt_small
    kernels = [
        {"name": "B1 fused_intersect", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/fused_intersect.cu",
         "replaces": "statmc_tpu/accel/fused.py:237",
         "launches": launches["B1"], "main_path_ms": path_ms["B1"],
         "textured_launches": tx_launches["B1"],
         "textured_main_path_ms": tx_ms.get("B1"),
         "max_abs_err": max(v["err"] for v in b1.values()),
         "ms": b1["staircase"]["ms"],
         "plain_ms": b1["staircase"]["plain_ms"],
         "bound_ms": b1["staircase"]["bound_ms"],
         "bound_by": b1["staircase"]["bound_by"], "library_ms": None},
        {"name": "B2 stat_filter", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/stat_filter.cu",
         "replaces": "statmc_tpu/denoise/filter_pallas.py:50",
         "launches": launches["B2"], "main_path_ms": path_ms["B2"],
         "range_bf16_denoiser_launches": b16_forms["f32"],
         "textured_launches": tx_launches["B2"],
         "textured_main_path_ms": tx_ms.get("B2"),
         "max_abs_err": max(v["err"] for v in (*b2["f32"].values(),
                                                *b2r["f32"].values())),
         "ms": b2["f32"][True]["ms"],
         "plain_ms": b2["f32"][True]["plain_ms"],
         "bound_ms": b2["f32"][True]["bound_ms"],
         "bound_by": b2["f32"][True]["bound_by"],
         "library_ms": None,
         # The same on the render's own inputs (iteration 2's denoise).
         "render_ms": b2r["f32"][True]["ms"],
         "render_plain_ms": b2r["f32"][True]["plain_ms"],
         "render_bound_ms": b2r["f32"][True]["bound_ms"],
         "render_accepted": b2r["f32"][True]["accepted"],
         # As FilterApply's backward kernel (normalize=False) at 1280x720,
         # r = 20: B2's launches in one forward + backward, its own time.
         "filter_apply_launches": b2b["launches"], "backward_ms": b2b["ms"],
         "backward_plain_ms": b2b["plain_ms"],
         "backward_max_abs_err": b2b["err"],
         "backward_bound_ms": b2b["bound_ms"],
         "backward_bound_by": b2b["bound_by"],
         "forward_backward_ms": b2b["fwd_bwd_ms"],
         # On the mesh's row slabs, halo-extended with valid = 0 past the
         # image's edges: kernel ms over all slabs of a 2- and a 4-way cut.
         **{f"halo{n}_{k}": v for n, res in b2h.items()
            for k, v in res.items()}},
        # B3/B4: ms and bound_ms on all `blocks` of the camera rays;
        # plain_ms on the `plain_blocks` blocks where the two were
        # compared (all for B3), and for B4 the kernel's subset_ms on them.
        {"name": "B3 twolevel_cull", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/twolevel_cull.cu",
         "replaces": "statmc_tpu/accel/twolevel.py:249",
         "launches": launches["B3"], "main_path_ms": path_ms["B3"],
         "textured_launches": tx_launches["B3"],
         "textured_main_path_ms": tx_ms.get("B3"),
         "max_abs_err": max(v["cull_err"] for v in b34.values()),
         "ms": cam["cull_ms"], "plain_ms": cam["cull_plain_ms"],
         "bound_ms": cam["b3"][0], "bound_by": cam["b3"][1],
         "library_ms": None, "blocks": cam["blocks"],
         "plain_blocks": cam["blocks"]},
        {"name": "B4 twolevel_walk", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/twolevel_walk.cu",
         "replaces": "statmc_tpu/accel/twolevel.py:406",
         "launches": launches["B4"], "main_path_ms": path_ms["B4"],
         "textured_launches": tx_launches["B4"],
         "textured_main_path_ms": tx_ms.get("B4"),
         "max_abs_err": max(v["walk_err"] for v in b34.values()),
         "ms": cam["walk_ms"], "plain_ms": cam["walk_plain_ms"],
         "bound_ms": cam["b4"][0], "bound_by": cam["b4"][1],
         "library_ms": None, "blocks": cam["blocks"],
         "plain_blocks": cam["plain_blocks"],
         "subset_ms": cam["walk_sub_ms"]},
    ]
    for k in kernels:
        b = k["name"][:2]
        k.update({"hair_sss_staircase_launches": hs_launches[b],
                  "hair_sss_staircase_main_path_ms": hs_ms.get(b),
                  "hair_sss_terrain_launches": ht_launches[b],
                  "hair_sss_terrain_main_path_ms": ht_ms.get(b),
                  # The full-width volpath staircase (fused: B1, B2) and
                  # the small volpath terrain (two-level: B3, B4).
                  "volpath_launches": vp_launches[b],
                  "volpath_main_path_ms": vp_ms.get(b),
                  "volpath_terrain_launches": vt_launches[b],
                  "volpath_terrain_main_path_ms": vt_ms.get(b)})
        k.update(new_kernels[b])
        k.update(bm_kernels[b])
        # The mesh phases: the 1x1 CLI's own count, each 2x2 rank's, and
        # with 4 cards each rank's of the 2x2 and 1x4 over NCCL.
        k.update({"mesh_1x1_launches": mesh["launches"]["1x1"][b],
                  "mesh_2x2_launches": [c[b] for c in
                                        mesh["launches"]["2x2"]],
                  **{f"mesh_{m}_launches": [c[b] for c in mesh["launches"][m]]
                     for m in ("2x2_4cards", "1x4_4cards")
                     if m in mesh["launches"]}})
    # R1: phase R1's 2D draw site and pixel_keys at 921,600 lanes; launches
    # and device ms over the staircase main path's render and profile.
    kernels.append({
        "name": "R1 threefry", "route": "cuda",
        "source": "statmc_tpu_torch/csrc/threefry.cu",
        "replaces": "none: statmc_tpu/core/rng.py's draw sites, which XLA "
                    "fuses", "launches": launches["R1"],
        "main_path_ms": path_ms["R1"], "max_abs_err": 0.0,
        "ms": r1["uniform_2d"]["ms"], "plain_ms": r1["uniform_2d"]["plain_ms"],
        "bound_ms": r1["uniform_2d"]["bound_ms"],
        "bound_by": r1["uniform_2d"]["bound_by"], "library_ms": None,
        "call_ms": r1["uniform_2d"]["call_ms"],
        "pixel_keys_ms": r1["pixel_keys"]["ms"],
        "pixel_keys_plain_ms": r1["pixel_keys"]["plain_ms"],
        "pixel_keys_bound_ms": r1["pixel_keys"]["bound_ms"],
        "site_kernels_plain": r1["uniform_2d"]["kernels_plain"],
        "site_kernels_r1": r1["uniform_2d"]["kernels_r1"]})
    # B2's other forms: launches by form as read back from the main path's
    # two runs of this script (the staircase render, all f32, and its
    # denoise through Renderer(denoiser=StatDenoiser(range_bf16=True)); no
    # entry point reaches the acceptance forms, as in the JAX package);
    # ms, plain_ms (whole image, once) and bound on the test inputs,
    # normalized; the render's own inputs beside them.
    for form in _b2_forms_tested():
        t, rr = b2[form], b2r[form]
        kernels.append({
            "name": f"B2 stat_filter {form}", "route": "cuda",
            "source": "statmc_tpu_torch/csrc/stat_filter.cu",
            "replaces": "statmc_tpu/denoise/filter_pallas.py:50",
            "launches": main_forms[form] + b16_forms[form],
            "main_path_launches": main_forms[form],
            "range_bf16_denoiser_launches": b16_forms[form],
            "max_abs_err": max(v["err"] for v in (*t.values(),
                                                  *rr.values())),
            "ms": t[True]["ms"], "plain_ms": t[True]["plain_ms"],
            "bound_ms": t[True]["bound_ms"], "bound_by": t[True]["bound_by"],
            "library_ms": None, "accepted": t[True]["accepted"],
            "unnormalized_ms": t[False]["ms"],
            "plain_crop_ms": t[True]["plain_crop_ms"],
            "rel_mean_vs_f32": t[True]["rel_mean"],
            "render_ms": rr[True]["ms"],
            "render_bound_ms": rr[True]["bound_ms"],
            "render_accepted": rr[True]["accepted"],
            "render_rel_mean_vs_f32": rr[True]["rel_mean"],
            "render_rel_max_vs_f32": rr[True]["rel_max"],
            "render_mean_shift_vs_f32": rr[True]["mean_shift"],
            **({"denoiser_film_f_rel_mean_vs_f32": b16["rel_mean"]}
               if form == "range_bf16" else {})})
    print(json.dumps({"workflow": {
        "sampler_rays_per_s": rates, "replay_s": replay_s,
        "cli_launches": cli, "checkpoint_launches": ck_launches,
        "replay_b1_checked": replay_b1,
        "textured_terrain_render_s": tx_s, "terrain_render_s": render_s,
        "hair_sss_staircase_render_s": hs_log["render_s"],
        "hair_sss_staircase_rays_per_s": hs_rate,
        "hair_sss_terrain_render_s": ht_log["render_s"],
        "hair_sss_terrain_rays_per_s": ht_rate,
        "staircase_rays_per_s": stair_rays / stair_s,
        "terrain_rays_per_s": terrain_rays / render_s,
        "sss_probe_calls_checked": probe_checked,
        "volpath_render_s": vp_log["render_s"],
        "volpath_rays_per_s": vp_rate,
        "volpath_walk_calls_checked": walk_checked, **new_workflow,
        **bm_workflow, "mesh_rays_per_s": mesh["rays_per_s"],
        "mesh_collectives_ms": mesh["collectives_ms"],
        "mesh_shares": mesh["shares"], "albedo_lut": albedo}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    sys.exit(main(only=frozenset(g for g in ("kernels", "mesh", "albedo")
                                 if f"--{g}" in argv),
                  other_tree=(argv[argv.index("--other") + 1]
                              if "--other" in argv else None)))
