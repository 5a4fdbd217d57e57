#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (statmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py --kernels  # phases 1-4 and 11 only: the kernels
                                     # against their plain versions, no
                                     # main path, no result lines
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
   radius 20, C = 3, G = 6, CF = 3, normalized and not;
5. the staircase main path: ``load(scene).render(iterations=2)`` on the
   staircase proxy at 1280x720, maxdepth 8, filter radius 20, albedo +
   normal G-buffers, 4 spp, with B1's and B2's launch counts set to 0
   just before it and read just after;
6. kernel B2 against its plain version on the render's own inputs: the
   arguments iteration 2's denoise passes to run_filter, captured by
   running that denoise once more; normalized and not, with the
   accepted share and the bound at it;
7. the same call as 5 on a small staircase proxy (32x24) on the card and
   through the plain PyTorch path on the CPU, which the CPU tests hold
   against the JAX package: the buffers must agree;
8. the terrain main path (the large-scene, two-level path):
   ``load(terrain).render(iterations=1)`` on the 131,554-triangle terrain
   proxy at 1280x720, 4 spp, maxdepth 8, with B3's and B4's launch counts
   set to 0 just before it and read just after;
9. the staircase's iteration 2 once more under torch.profiler (device
   activity only): B1's and B2's device time per iteration; then one more
   terrain iteration under torch.profiler: device time by
   kernel (B3's and B4's per iteration) and by stage of the two-level
   intersect call (partition, slab rays, B3, worklists, features, B4,
   unsort), and the device's busy share of the unprofiled iteration;
   the rays of that iteration's B3 calls are kept;
10. kernel B3 on those rays: votes against the two-stage plain cull on
    every call, its time over all calls, and the reject tests, per-ray
    tests and surviving boxes per block that its design spends there;
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
13. one JSON line of per-kernel results, then the device line.

Kernel times are CUDA-event medians of 10 runs after 3 warm-ups; a plain
version runs once, and its time is that one CUDA-event reading.  Each
kernel's bound (bound_ms) is the larger of its FP32 operations over
67 TFLOP/s and its bytes (each input read once, each output written
once) over 3.35 TB/s, the H100 SXM's published peaks, counting the work
these inputs need.  main_path_ms is the kernel's device time over one
profiled iteration of the main path that runs it.  Every time is printed
with the card's name and power limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

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
B3_OPS = 20  # (ray, subgroup box) slab test
# (sub-block, box) reject of the redesigned B3: per axis 4 subtractions,
# 8 products, 14 min/max and 2 merges; then the product and 2 compares.
B3_REJECT_OPS = 3 * (4 + 8 + 14 + 2) + 3
B4_OPS = B1_OPS  # (ray, triangle): the same core as B1
# The kernels' names in a profiler trace.
KERNEL_NAMES = {"B1": "fused_intersect", "B2": "stat_filter",
                "B3": "twolevel_cull", "B4": "twolevel_walk"}
SUBSET = 64  # blocks of 512 rays on which B4 meets its plain version
# The small reference render (phase 6) and the share of its pixels that
# must agree between the card and the CPU in every buffer (0.9961 at
# worst on an NVIDIA H100 80GB HBM3 at 700 W, with equal ray totals).
SMALL_W, SMALL_H, SMALL_SHARE = 32, 24, 0.98
TERRAIN_SPP, TERRAIN_MAXDEPTH = 4, 8  # bench.py's terrain line


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
    this tree's nvcc flags) into build/other/, loaded with ctypes."""
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
    return lib


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


def _scene_text(width, height):
    from statmc_tpu_torch.testscenes import scene_text

    return scene_text(width=width, height=height, spp=SPP, iterations=2,
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
    """Kernel B2 against its plain version at the production shape."""
    mc, d2, fm, gb, valid = _filter_inputs(rng)
    gf = (-0.5 / 0.02 ** 2,) * 3 + (-0.5 / 0.1 ** 2,) * 3
    ds = -0.5 / 10.0 ** 2
    return _b2_check("B2", card, other, (mc, d2, fm, gb, valid, RADIUS, ds,
                                         gf), min_wsum=1.0 - 1e-5)


def _b2_check(name, card, other, args, min_wsum=None):
    """B2 against its plain version on `args` (run_filter's arguments
    without normalize), normalized and not: max |dout|, times, the
    in-image pairs and the accepted share, and the bound at that share.
    Returns {normalize: results}."""
    import torch

    from statmc_tpu_torch.denoise import filter_cuda as FC

    mc, d2 = args[0], args[1]
    H, W, _ = mc.shape
    pairs, accepted = _filter_pairs(mc, d2, args[5])
    out = {}
    for normalize in (True, False):
        args_n = (*args, normalize)
        o_k, w_k = FC.run_filter(*args_n)
        (o_p, w_p), plain_ms = _once_ms(lambda: FC.run_filter_plain(*args_n))
        # The kernel sums the window in the plain version's order with the
        # same rounding per step; expf and the library exp may still
        # differ in the last bit, hence rtol 1e-4 / atol 1e-6.
        torch.testing.assert_close(o_k, o_p, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(w_k, w_p, rtol=1e-4, atol=1e-6)
        if min_wsum is not None and float(w_k.min()) < min_wsum:
            raise AssertionError(f"{name}: min wsum {float(w_k.min())}")
        err = float((o_k - o_p).abs().max())
        ms = _median_ms(lambda: FC.run_filter(*args_n))
        ab = _ab_ms(lambda: FC.run_filter(*args_n), other)
        bound_ms, bound_by = _bound(
            pairs * B2_OPS_REJECT + accepted * (B2_OPS_ACCEPT - B2_OPS_REJECT),
            _nbytes(*args[:5], o_k, w_k))
        print(f"{name} normalize={normalize}: {W}x{H} C={mc.shape[2]} "
              f"CF={args[2].shape[2]} G={args[3].shape[2]} r={args[5]}, max "
              f"|dout| {err:.3e}, min wsum {float(w_k.min()):.6f}; "
              f"{pairs} in-image pairs, {accepted / pairs:.4f} accepted; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (once), bound "
              f"{bound_ms:.3f} ms ({bound_by}; {bound_ms / ms:.3f} of the "
              f"kernel's time){_ab_text(ab)} [{card}]", flush=True)
        out[normalize] = dict(ms=ms, plain_ms=plain_ms, err=err,
                              bound_ms=bound_ms, bound_by=bound_by,
                              accepted=accepted / pairs, ab=ab)
    return out


def _filter_pairs(mc, d2, radius):
    """(in-image (pixel, neighbour) pairs, accepted ones) of the window of
    `radius`: the acceptance test decides which pairs take the weight and
    its exponential."""
    H, W, _ = mc.shape
    pairs = accepted = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            ys, yj = slice(max(0, -dy), H - max(0, dy)), slice(
                max(0, dy), H - max(0, -dy))
            xs, xj = slice(max(0, -dx), W - max(0, dx)), slice(
                max(0, dx), W - max(0, -dx))
            diff = mc[ys, xs] - mc[yj, xj]
            ok = (diff * diff <= d2[ys, xs] + d2[yj, xj] + 1e-20).all(-1)
            pairs += ok.numel()
            accepted += int(ok.sum())
    return pairs, accepted


def _profile_iteration(r, i, host: bool = True):
    """Iteration i of renderer r under torch.profiler: (its log, the
    sums of `_trace_sums`, seconds spent reading the trace).  host=False
    records the device only: the kernels' times by name, without the
    host's ops, ranges and launches, at a fraction of the profiler's
    cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if host else [ProfilerActivity.CUDA]) as prof:
        log = r.run_iteration(i)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups, launches, stages = _trace_sums(prof)
    return log, groups, launches, stages, time.perf_counter() - t0


def phase_main_path(card):
    """load(scene).render(iterations=2) on the card, launch counts
    read around it.  Returns the launch counts, the renderer (the
    profile phase runs its iteration 2 again) and iteration 2's
    render_s."""
    import numpy as np
    import torch

    from statmc_tpu_torch.accel import fused as F
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
        F.intersect_tiles.launches = 0
        FC.run_filter.launches = 0
        logs = r.render(iterations=2, verbose=False)
        torch.cuda.synchronize()
        launches = {"B1": F.intersect_tiles.launches,
                    "B2": FC.run_filter.launches}
        filter_calls = _capture_filter_inputs(r)
        film = r.film_mean.cpu().numpy()
        film_f = r.film_f.cpu().numpy()
    for name, img in (("film", film), ("film-f", film_f)):
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError(f"{name}: not finite with mean > 0")
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path launch counts {launches}")
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
          f"{launches}", flush=True)
    return launches, r, logs[-1]["render_s"], filter_calls


def _capture_filter_inputs(r):
    """The arguments that iteration 2's denoise passes to run_filter
    (denoise/filter.py), one tuple per call: r._denoise() once more on
    the moment states and film it filtered, with the module's run_filter
    wrapped to record them."""
    from statmc_tpu_torch.denoise import filter as FL

    calls, real = [], FL.run_filter

    def record(*args):
        calls.append(args)
        return real(*args)

    FL.run_filter = record
    try:
        r._denoise()
    finally:
        FL.run_filter = real
    return calls


def phase_b2_render(card, other, calls):
    """Kernel B2 against its plain version on the inputs of the staircase
    render's iteration-2 denoise (each call of it)."""
    out = None
    for k, args in enumerate(calls):
        res = _b2_check(f"B2 render inputs, call {k + 1} of {len(calls)}",
                        card, other, tuple(args[:8]))
        out = out or res
    if out is None:
        raise AssertionError("B2 render inputs: the denoise made no call")
    return out


def phase_staircase_profile(card, r, render_s):
    """The staircase main path's iteration 2 once more under
    torch.profiler (device activity only): B1's and B2's device time per
    iteration, and the device's busy share of the unprofiled iteration
    (render_s).  Returns {kernel: device ms per iteration}."""
    log, groups, _, _, read_s = _profile_iteration(r, 2, host=False)
    total = sum(ms for ms, _ in groups.values())
    print(f"staircase profile: iteration 2 again, {log['render_s']:.3f} s "
          f"render + {log['denoise_s'] * 1e3:.1f} ms denoise profiled, "
          f"trace read in {read_s:.1f} s; device time {total:.1f} ms in "
          f"{sum(n for _, n in groups.values())} kernels, busy "
          f"{total / 1e3 / render_s:.3f} of the unprofiled "
          f"{render_s:.3f} s; "
          + ", ".join(f"{g} {ms:.1f} ms ({n})"
                      for g, (ms, n) in groups.items() if n)
          + f" [{card}]", flush=True)
    if groups["B1"][1] <= 0 or groups["B2"][1] <= 0:
        raise AssertionError("staircase profile: B1 or B2 not in the trace")
    return {k: groups[k][0] for k in ("B1", "B2")}


def phase_small_reference(card, name, text):
    """A small scene rendered on the card and on the CPU (the kernels'
    plain versions): equal sample counts, and buffers that agree up to
    the paths that an ulp sends elsewhere (tests/test_torch_slice.py
    explains why such paths exist between any two implementations)."""
    import numpy as np

    from statmc_tpu_torch.driver import load

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}-small.pbrt")
        with open(path, "w") as f:
            f.write(text)
        bufs, rays = {}, {}
        for dev in ("cuda", "cpu"):
            r = load(path, device=dev)
            r.progress = False
            rays[dev] = r.render(verbose=False)[-1]["rays_total"]
            bufs[dev] = r.buffers()
    gpu, cpu = bufs["cuda"], bufs["cpu"]
    if gpu.keys() != cpu.keys():
        raise AssertionError(f"buffer names differ: {sorted(gpu)} vs "
                             f"{sorted(cpu)}")
    shares = {}
    for k in sorted(cpu):
        a, b = cpu[k], gpu[k]
        if k.endswith("-n"):
            if not np.array_equal(a, b):
                raise AssertionError(f"{k}: sample counts differ")
            continue
        if not np.isfinite(b).all():
            raise AssertionError(f"{k}: not finite on the card")
        close = np.isclose(b, a, rtol=1e-4, atol=1e-6)
        share = float((close.all(-1) if close.ndim == 3 else close).mean())
        shares[k] = share
        scale = float(np.abs(a).mean()) + 1e-12
        if share < SMALL_SHARE or abs(b.mean() - a.mean()) > 1e-3 * scale:
            raise AssertionError(f"{k}: {share:.4f} of pixels within rtol "
                                 f"1e-4, means {a.mean()} (cpu) vs "
                                 f"{b.mean()} (card)")
    drift = abs(rays["cuda"] - rays["cpu"]) / rays["cpu"]
    if drift > 1e-3:
        raise AssertionError(f"rays_total {rays['cuda']} (card) vs "
                             f"{rays['cpu']} (cpu)")
    worst = min(shares, key=shares.get)
    print(f"small {name}: {SMALL_W}x{SMALL_H} card vs cpu, {len(cpu)} "
          f"buffers, worst {worst} {shares[worst]:.4f} of pixels within "
          f"rtol 1e-4, rays_total {rays['cuda']:.0f} vs {rays['cpu']:.0f} "
          f"[{card}]", flush=True)


def scene_small():
    from statmc_tpu_torch.testscenes import scene_text

    return scene_text(width=SMALL_W, height=SMALL_H, spp=2, iterations=2,
                      maxdepth=4, denoise=True, filterradius=2)


def terrain_small():
    """19,554 triangles (n = 96): past FUSED_MAX_TRIS, so two-level."""
    from statmc_tpu_torch.testscenes import terrain_scene_text

    return terrain_scene_text(width=SMALL_W, height=SMALL_H, spp=2,
                              iterations=2, maxdepth=4, n=96, denoise=True)


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

    from statmc_tpu_torch.accel import twolevel as TT

    held = torch.cuda.memory_allocated()  # the staircase renderer's
    r, setup_s = _terrain_renderer()
    torch.cuda.reset_peak_memory_stats()
    TT.cull.launches = 0
    TT.walk.launches = 0
    log = r.render(iterations=1, verbose=False)[-1]
    torch.cuda.synchronize()
    launches = {"B3": TT.cull.launches, "B4": TT.walk.launches}
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
    return r, launches, log["render_s"]


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
            if name.startswith("twolevel."):
                ranges.append((e.start_ns(), e.end_ns(), name))
    ranges.sort()
    starts = [a for a, _, _ in ranges]
    stages = {}
    for a, b, name in ranges:
        st = stages.setdefault(name, [0, 0.0, 0.0])
        st[0] += 1
        st[1] += (b - a) / 1e6
    for t, op in ops:  # the ranges do not nest: bisect for the one around t
        ms = by_op.pop(op, None) if op > 0 else None
        k = bisect.bisect_right(starts, t) - 1
        if ms is not None and k >= 0 and t <= ranges[k][1]:
            stages[ranges[k][2]][2] += ms
    return groups, launches, stages


def phase_terrain_profile(card, r, render_s):
    """The terrain main path's iteration once more under torch.profiler:
    device time by kernel (B3, B4, the rest) and by stage of
    intersect_twolevel (its ``twolevel.*`` ranges, summed over the
    iteration's calls), and the device's busy share of the unprofiled
    iteration (render_s).  Returns ({kernel: device ms per iteration},
    the rays of each of the iteration's B3 calls, recorded by wrapping
    accel/twolevel.py's slab_rays, which makes them)."""
    from statmc_tpu_torch.accel import twolevel as TT

    cull_rays, real = [], TT.slab_rays

    def record(o, d, t_max):
        cull_rays.append(real(o, d, t_max))
        return cull_rays[-1]

    TT.slab_rays = record
    try:
        log, groups, launches, stages, read_s = _profile_iteration(r, 1)
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
    return {k: groups[k][0] for k in ("B3", "B4")}, cull_rays


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


def main(kernels_only: bool = False, other_tree: str | None = None) -> int:
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
    if kernels_only:
        phase("B3/B4", phase_b3_b4, rng, card,
              phase("terrain setup", _terrain_renderer)[0].s, other)
        print("kernels only: no main path driven, no result lines",
              flush=True)
        return 0
    # Both main paths run before the first profile: once torch.profiler
    # has run in a process, later launches cost the host more (a terrain
    # iteration took 6.2-7.2 s after a profile and 5.4-6.3 s before one,
    # in one run on an NVIDIA H100 80GB HBM3).
    launches, rs, stair_s, filter_calls = phase(
        "staircase main path", phase_main_path, card)
    b2r = phase("B2 render inputs", phase_b2_render, card, other,
                filter_calls)
    del filter_calls
    phase("small staircase", phase_small_reference, card, "staircase",
          scene_small())
    r, tl_launches, render_s = phase("terrain main path",
                                     phase_terrain_main_path, card)
    launches.update(tl_launches)
    path_ms = phase("staircase profile", phase_staircase_profile, card, rs,
                    stair_s)
    del rs
    terrain_ms, cull_calls = phase("terrain profile", phase_terrain_profile,
                                   card, r, render_s)
    path_ms.update(terrain_ms)
    phase("B3 main-path rays", phase_b3_main_rays, card, r.s.bvh.bounds,
          cull_calls, other)
    del cull_calls
    b34 = phase("B3/B4", phase_b3_b4, rng, card, r.s, other)
    del r
    phase("small terrain", phase_small_reference, card, "terrain",
          terrain_small())
    cam = b34["camera"]
    kernels = [
        {"name": "B1 fused_intersect", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/fused_intersect.cu",
         "replaces": "statmc_tpu/accel/fused.py:237",
         "launches": launches["B1"], "main_path_ms": path_ms["B1"],
         "max_abs_err": max(v["err"] for v in b1.values()),
         "ms": b1["staircase"]["ms"],
         "plain_ms": b1["staircase"]["plain_ms"],
         "bound_ms": b1["staircase"]["bound_ms"],
         "bound_by": b1["staircase"]["bound_by"], "library_ms": None},
        {"name": "B2 stat_filter", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/stat_filter.cu",
         "replaces": "statmc_tpu/denoise/filter_pallas.py:50",
         "launches": launches["B2"], "main_path_ms": path_ms["B2"],
         "max_abs_err": max(v["err"] for v in (*b2.values(), *b2r.values())),
         "ms": b2[True]["ms"], "plain_ms": b2[True]["plain_ms"],
         "bound_ms": b2[True]["bound_ms"], "bound_by": b2[True]["bound_by"],
         "library_ms": None,
         # The same on the render's own inputs (iteration 2's denoise).
         "render_ms": b2r[True]["ms"], "render_plain_ms": b2r[True]["plain_ms"],
         "render_bound_ms": b2r[True]["bound_ms"],
         "render_accepted": b2r[True]["accepted"]},
        # B3/B4: ms and bound_ms on all `blocks` of the camera rays;
        # plain_ms on the `plain_blocks` blocks where the two were
        # compared (all for B3), and for B4 the kernel's subset_ms on them.
        {"name": "B3 twolevel_cull", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/twolevel_cull.cu",
         "replaces": "statmc_tpu/accel/twolevel.py:249",
         "launches": launches["B3"], "main_path_ms": path_ms["B3"],
         "max_abs_err": max(v["cull_err"] for v in b34.values()),
         "ms": cam["cull_ms"], "plain_ms": cam["cull_plain_ms"],
         "bound_ms": cam["b3"][0], "bound_by": cam["b3"][1],
         "library_ms": None, "blocks": cam["blocks"],
         "plain_blocks": cam["blocks"]},
        {"name": "B4 twolevel_walk", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/twolevel_walk.cu",
         "replaces": "statmc_tpu/accel/twolevel.py:406",
         "launches": launches["B4"], "main_path_ms": path_ms["B4"],
         "max_abs_err": max(v["walk_err"] for v in b34.values()),
         "ms": cam["walk_ms"], "plain_ms": cam["walk_plain_ms"],
         "bound_ms": cam["b4"][0], "bound_by": cam["b4"][1],
         "library_ms": None, "blocks": cam["blocks"],
         "plain_blocks": cam["plain_blocks"],
         "subset_ms": cam["walk_sub_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    sys.exit(main(kernels_only="--kernels" in argv,
                  other_tree=(argv[argv.index("--other") + 1]
                              if "--other" in argv else None)))
