#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (statmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the exit code is non-zero
and the final line is not printed:

1. require CUDA and print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from statmc_tpu_torch/csrc/ with nvcc;
3. kernel B1 (fused intersector) against its plain PyTorch version on the
   staircase proxy's table and on a 16,384-triangle table, 2^20 rays;
4. kernel B2 (statistical filter) against its plain version at 1280x720,
   radius 20, C = 3, G = 6, CF = 3, normalized and not;
5. the main path: ``load(scene).render(iterations=2)`` on the staircase
   proxy at 1280x720, maxdepth 8, filter radius 20, albedo + normal
   G-buffers, 4 spp, with both kernels' launch counts read around it;
6. the same call on a small staircase proxy (32x24) on the card and
   through the plain PyTorch path on the CPU, which the CPU tests hold
   against the JAX package: the buffers must agree;
7. one JSON line of per-kernel results, then the device line.

Times are CUDA-event medians of 10 runs after 3 warm-ups, printed with
the card's name and power limit.  Imports nothing of JAX.
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
# The small reference render (phase 6) and the share of its pixels that
# must agree between the card and the CPU in every buffer (0.9961 at
# worst on an NVIDIA H100 80GB HBM3 at 700 W, with equal ray totals).
SMALL_W, SMALL_H, SMALL_SHARE = 32, 24, 0.98


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
        args = (ft.edge_table, ft.plane_table, raye, rayp, t_max)
        t_k, id_k = F.intersect_tiles(*args)
        t_p, id_p = F.intersect_plain(*args)
        torch.cuda.synchronize()
        same = id_k == id_p
        frac = float(same.float().mean())
        err = float((t_k - t_p)[same].abs().max())
        rel_ok = bool(torch.all(torch.abs(t_k - t_p)[same]
                                <= 1e-6 * torch.abs(t_p)[same]))
        if frac < 0.9999 or not rel_ok:
            raise AssertionError(f"B1 {name}: ids equal on {frac:.6f} of "
                                 f"rays, t within rtol 1e-6: {rel_ok}")
        ms = _median_ms(lambda: F.intersect_tiles(*args))
        plain_ms = _median_ms(lambda: F.intersect_plain(*args))
        hits = int((id_k >= 0).sum())
        print(f"B1 {name}: {ft.n_tris} tris, {N_RAYS} rays, {hits} hits, "
              f"ids equal {frac:.6f}, max |dt| {err:.3e}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain_ms, err=err)
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


def phase_b2(rng, card):
    """Kernel B2 against its plain version at the production shape."""
    import torch

    from statmc_tpu_torch.denoise import filter_cuda as FC

    mc, d2, fm, gb, valid = _filter_inputs(rng)
    gf = (-0.5 / 0.02 ** 2,) * 3 + (-0.5 / 0.1 ** 2,) * 3
    ds = -0.5 / 10.0 ** 2
    out = {}
    for normalize in (True, False):
        args = (mc, d2, fm, gb, valid, RADIUS, ds, gf, normalize)
        o_k, w_k = FC.run_filter(*args)
        o_p, w_p = FC.run_filter_plain(*args)
        torch.cuda.synchronize()
        # The kernel sums the window in the plain version's order with the
        # same rounding per step; expf and the library exp may still
        # differ in the last bit, hence rtol 1e-4 / atol 1e-6.
        torch.testing.assert_close(o_k, o_p, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(w_k, w_p, rtol=1e-4, atol=1e-6)
        if float(w_k.min()) < 1.0 - 1e-5:
            raise AssertionError(f"B2: min wsum {float(w_k.min())}")
        err = float((o_k - o_p).abs().max())
        ms = _median_ms(lambda: FC.run_filter(*args))
        plain_ms = _median_ms(lambda: FC.run_filter_plain(*args))
        print(f"B2 normalize={normalize}: {WIDTH}x{HEIGHT} r={RADIUS}, max "
              f"|dout| {err:.3e}, min wsum {float(w_k.min()):.6f}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]", flush=True)
        out[normalize] = dict(ms=ms, plain_ms=plain_ms, err=err)
    return out


def phase_main_path(card):
    """load(scene).render(iterations=2) on the card, launch counts
    read around it."""
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
    return launches


def phase_small_reference(card):
    """A small staircase proxy rendered on the card and on the CPU (the
    kernels' plain versions): equal sample counts, and buffers that agree
    up to the paths that an ulp sends elsewhere (tests/test_torch_slice.py
    explains why such paths exist between any two implementations)."""
    import numpy as np

    from statmc_tpu_torch.driver import load

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "staircase-small.pbrt")
        with open(path, "w") as f:
            f.write(scene_small())
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
    print(f"small reference: {SMALL_W}x{SMALL_H} card vs cpu, {len(cpu)} "
          f"buffers, worst {worst} {shares[worst]:.4f} of pixels within "
          f"rtol 1e-4, rays_total {rays['cuda']:.0f} vs {rays['cpu']:.0f} "
          f"[{card}]", flush=True)


def scene_small():
    from statmc_tpu_torch.testscenes import scene_text

    return scene_text(width=SMALL_W, height=SMALL_H, spp=2, iterations=2,
                      maxdepth=4, denoise=True, filterradius=2)


def main() -> int:
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    b1 = phase_b1(rng, card)
    b2 = phase_b2(rng, card)
    launches = phase_main_path(card)
    phase_small_reference(card)
    kernels = [
        {"name": "B1 fused_intersect", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/fused_intersect.cu",
         "replaces": "statmc_tpu/accel/fused.py:237",
         "launches": launches["B1"],
         "max_abs_err": max(v["err"] for v in b1.values()),
         "ms": b1["staircase"]["ms"],
         "plain_ms": b1["staircase"]["plain_ms"]},
        {"name": "B2 stat_filter", "route": "cuda",
         "source": "statmc_tpu_torch/csrc/stat_filter.cu",
         "replaces": "statmc_tpu/denoise/filter_pallas.py:50",
         "launches": launches["B2"],
         "max_abs_err": max(v["err"] for v in b2.values()),
         "ms": b2[True]["ms"], "plain_ms": b2[True]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
