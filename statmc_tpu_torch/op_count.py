"""Eager ops per bounce step, counted on the CPU: what the host loop
launches on the card, one kernel an op, with the intersectors' plain
versions counted as the one kernel each stands for.

    python -m statmc_tpu_torch.op_count

renders one iteration of a small staircase proxy, of the hair + SSS
staircase and of three volpath staircases (a homogeneous haze; the haze
and a grid smoke in a glass tank; the haze, a grid smoke behind a null
box and Fourier materials) (1 spp, maxdepth 8) on the CPU under
torch.profiler and prints, for each, the ops per bounce step and the
ops per call inside each ``hair.*`` / ``sss.*`` / ``volume.*`` /
``fourier.*`` range, per intersect call (intersect_scene,
occluded_scene) and per threefry draw site (uniform_1d / uniform_2d, and
a tracking iteration's two uniforms), each counted without the ranges
nested in it.  A volpath step runs on the lanes still active, so its
count falls as paths end.
"""
from __future__ import annotations

import collections
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

from .accel import fused, twolevel
from .core import rng
from .driver import load
from .render import integrator, intersect, volume
from .testscenes import (hair_sss_scene_text, media_text, scene_text,
                         volpath_scene_text)

_PLAIN = "count.plain"  # the intersectors' plain versions: one kernel
_SITES = {"count.draw": ((rng, "uniform_1d"), (rng, "uniform_2d"),
                         (volume, "_iteration_uniforms")),
          "count.intersect": ((intersect, "intersect_scene"),
                              (intersect, "occluded_scene"),
                              (integrator, "intersect_scene"),
                              (integrator, "occluded_scene"),
                              (volume, "intersect_scene"))}
_RANGES = ("hair.", "sss.", "volume.", "fourier.", "count.")


def _ranged(name, fn):
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


def count(text: str):
    """(bounce steps, ops a step, {range: (calls, ops a call)}) of one
    iteration of the scene `text` on the CPU."""
    patches = [(fused, "intersect_plain"), (twolevel, "cull_plain"),
               (twolevel, "walk_plain")]
    old = [(m, n, getattr(m, n)) for m, n in patches]
    for m, n in patches:
        setattr(m, n, _ranged(_PLAIN, getattr(m, n)))
    for name, sites in _SITES.items():
        for m, n in sites:
            old.append((m, n, getattr(m, n)))
            setattr(m, n, _ranged(name, getattr(m, n)))
    steps = [0]
    for mod, name in ((integrator, "_bounce_step"),
                      (volume, "_volpath_step")):
        step = getattr(mod, name)

        def counted_step(*a, _step=step, **k):
            steps[0] += 1
            return _step(*a, **k)

        old.append((mod, name, step))
        setattr(mod, name, counted_step)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "scene.pbrt")
            with open(path, "w") as f:
                f.write(text)
            r = load(path, device="cpu")
        r.progress = False
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            r.run_iteration(1)
    finally:
        for m, n, fn in old:
            setattr(m, n, fn)
    total, calls = 0, collections.Counter()
    ops = collections.Counter()
    for e in prof.events():
        if not e.name.startswith("aten::"):
            if e.name.startswith(_RANGES):
                calls[e.name] += 1
            if e.name == _PLAIN:
                total += 1
            continue
        parent = e.cpu_parent
        if parent is not None and parent.name.startswith("aten::"):
            continue  # an op inside an op: not launched on its own
        inner = None
        while parent is not None:
            if parent.name == _PLAIN:
                break
            if inner is None and parent.name.startswith(_RANGES):
                inner = parent.name
            parent = parent.cpu_parent
        else:
            total += 1
            if inner is not None:
                ops[inner] += 1
    n = max(steps[0], 1)
    return steps[0], total / n, {k: (calls[k], ops[k] / max(calls[k], 1))
                                 for k in sorted(calls) if k != _PLAIN}


def _volpath_texts(tmp: str, kw: dict) -> list:
    """The three volpath staircases (module docstring), grids of 16^3."""
    plain = scene_text(**kw)
    return [("volpath haze", media_text(plain, None, 16, 0,
                                        boundary=None)),
            ("volpath haze + grid (glass tank)",
             media_text(plain, ((0.0, 0.05, -3.5), (3.0, 3.05, -0.5)), 16,
                        0, boundary="glass")),
            ("volpath haze + grid + null + Fourier",
             volpath_scene_text(tmp, grid=16, **kw))]


def main() -> None:
    torch.set_num_threads(4)
    kw = dict(width=16, height=12, spp=1, iterations=1, maxdepth=8,
              denoise=False)
    with tempfile.TemporaryDirectory() as tmp:
        scenes = [("staircase", scene_text(**kw)),
                  ("hair + SSS staircase",
                   hair_sss_scene_text(curves=32, **kw)),
                  *_volpath_texts(tmp, kw)]
        for name, text in scenes:
            steps, per_step, ranges = count(text)
            print(f"{name}: {steps} bounce steps, {per_step:.0f} ops a step"
                  + "".join(f"; {k} {c} calls, {o:.0f} ops a call"
                            for k, (c, o) in ranges.items()), flush=True)


if __name__ == "__main__":
    main()
