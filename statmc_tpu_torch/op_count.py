"""Eager ops per bounce step, counted on the CPU: what the host loop
launches on the card, one kernel an op, with the intersectors' plain
versions counted as the one kernel each stands for.

    python -m statmc_tpu_torch.op_count

renders one iteration of a small staircase proxy and of the hair + SSS
staircase (1 spp, maxdepth 8) on the CPU under torch.profiler and prints,
for each, the ops per bounce step and, for the hair + SSS scene, the ops
per call inside each ``hair.*`` / ``sss.*`` range, per intersect call
(intersect_scene, occluded_scene) and per threefry draw site
(uniform_1d / uniform_2d), each counted without the ranges nested in
it.
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
from .render import integrator, intersect
from .testscenes import hair_sss_scene_text, scene_text

_PLAIN = "count.plain"  # the intersectors' plain versions: one kernel
_SITES = {"count.draw": ((rng, "uniform_1d"), (rng, "uniform_2d")),
          "count.intersect": ((intersect, "intersect_scene"),
                              (intersect, "occluded_scene"),
                              (integrator, "intersect_scene"),
                              (integrator, "occluded_scene"))}


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
    step = integrator._bounce_step

    def counted_step(*a, **k):
        steps[0] += 1
        return step(*a, **k)

    old.append((integrator, "_bounce_step", step))
    integrator._bounce_step = counted_step
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
            if e.name.startswith(("hair.", "sss.", "count.")):
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
            if inner is None and parent.name.startswith(
                    ("hair.", "sss.", "count.")):
                inner = parent.name
            parent = parent.cpu_parent
        else:
            total += 1
            if inner is not None:
                ops[inner] += 1
    n = max(steps[0], 1)
    return steps[0], total / n, {k: (calls[k], ops[k] / max(calls[k], 1))
                                 for k in sorted(calls) if k != _PLAIN}


def main() -> None:
    torch.set_num_threads(4)
    kw = dict(width=16, height=12, spp=1, iterations=1, maxdepth=8,
              denoise=False)
    for name, text in (("staircase", scene_text(**kw)),
                       ("hair + SSS staircase",
                        hair_sss_scene_text(curves=32, **kw))):
        steps, per_step, ranges = count(text)
        print(f"{name}: {steps} bounce steps, {per_step:.0f} ops a step"
              + "".join(f"; {k} {c} calls, {o:.0f} ops a call"
                        for k, (c, o) in ranges.items()), flush=True)


if __name__ == "__main__":
    main()
