"""Eager ops per bounce step, counted on the CPU: what the host loop
launches on the card, one kernel an op, with the intersectors' and
threefry's (R1, core/rng.py:site_hash_plain) plain versions counted as
the one kernel each stands for.

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
count falls as paths end.  Then the same for the realistic staircase
(``count.realistic_generate``: one lens-camera generate), the kd-tree
staircase (``count.kd_walk``: one walk, also divided by its steps), the
staircase under ao (8 probes; ``count.ao_probe``: one probe) and under
sppm (4,096 photons, maxdepth 5; ``count.sppm_camera_step`` and
``count.sppm_photon_step``: one bounce of each pass, the photon step's
grid deposit included, ``count.sppm_deposit`` apart), under bdpt
(maxdepth 5, 1 spp: ``count.bdpt_sample`` is one sample's ops outside
the ``bdpt.camera_walk``, ``bdpt.light_walk``, ``bdpt.connect`` and
``bdpt.splat`` ranges, which count the walks, the 26 strategies'
connections and the t = 1 splats' scatter) and under mlt (maxdepth 5,
bidirectional, 1,024 chains and a 8,192-path bootstrap: the op counts of
a step do not depend on the chain count; ``count.mlt_step`` is one
mutation step's ops outside f's ``bdpt.*`` ranges, ``count.mlt_bootstrap``
the bootstrap's).  Under the profiler the port's spans record
(spans.py), so each intersect call also counts its live lanes: three ops
a call that an untraced step does not launch.
"""
from __future__ import annotations

import collections
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

from . import spans
from .accel import fused, kdtree, twolevel
from .core import rng
from .driver import load
from .render import (ao, bdpt, integrator, intersect, pssmlt, realistic, sppm,
                     volume)
from .testscenes import (BICONVEX, ao_scene_text, bdpt_scene_text,
                         hair_sss_scene_text, kdtree_scene_text, media_text,
                         mlt_scene_text, realistic_scene_text, scene_text,
                         sppm_scene_text, volpath_scene_text)

_PLAIN = "count.plain"  # the kernels' plain versions: one kernel each
_SITES = {"count.draw": ((rng, "uniform_1d"), (rng, "uniform_2d"),
                         (volume, "_iteration_uniforms")),
          "count.intersect": ((intersect, "intersect_scene"),
                              (intersect, "occluded_scene"),
                              (integrator, "intersect_scene"),
                              (integrator, "occluded_scene"),
                              (volume, "intersect_scene"),
                              (ao, "intersect_scene"), (ao, "occluded_scene"),
                              (sppm, "intersect_scene"),
                              (sppm, "occluded_scene"),
                              (bdpt, "intersect_scene"),
                              (bdpt, "occluded_scene")),
          "count.realistic_generate": ((realistic,
                                        "generate_rays_realistic"),),
          "count.kd_walk": ((intersect, "intersect_kdtree"),),
          "count.ao_probe": ((ao.AORenderer, "_probe"),),
          "count.sppm_camera_step": ((sppm.SPPMRenderer, "_camera_step"),),
          "count.sppm_photon_step": ((sppm.SPPMRenderer, "_photon_step"),),
          "count.sppm_deposit": ((sppm, "deposit_grid"),),
          "count.bdpt_sample": ((bdpt.BDPTRenderer, "one_sample"),),
          "count.mlt_step": ((pssmlt.MLTRenderer, "step"),),
          "count.mlt_bootstrap": ((pssmlt.MLTRenderer, "_bootstrap"),)}
_RANGES = ("hair.", "sss.", "volume.", "fourier.", "bdpt.", "count.")


def count(text: str):
    """(bounce steps, ops a step, {range: (calls, ops a call)}) of one
    iteration of the scene `text` on the CPU."""
    patches = [(fused, "intersect_plain"), (twolevel, "cull_plain"),
               (twolevel, "walk_plain"), (rng, "site_hash_plain")]
    old = [(m, n, getattr(m, n)) for m, n in patches]
    for m, n in patches:
        setattr(m, n, spans.spanned(_PLAIN)(getattr(m, n)))
    for name, sites in _SITES.items():
        for m, n in sites:
            old.append((m, n, getattr(m, n)))
            setattr(m, n, spans.spanned(name)(getattr(m, n)))
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
            if e.name == _PLAIN:  # one kernel, in the range around it
                total += 1
                parent = e.cpu_parent
                while (parent is not None
                       and not parent.name.startswith(_RANGES)):
                    parent = parent.cpu_parent
                if parent is not None:
                    ops[parent.name] += 1
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
        lens = os.path.join(tmp, "biconvex.dat")
        with open(lens, "w") as f:
            f.write(BICONVEX)
        scenes = [("staircase", scene_text(**kw)),
                  ("hair + SSS staircase",
                   hair_sss_scene_text(curves=32, **kw)),
                  *_volpath_texts(tmp, kw),
                  ("realistic staircase", realistic_scene_text(lens, **kw)),
                  ("kd-tree staircase", kdtree_scene_text(**kw)),
                  ("ao staircase", ao_scene_text(
                      nsamples=8, **{**kw, "maxdepth": 1})),
                  ("sppm staircase", sppm_scene_text(
                      photons=4096, **{**kw, "maxdepth": 5,
                                       "iterations": 1})),
                  ("bdpt staircase", bdpt_scene_text(
                      **{**kw, "maxdepth": 5})),
                  ("mlt staircase", mlt_scene_text(
                      **{**kw, "maxdepth": 5}))]
        pssmlt.N_CHAINS, pssmlt.N_BOOTSTRAP = 1024, 8192
        for name, text in scenes:
            kdtree.walk_stats = []
            try:
                steps, per_step, ranges = count(text)
                walks = kdtree.walk_stats
            finally:
                kdtree.walk_stats = None
            line = (f"{name}: {steps} bounce steps, {per_step:.0f} ops a "
                    "step" if steps else f"{name}: {per_step:.0f} ops")
            print(line + "".join(f"; {k} {c} calls, {o:.0f} ops a call"
                                 for k, (c, o) in ranges.items()), flush=True)
            if walks:
                n_steps = sum(w["steps"] for w in walks)
                c, o = ranges["count.kd_walk"]
                print(f"  kd walk: {len(walks)} calls, {n_steps / len(walks):.0f}"
                      f" steps a call (max {max(w['steps'] for w in walks)},"
                      f" cap {walks[0]['cap']}), {o * c / n_steps:.1f} ops a "
                      "step", flush=True)


if __name__ == "__main__":
    main()
