"""The loop ``denoise_frames``: back-to-back denoise passes
(``StatDenoiser``) over frames that the benchmark made
(scenes/frames.py), one frame a pass in an order drawn from the seed;
each pass runs from its call to a synchronize.  The frames themselves are
the mix's (its ``frame_seed``), so that every seed gives the card the
same work in another order; the seed also draws the pixels that the
check compares.

``Loop`` has the methods of loops/render_jobs.py's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from statbench import cells, judge, reference as ref, trace
from statbench.common import derive_seed, from_file, sync


class Loop:
    """Back-to-back denoise passes over the benchmark's own frames."""

    def __init__(self, cell, seed: int, device, overrides=None):
        from statmc_tpu_torch.denoise.filter import StatDenoiser
        from statmc_tpu_torch.scene.api import parse_scene
        from statmc_tpu_torch.stats import estimator as E

        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = cells.effective(cell["config"], overrides)
        p = self.params = cell["traffic"]
        desc = from_file(cells.scene(self.cfg)[0], parse_scene)
        W = int(desc.film_params.find_one("xresolution", 640))
        H = int(desc.film_params.find_one("yresolution", 480))
        spp = int(desc.sampler_params.find_one("pixelsamples", 16))
        ecfg = E.derive_config(desc.integrator_params, desc.extra_params,
                               spp)
        self.W, self.H, self.E = W, H, E
        self.den = StatDenoiser(ecfg, W, H, device=device)
        self.radius = self.den.radius
        frames = cells.scene_module("frames")
        self.frames = frames.make(
            H, W, p["frame_seed"], p["frames"], spp, p["shapes"],
            p["levels"], p["sigmas"], p["firefly_rate"], p["firefly_gain"],
            p["layout_seed"], device)
        self.states = [self._states(f) for f in self.frames]
        g = np.random.default_rng(derive_seed(seed, 5))
        self.order = g.permutation(len(self.frames))
        self.kept = {}
        self.n_pass = 0

    def _states(self, f):
        E = self.E
        P = self.H * self.W
        rad = {"n": f["n"].reshape(1, P, 1)}
        for k in ("mean", "m2", "m3", "film_mean", "film_m2"):
            rad[k] = f[k].reshape(1, P, 3)
        return {E.RADIANCE: rad,
                E.STAT_ALBEDO: {"n": rad["n"].clone(),
                                "mean": f["albedo"].reshape(1, P, 3)},
                E.STAT_NORMAL: {"n": rad["n"].clone(),
                                "mean": f["normal"].reshape(1, P, 3)}}

    def _pass(self, events=None):
        j = int(self.order[self.n_pass % len(self.order)])
        st = self.states[j]
        film = self.frames[j]["film_mean"].reshape(self.H, self.W, 3)
        if events is not None:
            events[0].record()
        gbufs = self.den._gbuffers(st)
        res = self.den(st[self.E.RADIANCE], film, gbufs)
        if events is not None:
            events[1].record()
        sync(self.device)
        self.kept[j] = res
        self.n_pass += 1

    def warm_up(self):
        for _ in range(int(self.params["warm_passes"])):
            self._pass()

    def window(self, seconds: float) -> dict:
        cuda = self.device.type == "cuda"
        lat, evs = [], []
        sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        passes = 0
        while True:
            ev = ((torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) if cuda else None)
            a = time.perf_counter()
            self._pass(ev)
            b = time.perf_counter()
            if cuda:
                evs.append(ev)
            else:
                lat.append((b - a) * 1e3)
            passes += 1
            if b >= deadline:
                break
        elapsed = time.perf_counter() - t0
        if cuda:
            lat = [e0.elapsed_time(e1) for e0, e1 in evs]
        return {"denoise_ms": elapsed / passes * 1e3,
                "denoise_p95_ms": float(np.percentile(lat, 95)),
                "passes": passes, "elapsed_s": elapsed}

    def traced(self, seconds: float) -> dict:
        n = int(self.params["traced_passes"])
        first = self.n_pass
        marks = []
        prof = trace.Profiled(self.device)
        with prof:
            for k in range(n):
                marks.append((trace.now_ns(), "pass"))
                self._pass()
        events = prof.read(marks)
        frames_run = [int(self.order[(first + k) % len(self.order)])
                      for k in range(n)]
        return {"trace": events, "frames_run": frames_run}

    def b2_work(self, frames_run):
        """FP32 operations and bytes that B2 needs for the traced passes,
        from the frozen counts (statbench/peaks.py) and the accepted pairs
        of each frame under the reference's test."""
        from statbench import peaks

        tq = ref.t_quantiles()
        per_frame = {}
        for j in set(frames_run):
            f = self.frames[j]
            mc, d = ref.corrected_stats(f["n"], f["mean"], f["m2"], f["m3"],
                                        tq)
            pairs, acc = ref.accepted_pairs(mc.reshape(self.H, self.W, 3),
                                            d.reshape(self.H, self.W, 3),
                                            self.radius)
            per_frame[j] = (pairs, acc)
        G = 3 * len(cells.setting(self.cfg, "filterbuffers"))
        ops = sum(peaks.b2_ops(*per_frame[j]) for j in frames_run)
        nbytes = len(frames_run) * peaks.b2_bytes(self.H * self.W, 3, 3, G)
        pairs = sum(per_frame[j][0] for j in frames_run)
        acc = sum(per_frame[j][1] for j in frames_run)
        return {"ops": ops, "bytes": nbytes, "accepted_share": acc / pairs}

    def release(self):
        self.den = None

    def check(self, control: bool = False, notes=None):
        return judge.denoise_check(self.frames, self.kept, self.H, self.W,
                                   self.cfg, self.cell["limits"], self.seed,
                                   int(self.params["check_pixels"]),
                                   control)
