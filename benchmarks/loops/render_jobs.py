"""The loop ``render_jobs``: a researcher's render job, a closed loop
with one client.

A job is iterations 1..N of the configuration (its ``iterations``
setting) on fresh state under a new base key drawn from the seed; jobs
follow one another while the window is open, and the job running at the
close finishes and counts, so that the window holds whole jobs (the
iterations of a job differ in their cost a sample).  Every iteration
renders, denoises when the configuration denoises, and feeds back.

The mix's parameters: ``check_pixels`` (pixels whose every sample the
check reads), ``filter_centres`` (pixels at which the check filters anew,
with every pixel of their windows read), ``path_lanes`` (lanes whose
every bounce the check replays) and ``rays_per_call`` (closest-hit and
shadow queries kept a call).

``Loop`` builds the program's objects in ``__init__`` (set-up), warms up
every shape of the window in ``warm_up``, then runs ``window`` (end to
end) or ``traced`` (per layer) and, after the program's state is
released (``release``), ``check`` (the numbers that decide ``correct``).
"""
from __future__ import annotations

import time

import torch

from statbench import capture, cells, judge, trace
from statbench.common import derive_seed, from_file, sync

# The job number whose base key the warm-up renders under: no job of a
# window reaches it.
WARM_UP_JOB = 1 << 30


class Loop:
    """Iterations 1..N of the configuration, job after job."""

    def __init__(self, cell, seed: int, device, overrides=None):
        from statmc_tpu_torch.driver import load

        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = cells.effective(cell["config"], overrides)
        self.params = cell["traffic"]
        self.text, self.geo = cells.scene(self.cfg)
        self.r = from_file(self.text, lambda path: load(
            path, base_seed=derive_seed(seed, 0), device=device))
        self.r.progress = False
        s = self.r.s
        self.W, self.H = s.width, s.height
        self.n_iter = s.ecfg.iterations
        self.job = 0
        self.kept = None

    # -- the loop --------------------------------------------------------

    def _start_job(self, job: int):
        self.r.s.base_seed = derive_seed(self.seed, 1, job)
        self.r.reset()

    def _iteration(self, i: int, marks=None):
        if marks is not None:
            marks.append((trace.now_ns(), f"iteration {i}"))
        log = self.r.run_iteration(i)
        log["samples"] = self.W * self.H * self.r.iteration_spp(i)[1]
        return log

    def warm_up(self):
        """One iteration at the cell's shapes: every later iteration runs
        the same chunk of samples a call and the same denoise."""
        self._start_job(WARM_UP_JOB)
        self._iteration(1)
        sync(self.device)

    def _capture(self, seed_part: int):
        """A Capture for one job: `check_pixels` pixels, every pixel of
        the windows around `filter_centres` pixels, and `path_lanes`
        lanes, all drawn from the seed."""
        P, W, H = self.W * self.H, self.W, self.H
        g = torch.Generator(device="cpu")
        g.manual_seed(derive_seed(self.seed, 2, seed_part))
        k = min(int(self.params["check_pixels"]), P)
        check = torch.randperm(P, generator=g)[:k]
        centres = torch.randperm(P, generator=g)[
            :int(self.params["filter_centres"])]
        r = int(cells.setting(self.cfg, "filterradius")[0])
        off = torch.arange(-r, r + 1)
        window = []
        for c in centres.tolist():
            ys, xs = c // W + off, c % W + off
            ys, xs = ys[(ys >= 0) & (ys < H)], xs[(xs >= 0) & (xs < W)]
            window.append((ys[:, None] * W + xs[None, :]).reshape(-1))
        lanes = torch.randperm(P, generator=g)[
            :min(int(self.params["path_lanes"]), P)]
        # The lanes last: the check finds their recorded samples there.
        pixels = torch.cat([check] + window + [lanes]).to(self.device)
        lanes = lanes.to(self.device)
        cap = capture.Capture(P, pixels, derive_seed(self.seed, 3,
                                                     seed_part),
                              self.device, self.params["rays_per_call"],
                              lanes=lanes)
        cap.centres = centres.to(self.device)
        return cap

    def _job(self, logs, cap=None, marks=None):
        """One job; with `cap`, captured, and its end state kept."""
        if marks is not None:
            marks.append((trace.now_ns(), "job reset"))
        self._start_job(self.job)
        if cap is not None:
            cap.install()
        try:
            for i in range(1, self.n_iter + 1):
                if cap is not None:
                    cap.iteration = i
                logs.append(self._iteration(i, marks))
        finally:
            if cap is not None:
                cap.remove()
        if cap is not None:
            r = self.r
            self.kept = {"cap": cap, "states": r.states,
                         "film": r.film_mean, "film_f": r.film_f,
                         "spp": r.total_spp(self.n_iter),
                         "base_seed": r.s.base_seed,
                         "centres": cap.centres, "text": self.text}
        self.job += 1

    def window(self, seconds: float) -> dict:
        """The end-to-end window: jobs until `seconds` have passed; the
        first job is captured for the check."""
        logs, jobs_s = [], []
        cap = self._capture(0)
        sync(self.device)
        t0 = time.perf_counter()
        while cap is not None or time.perf_counter() < t0 + seconds:
            t = time.perf_counter()
            self._job(logs, cap=cap)
            cap = None
            jobs_s.append(time.perf_counter() - t)
        elapsed = time.perf_counter() - t0
        samples = sum(x["samples"] for x in logs)
        return {"samples_per_s": samples / elapsed / 1e6,
                "iterations": len(logs), "samples": samples,
                "elapsed_s": elapsed, "jobs_s": jobs_s}

    def traced(self, seconds: float) -> dict:
        """One job untraced (the program's own spans), then one job under
        the profiler, captured for the check."""
        span_logs = []
        t = time.perf_counter()
        self._job(span_logs)
        sync(self.device)
        untraced_s = time.perf_counter() - t
        marks, logs = [], []
        cap = self._capture(1)
        prof = trace.Profiled(self.device)
        with prof:
            self._job(logs, cap=cap, marks=marks)
        events = prof.read(marks)
        return {"span_logs": span_logs, "trace": events,
                "spp": self.kept["spp"], "untraced_job_s": untraced_s}

    def release(self):
        """Free the program's renderer; the kept job's state stays."""
        self.r = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------

    def check(self, control: bool = False, notes=None):
        return judge.render_check(self.kept, self.geo, self.cfg,
                                  self.cell["limits"], control, notes)
