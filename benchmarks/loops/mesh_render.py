"""The loop ``mesh_render``: ``render_jobs``'s job on a mesh of ranks, one
card a rank.

The configuration's ``mesh`` block gives the mesh ({"spp": n_spp, "px":
n_px, "backend": ...}).  The port's launcher
(``statmc_tpu_torch.parallel.launch.start_world``) makes this process
rank 0, on the run's device, and spawns ranks 1 .. n-1 on the next cards
(statbench/mesh_rank.py ``serve``); so set-up holds their start, imports,
the world's init and their scenes, as a deployment's does.  Every rank
runs the same steps (SPMD): before each one rank 0 broadcasts it, once a
job, outside the iterations.

A job is iterations 1..N of the configuration on fresh state under a new
base key drawn from the seed, the same on every rank; jobs follow one
another while the window is open, and the job running at the close
finishes and counts.  ``samples_per_s`` is every pixel sample of the
window's whole jobs over rank 0's wall time to the end of the last job,
after a barrier of every rank.  The window's first job is captured: each
rank captures its own share of the pixels, lanes and filter centres drawn
over the whole image (one centre's window straddles a seam between the
px slabs) and sends it to rank 0 after the window; ``check`` puts the
shares together (statbench/meshjudge.py) and judges them as
``render_jobs`` judges a job.

The mix's parameters are render_jobs's.  The CPU tests' overrides may
add "devices" (one a rank; by default cuda:0 .. cuda:n-1, or the CPU for
a run on the CPU), "world_timeout_s" and "plant" (a function the spawned
ranks call with setattr before they build their renderer).
"""
from __future__ import annotations

import sys
import time

import torch

from statbench import mesh_rank as M
from statbench import meshjudge

# The world's bound on a collective, and on the ranks' exit, in s.
WORLD_TIMEOUT_S = 180


class Loop:
    """render_jobs's jobs on every rank of the configuration's mesh."""

    def __init__(self, cell, seed: int, device, overrides=None):
        try:
            from statmc_tpu_torch.parallel.launch import start_world
        except ImportError as e:
            raise RuntimeError(
                "mesh_render: the port has no parallel.launch.start_world, "
                "the launcher that makes this process rank 0; this cell "
                "cannot run on it") from e
        ov = overrides or {}
        shape = cell["config"]["mesh"]
        n_spp, n_px = int(shape["spp"]), int(shape["px"])
        n = n_spp * n_px
        devices = ov.get("devices") or (
            [str(device)] * n if device.type == "cpu"
            else [f"cuda:{device.index + i}" for i in range(n)])
        timeout = ov.get("world_timeout_s", WORLD_TIMEOUT_S)
        self.cell, self.device, self.n_spp = cell, device, n_spp
        self.world = start_world(
            M.serve, n_spp, n_px, (cell, seed, overrides, timeout,
                                   ov.get("plant")),
            devices=devices, timeout=timeout, threads=1)
        try:
            mesh = self.world.mesh
            if overrides is None and mesh.backend != shape["backend"]:
                raise RuntimeError(
                    f"mesh_render: the configuration asks for "
                    f"{shape['backend']}, the world runs {mesh.backend}")
            self.rank = M.Rank(mesh, cell, seed, overrides, timeout)
        except BaseException:
            self._end(sys.exc_info())
            raise
        r = self.rank
        self.job_samples = r.W * r.H * r.spp
        self.kept = None

    def _end(self, exc):
        """Ends the world on rank 0's error (World.__exit__: the spawned
        ranks are killed, and a rank's own error, if one failed first, is
        raised from rank 0's)."""
        world, self.world = self.world, None
        if world is not None:
            world.__exit__(*exc)

    def _step(self, cmd: int):
        """Rank 0's side of a step: broadcast it, then run it."""
        try:
            self.rank.command(cmd)
            return self.rank.run(cmd)
        except BaseException:
            self._end(sys.exc_info())
            raise

    def warm_up(self):
        self._step(M.WARM_UP)

    def _keep(self, shares, part: int):
        """What check needs of the captured job, once the renderer is
        gone."""
        self.kept = {"shares": shares, "draws": self.rank.draws(part),
                     "text": self.rank.text, "geo": self.rank.geo,
                     "cfg": self.rank.cfg}

    def window(self, seconds: float) -> dict:
        """The end-to-end window: jobs until `seconds` have passed, the
        first captured."""
        self._step(M.BARRIER)
        jobs_s = []
        t0 = time.perf_counter()
        while not jobs_s or time.perf_counter() < t0 + seconds:
            t = time.perf_counter()
            self._step(M.CAPTURED_JOB if not jobs_s else M.JOB)
            jobs_s.append(time.perf_counter() - t)
        self._step(M.BARRIER)
        elapsed = time.perf_counter() - t0
        self._keep(self._step(M.SEND), 0)
        samples = len(jobs_s) * self.job_samples
        return {"samples_per_s": samples / elapsed / 1e6,
                "jobs": len(jobs_s), "samples": samples,
                "elapsed_s": elapsed, "jobs_s": jobs_s}

    def traced(self, seconds: float) -> dict:
        """One job untraced (rank 0's wall time), then one job under the
        profiler on every rank, captured for the check; every rank's
        spans and counters of the traced job come to rank 0."""
        self._step(M.BARRIER)
        t = time.perf_counter()
        span_logs, _ = self._step(M.JOB)
        untraced_s = time.perf_counter() - t
        _, events = self._step(M.TRACED_JOB)
        shares = self._step(M.SEND)
        self._keep(shares, 1)
        return {"span_logs": span_logs, "trace": events,
                "spp": self.rank.spp, "untraced_job_s": untraced_s,
                "rank_spans": [sh["spans"] for sh in shares]}

    def release(self):
        """Stop the ranks and leave the world; rank 0's renderer is freed,
        the captured shares stay."""
        if self.world is not None:
            try:
                self.rank.command(M.STOP)
            except BaseException:
                self._end(sys.exc_info())
                raise
            world, self.world = self.world, None
            world.close()
        self.rank = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------

    def check(self, control: bool = False, notes=None):
        k = self.kept
        if notes is not None:
            notes.append(
                "mesh: memory_peak_bytes by rank "
                + str([sh["memory_peak_bytes"] for sh in k["shares"]])
                + f"; denoise on slabs {k['shares'][0]['slabs']}")
        return meshjudge.render_check(
            k["shares"], k["draws"], k["text"], k["geo"], k["cfg"],
            self.cell["limits"], self.n_spp, self.device, control, notes)
