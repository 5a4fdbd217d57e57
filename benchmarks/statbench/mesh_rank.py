"""The ranks of the loop ``mesh_render``: a render job's steps, run alike
on every rank of the mesh (SPMD).

Rank 0 is run.py's own process (``loops/mesh_render.py`` holds its
``Rank``); ranks 1 .. n-1 are started by the port's launcher
(``statmc_tpu_torch/parallel/launch.py`` ``start_world``) and run
``serve``, which obeys rank 0: before each step rank 0 broadcasts the
step's command on a gloo group of the world, one small broadcast outside
the iterations.  A spawned rank imports this module by its name, which
it could not do with a loop loaded from its file path.

Each rank builds the job through the port's normal path,
``driver.load(..., mesh=mesh)`` and ``Renderer.run_iteration``: rank k
sits at (spp, px) = divmod(k, n_px), holds the px slab of the film, the
moment states and the feedback, and the scene whole.  For the check,
each rank captures its own share (``capture.Capture`` on its slab) of
the pixels and lanes drawn from the seed over the whole image, and sends
it, with its moment states, film and film-f there, to rank 0 after the
window, outside the timing (``meshjudge.py`` puts the shares together).
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from statbench import capture, cells, judge, trace
from statbench.common import derive_seed, from_file, sync

# Rank 0's commands.
STOP, WARM_UP, JOB, CAPTURED_JOB, TRACED_JOB, BARRIER, SEND = range(7)

# The job number whose base key the warm-up renders under: no job of a
# window reaches it.
WARM_UP_JOB = 1 << 30


def serve(mesh, cell, seed, overrides, timeout, plant=None):
    """A spawned rank's task: build the rank, then run rank 0's commands
    until STOP.  plant(setattr), the CPU tests' fault, runs first."""
    if plant is not None:
        plant(setattr)
    rank = Rank(mesh, cell, seed, overrides, timeout)
    while (cmd := rank.command()) != STOP:
        rank.run(cmd)


class Rank:
    """One rank's renderer and its share of the check."""

    def __init__(self, mesh, cell, seed, overrides, timeout):
        from statmc_tpu_torch.driver import load

        self.mesh, self.seed = mesh, int(seed)
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout))
        self.cfg = cells.effective(cell["config"], overrides)
        self.params = cell["traffic"]
        self.text, self.geo = cells.scene(self.cfg)
        self.r = from_file(self.text, lambda path: load(
            path, base_seed=derive_seed(seed, 0), device=mesh.device,
            mesh=mesh))
        self.r.progress = False
        s = self.r.s
        self.W, self.H = s.width, s.height
        self.n_iter = s.ecfg.iterations
        self.spp = self.r.total_spp(self.n_iter)
        self.job_no = 0
        self.share = None  # what SEND sends of the last captured job

    # -- the protocol ----------------------------------------------------

    def command(self, cmd: int | None = None) -> int:
        """Rank 0 passes the next command; every rank returns it."""
        t = torch.tensor([-1 if cmd is None else cmd])
        dist.broadcast(t, 0, group=self.group)
        return int(t)

    def run(self, cmd: int):
        """Runs a command; rank 0 gets what it returns (the job's logs and
        the device trace; SEND: every rank's share, in rank order)."""
        if cmd == WARM_UP:
            return self.warm_up()
        if cmd == JOB:
            return self.job()
        if cmd == CAPTURED_JOB:
            return self.job(capture_part=0)
        if cmd == TRACED_JOB:
            return self.job(capture_part=1, profiled=True)
        if cmd == BARRIER:
            return dist.barrier(group=self.group)
        if cmd == SEND:
            shares = None
            if self.mesh.rank == 0:
                shares = [None] * dist.get_world_size()
            dist.gather_object(self.share, shares, dst=0, group=self.group)
            return shares
        raise ValueError(f"mesh_render: no command {cmd}")

    # -- the job ---------------------------------------------------------

    def warm_up(self):
        """One iteration at the cell's shapes: every later iteration runs
        the same chunk of samples a call and the same denoise."""
        self._start_job(WARM_UP_JOB)
        self.r.run_iteration(1)
        sync(self.mesh.device)

    def _start_job(self, job: int):
        self.r.s.base_seed = derive_seed(self.seed, 1, job)
        self.r.reset()

    def job(self, capture_part: int | None = None, profiled: bool = False):
        """Iterations 1..N on fresh state under the job's base key (the
        same on every rank); with capture_part, this rank's share of the
        check is captured and kept; profiled, the job runs under the
        profiler on every rank (so that the ranks keep pace with one
        another and record their spans), and rank 0 reads its device's
        trace."""
        cap = None if capture_part is None else self._capture(capture_part)
        marks, logs = [], []
        before = spans_counters() if profiled else None
        prof = trace.Profiled(self.mesh.device) if profiled else None
        if prof is not None:
            prof.__enter__()
        try:
            marks.append((trace.now_ns(), "job reset"))
            self._start_job(self.job_no)
            if cap is not None:
                cap.install()
            try:
                for i in range(1, self.n_iter + 1):
                    if cap is not None:
                        cap.iteration = i
                    marks.append((trace.now_ns(), f"iteration {i}"))
                    logs.append(self.r.run_iteration(i))
            finally:
                if cap is not None:
                    cap.remove()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        self.job_no += 1
        if cap is not None:
            self.share = self._share(cap)
        if prof is None:
            return logs, None
        self.share["spans"] = spans_delta(before)
        return logs, prof.read(marks) if self.mesh.rank == 0 else None

    # -- the check's share -----------------------------------------------

    def draws(self, part: int):
        """The seed's pixels over the whole image, as render_jobs draws
        them: `check_pixels` pixels, `filter_centres` centres (the last
        within the filter radius of a seam between two px slabs, so that
        its window straddles the halo) with every pixel of their windows,
        and `path_lanes` lanes last.  Returns (pixels, lanes, centres),
        global pixel ids on the CPU."""
        P, W, H = self.W * self.H, self.W, self.H
        g = torch.Generator(device="cpu")
        g.manual_seed(derive_seed(self.seed, 2, part))
        check = torch.randperm(P, generator=g)[
            :min(int(self.params["check_pixels"]), P)]
        n_c = int(self.params["filter_centres"])
        r = int(cells.setting(self.cfg, "filterradius")[0])
        n_px = self.mesh.shape["px"]
        seams = n_px > 1
        centres = torch.randperm(P, generator=g)[:n_c - 1 if seams else n_c]
        if seams:
            seam = H // n_px * int(torch.randint(1, n_px, (1,),
                                                 generator=g))
            row = seam - r + int(torch.randint(2 * r, (1,), generator=g))
            col = int(torch.randint(W, (1,), generator=g))
            centres = torch.cat([centres, torch.tensor(
                [min(max(row, 0), H - 1) * W + col])])
        off = torch.arange(-r, r + 1)
        window = []
        for c in centres.tolist():
            ys, xs = c // W + off, c % W + off
            ys, xs = ys[(ys >= 0) & (ys < H)], xs[(xs >= 0) & (xs < W)]
            window.append((ys[:, None] * W + xs[None, :]).reshape(-1))
        lanes = torch.randperm(P, generator=g)[
            :min(int(self.params["path_lanes"]), P)]
        return torch.cat([check] + window + [lanes]), lanes, centres

    def _capture(self, part: int):
        """A Capture of this rank's share: the drawn pixels and lanes in
        its slab [lo, lo + Pl), as indices into the slab, with their
        positions in the drawn lists."""
        pixels, lanes, centres = self.draws(part)
        lo, Pl, dev = self.r.lo, self.r.Pl, self.mesh.device

        def mine(x):
            return torch.nonzero((x >= lo) & (x < lo + Pl))[:, 0]

        pos, lane_pos, centre_pos = mine(pixels), mine(lanes), mine(centres)
        cap = capture.Capture(
            Pl, (pixels[pos] - lo).to(dev),
            derive_seed(self.seed, 3, part, self.mesh.rank), dev,
            self.params["rays_per_call"],
            lanes=(lanes[lane_pos] - lo).to(dev))
        cap.pos, cap.lane_pos, cap.centre_pos = pos, lane_pos, centre_pos
        cap.centres = (centres[centre_pos] - lo).to(dev)
        return cap

    def _share(self, cap) -> dict:
        """What rank 0 needs of this rank's captured job, on the CPU: the
        captured samples, bounces and queries with their positions in the
        drawn lists; at spp index 0 (the px column's ranks hold the same
        merged states and film) the moment states and the last film at
        the pixels, and film-f at the centres."""
        r, m = self.r, self.mesh
        samples, s_its = cap.sample_tensor()
        before, after, n_its = cap.step_tensors()
        share = {
            "rank": m.rank, "spp_index": m.spp_index, "px_index": m.px_index,
            "pos": cap.pos, "lane_pos": cap.lane_pos,
            "samples": samples.cpu(), "sample_its": s_its,
            "before": before.cpu(), "after": after.cpu(), "step_its": n_its,
            "hits": [torch.cat(cap.hits).cpu()] if cap.hits else [],
            "shadows": [torch.cat(cap.shadows).cpu()] if cap.shadows else [],
            "base_seed": r.s.base_seed, "spp": self.spp, "slabs": r._slabs,
            "memory_peak_bytes": (torch.cuda.max_memory_reserved(m.device)
                                  if m.device.type == "cuda" else 0)}
        if m.spp_index == 0:
            px = cap.pixels
            share["states"] = {t: {k: v[:, px].cpu()
                                   for k, v in r.states[t].items()}
                               for t in judge._streams().values()}
            share["film"] = r._film_rgb(r.film_sum, r.film_w)[px].cpu()
            share["centre_pos"] = cap.centre_pos
            share["film_f"] = (None if r.film_f is None else
                               r.film_f.reshape(-1, 3)[cap.centres].cpu())
        return share


def spans_counters() -> dict:
    """The port's counters now (its spans record only while a profiler
    runs, so a traced job's spans are its own)."""
    from statmc_tpu_torch import spans

    return spans.snapshot()["counters"]


def spans_delta(before: dict) -> dict:
    """This rank's spans, and its counters' growth since `before`."""
    from statmc_tpu_torch import spans

    snap = spans.snapshot()
    snap["counters"] = {k: v - before.get(k, 0)
                        for k, v in snap["counters"].items()}
    return snap
