"""Start the ranks of a mesh and run a task on each.

``run_world(task, n_spp, n_px, args)`` runs ``task(mesh, *args)`` on
n_spp * n_px ranks: one process a rank, started by torch.multiprocessing
(start method spawn) and joined within `timeout`, or this process alone
for a mesh of one.  ``start_world`` starts the same world with this
process as rank 0 and returns a handle (``World``): the caller runs rank
0's part of the program itself and closes the handle, as a program that
reads rank 0's device in its own process (a profiler, peak memory, the
clocks) needs.  The ranks meet through a ``file://`` store in a
temporary directory, so worlds started side by side never share a port.
A rank that raises fails the world: the others are stopped and the error
is raised here.  Under torchrun the command line joins torchrun's world
instead (run_cli).

The tasks live here, in the port, because a spawned rank imports the
module of its target: ``cli_task`` is ``python -m statmc_tpu_torch
--mesh``'s rank; ``render_task``, ``chunk_task``, ``filter_task`` and
``combine_task`` drive the mesh's parts and write rank 0's gathered
results to a file with torch.save, for a caller in another process (the
tests, chip_smoke.py) to read back; ``jobs_task`` renders jobs back to
back on one Renderer.
"""
from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from . import shard


def mesh_shape(text: str, device: str = "cuda"):
    """--mesh's (n_spp, n_px): "SPPxPX", or "auto" for 1 x the CUDA
    devices when there are more than one (None: no mesh)."""
    if text == "auto":
        n = torch.cuda.device_count() if device == "cuda" else 1
        return (1, n) if n > 1 else None
    n_spp, n_px = (int(v) for v in text.lower().split("x"))
    if n_spp < 1 or n_px < 1:
        raise ValueError(f"--mesh {text}: both sizes must be >= 1")
    return n_spp, n_px


def run_world(task, n_spp: int, n_px: int, args=(), devices=None,
              timeout: float | None = None, threads: int | None = None):
    """task(mesh, *args) on every rank of an n_spp x n_px mesh.  devices:
    one a rank (default cuda:0 .. cuda:n-1); a list that repeats a card,
    or the CPU, makes gloo groups.  timeout (s) bounds each collective
    and the join; threads caps each rank's torch threads (by default
    the host's cores shared out among the ranks: ranks that each take
    every core stall one another)."""
    n = n_spp * n_px
    threads = threads or max(1, (os.cpu_count() or 1) // n)
    tmp = tempfile.mkdtemp(prefix="statmc-mesh-")
    wargs = (n_spp, n_px, "file://" + os.path.join(tmp, "store"), devices,
             task, tuple(args), timeout, threads)
    try:
        if n == 1:
            _rank_main(0, *wargs)
            return
        import torch.multiprocessing as mp

        ctx = mp.start_processes(_rank_main, args=wargs, nprocs=n,
                                 join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"mesh {n_spp}x{n_px}: ranks still "
                                       f"running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _connect(rank, n, init_method, devices, timeout):
    """Join the world as `rank` (torchrun's when init_method is None) on
    this rank's device; returns the devices of every rank (None under
    torchrun: cuda:LOCAL_RANK)."""
    if devices is None and init_method is not None:
        devices = [f"cuda:{i}" for i in range(n)]
    backend = shard.backend_for(devices) if devices else "nccl"
    device = (shard.as_device(devices[rank]) if devices else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", "0"))))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    shard.distributed_init(
        init_method, n if init_method else None,
        rank if init_method else None, backend,
        datetime.timedelta(seconds=timeout) if timeout
        else shard.DEFAULT_TIMEOUT)
    return devices


def _rank_main(rank, n_spp, n_px, init_method, devices, task, args, timeout,
               threads):
    """One rank: join the world (torchrun's when init_method is None),
    build the mesh, run the task, leave the world."""
    if threads:
        torch.set_num_threads(threads)
    devices = _connect(rank, n_spp * n_px, init_method, devices, timeout)
    try:
        task(shard.make_mesh(n_spp, n_px, devices), *args)
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        dist.destroy_process_group()


def _spawned_rank(i, parent, *rank_args):
    """Rank i + 1 of a start_world world; it ends itself if the process
    that started it (rank 0) is gone, so that no rank outlives it."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    _rank_main(i + 1, *rank_args)


class World:
    """start_world's handle: rank 0's `mesh` in this process, the spawned
    ranks 1 .. n-1, and `timeout` (s), the world's bound on a
    collective.  A watchdog thread follows the spawned ranks: when one
    fails, join kills the others and the watchdog aborts this rank's NCCL
    collectives (gloo's fail by themselves once the peers are gone), so
    that a collective pending here raises; close() then raises the rank's
    error."""

    def __init__(self, procs, tmp, timeout):
        self.mesh = None
        self.timeout = timeout
        self._procs, self._tmp = procs, tmp
        self._error = None
        self._killed = False
        self._stop = threading.Event()
        self._watchdog = threading.Thread(target=self._watch, daemon=True)

    def _watch(self):
        while not self._stop.is_set():
            try:
                if self._procs.join(timeout=0.5):
                    return  # every spawned rank ended well
            except Exception as e:  # one failed; join killed the others
                self._error = e
                _abort()
                return

    def kill(self):
        """Stop the spawned ranks now (the caller's own error path);
        close() still follows."""
        self._killed = True
        for p in self._procs.processes:
            if p.is_alive():
                p.kill()

    def close(self):
        """Leave the world: this rank's process group is destroyed, the
        spawned ranks are joined within the timeout (killed after it), and
        the error of a rank that failed is raised."""
        self._stop.set()
        if self._watchdog.is_alive():
            self._watchdog.join()
        error = self._error
        if error is None and not self._killed:
            deadline = (None if self.timeout is None
                        else time.monotonic() + self.timeout)
            try:
                if dist.is_initialized():
                    dist.destroy_process_group()
                while not self._procs.join(timeout=0.5):
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(
                            f"ranks still running {self.timeout} s after "
                            "rank 0 left the world")
            except Exception as e:
                error = e
        for p in self._procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
        _abort()
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:
                pass  # the peers are gone; the group is dropped all the same
        shutil.rmtree(self._tmp, ignore_errors=True)
        if error is not None:
            raise error

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        """close(); on the caller's error, the ranks are killed first, and
        a rank's error, if one failed, is raised from the caller's."""
        if exc_type is None:
            self.close()
            return False
        self.kill()
        try:
            self.close()
        except Exception as rank_error:
            raise rank_error from exc
        return False


def _abort():
    """Abort this process's NCCL collectives, where torch offers it (a
    pending one raises); gloo's fail by themselves once the peers are
    gone, and both end at the world's timeout."""
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if (abort is not None and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        try:
            abort()
        except Exception:
            pass


def start_world(task, n_spp: int, n_px: int, args=(), devices=None,
                timeout: float | None = None,
                threads: int | None = None) -> World:
    """The world of run_world with this process as rank 0: ranks 1 ..
    n-1 run task(mesh, *args) in spawned processes, and this process
    joins as rank 0 and returns the handle.  The caller then runs rank
    0's part of the same program on World.mesh (task(world.mesh, *args)
    itself, or any steps whose collectives match the other ranks') and
    calls close(), or uses the handle in a ``with`` block.  devices: one
    a rank, rank 0's first (default cuda:0 .. cuda:n-1); timeout (s)
    bounds each collective of every rank and close()'s join; threads caps
    the spawned ranks' torch threads (this process keeps its own)."""
    n = n_spp * n_px
    if devices is None:
        devices = [f"cuda:{i}" for i in range(n)]
    threads = threads or max(1, (os.cpu_count() or 1) // n)
    tmp = tempfile.mkdtemp(prefix="statmc-mesh-")
    init = "file://" + os.path.join(tmp, "store")
    import torch.multiprocessing as mp

    procs = mp.start_processes(
        _spawned_rank, nprocs=n - 1, join=False, daemon=True,
        start_method="spawn",
        args=(os.getpid(), n_spp, n_px, init, devices, task, tuple(args),
              timeout, threads))
    world = World(procs, tmp, timeout)
    try:
        world.mesh = shard.make_mesh(
            n_spp, n_px, _connect(0, n, init, devices, timeout))
    except BaseException:
        world.__exit__(*sys.exc_info())
        raise
    world._watchdog.start()
    return world


def run_cli(args, n_spp: int, n_px: int) -> int:
    """``python -m statmc_tpu_torch --mesh SPPxPX``: inside torchrun's
    world (WORLD_SIZE must be SPP*PX) this process is one rank; else it
    starts the SPP*PX ranks, each on cuda:rank, or on the CPU under
    --device cpu (gloo)."""
    n = n_spp * n_px
    devices = ["cpu"] * n if args.device == "cpu" else None
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise ValueError(f"--mesh {n_spp}x{n_px} needs {n} ranks; the "
                             f"world has {os.environ['WORLD_SIZE']}")
        _rank_main(int(os.environ["RANK"]), n_spp, n_px, None, devices,
                   cli_task, (args,), None, None)
        return 0
    if devices is None and torch.cuda.device_count() < n:
        raise RuntimeError(f"statmc_tpu_torch: --mesh {n_spp}x{n_px} needs "
                           f"{n} CUDA devices, torch finds "
                           f"{torch.cuda.device_count()}; pass --device cpu "
                           "to render on the CPU")
    run_world(cli_task, n_spp, n_px, (args,), devices=devices)
    return 0


def cli_task(mesh, args):
    """The command line's rank: every rank renders its share; rank 0
    prints and writes.  For an integrator that ignores the mesh, rank 0
    renders alone."""
    from .. import __main__ as cli
    from ..driver import load

    r = load(args.scene, base_seed=args.baseseed, device=mesh.device,
             strict_assets=True if args.strictassets else None, mesh=mesh)
    if getattr(r, "mesh", None) is None and mesh.rank != 0:
        return
    cli.run(args, r, mesh)


def rank_launches(mesh) -> list:
    """Every rank's kernel launch counts ({"B1": n, ...}), in rank order
    (a collective: every rank calls it)."""
    from ..__main__ import launches
    from . import comm

    mine = launches()
    t = torch.tensor([mine[k] for k in sorted(mine)], dtype=torch.float64,
                     device=mesh.device)
    return [{k: int(v) for k, v in zip(sorted(mine), x.tolist())}
            for x in comm.all_gather(t)]


def _cpu(x):
    return None if x is None else x.detach().cpu()


def render_task(mesh, scene_path, out_path, iterations=None, base_seed=0,
                states=False, checkpoint=None):
    """Render scene_path on the mesh; rank 0 writes, per iteration, the
    whole image's film, film-f, feedback (avg_ls, win_b, win_l), the
    Radiance film-mean-f and n (every moment state when `states`), the
    counters and the log, plus every rank's launches over the whole
    render and the denoise's choice ("slabs" or "replicated").
    checkpoint: a path that save_checkpoint writes after iteration 1."""
    from ..__main__ import launches
    from ..driver import load
    from ..stats import estimator as E

    r = load(scene_path, base_seed=base_seed, device=mesh.device, mesh=mesh)
    r.progress = False
    launches(reset=True)
    its = []
    for i in range(1, (iterations or r.s.ecfg.iterations) + 1):
        log = r.run_iteration(i)
        full = r._full_states()
        its.append({
            "log": log, "film": _cpu(r.film_mean),
            "film_f": (None if r.film_f is None
                       else _cpu(r._full(r.film_f.reshape(-1, 3)))),
            **{k: _cpu(r._full(getattr(r, k)))
               for k in ("avg_ls", "win_b", "win_l")},
            "film_mean_f": (_cpu(r._full(
                r.derived[E.RADIANCE]["film_mean_f"], 1))
                if E.RADIANCE in r.derived else None),
            "n": _cpu(full[E.RADIANCE]["n"]),
            "states": ({t: {k: _cpu(v) for k, v in st.items()}
                        for t, st in full.items()} if states else None),
            "stats": {k: float(v) for k, v in r.stats.items()}})
        if checkpoint is not None and i == 1:
            r.save_checkpoint(checkpoint, 2)
    counts = rank_launches(mesh)
    if mesh.rank == 0:
        torch.save({"iterations": its, "launches": counts,
                    "denoise": {None: None, True: "slabs",
                                False: "replicated"}[r._slabs]}, out_path)


def jobs_task(mesh, scene_path, out_path, base_seeds):
    """Render jobs back to back on one Renderer, a job a base seed: the
    base seed set, then reset(), as a render service runs its jobs; rank
    0 writes each job's last film, film-f and moment states over the
    whole image."""
    from ..driver import load

    r = load(scene_path, base_seed=base_seeds[0], device=mesh.device,
             mesh=mesh)
    r.progress = False
    jobs = []
    for seed in base_seeds:
        r.s.base_seed = seed
        r.reset()
        for i in range(1, r.s.ecfg.iterations + 1):
            r.run_iteration(i)
        jobs.append({
            "film": _cpu(r.film_mean),
            "film_f": (None if r.film_f is None
                       else _cpu(r._full(r.film_f.reshape(-1, 3)))),
            "states": {t: {k: _cpu(v) for k, v in st.items()}
                       for t, st in r._full_states().items()}})
    if mesh.rank == 0:
        torch.save(jobs, out_path)


def chunk_task(mesh, scene_path, out_path, n_samples):
    """One call of make_sharded_chunk_fn (samples 0..n_samples-1, no
    feedback) on fresh states; rank 0 writes the whole image's states,
    film sums, ray total and counters."""
    from ..driver import load

    r = load(scene_path, device=mesh.device, mesh=mesh)
    fn = shard.make_sharded_chunk_fn(r.s, mesh)
    ids = torch.arange(r.lo, r.lo + r.Pl, dtype=torch.int32,
                       device=mesh.device)
    rays, stats = fn(r.states, r.film_sum, r.film_w, r.ray_total, r.base_key,
                     0, torch.clamp(ids, max=r.P - 1), ids < r.P, r.avg_ls,
                     r.win_b, r.win_l, False, n_samples)
    out = {"states": {t: {k: _cpu(v) for k, v in st.items()}
                      for t, st in r._full_states().items()},
           "film_sum": _cpu(r._full(r.film_sum)),
           "film_w": _cpu(r._full(r.film_w)), "ray_total": float(rays),
           "stats": {k: float(v) for k, v in stats.items()}}
    if mesh.rank == 0:
        torch.save(out, out_path)


def filter_task(mesh, in_path, out_path):
    """make_sharded_filter (the mesh denoise's halo filter) on the
    whole-image inputs in in_path (n, mean, m2, m3, fm, gb_planes, film,
    gb_factors, ds_factor, radius): each rank filters its row slab; rank 0
    writes the gathered (mean_corr, discriminator, film_mean_f, film_f)."""
    from . import comm

    a = torch.load(in_path, weights_only=True)
    H = a["mean"].shape[0]
    fn = shard.make_sharded_filter(mesh, H, a["radius"], a["ds_factor"],
                                   a["gb_factors"])
    hl = H // mesh.shape["px"]
    rows = slice(mesh.px_index * hl, (mesh.px_index + 1) * hl)
    outs = fn(*(a[k][rows].to(mesh.device) for k in (
        "n", "mean", "m2", "m3", "fm", "gb_planes", "film")))
    full = [torch.cat(comm.all_gather(o.contiguous(), mesh.px_group))
            for o in outs]
    if mesh.rank == 0:
        torch.save([_cpu(o) for o in full], out_path)


def combine_task(mesh, in_path, out_path):
    """stats.moments.combine_across over the "spp" group: rank k merges
    the k-th moment state of the list in in_path; rank 0 writes the
    merged state."""
    from ..stats import moments

    states = torch.load(in_path, weights_only=True)
    mine = {k: v.to(mesh.device) for k, v in states[mesh.spp_index].items()}
    merged = moments.combine_across(mine, mesh.spp_group)
    if mesh.rank == 0:
        torch.save({k: _cpu(v) for k, v in merged.items()}, out_path)
