"""CLI: ``python -m statmc_tpu_torch [options] scene.pbrt``.

The flags of ``python -m statmc_tpu`` (the reference's extended pbrt
flag surface, src/main/pbrt.cpp:97-220): --writeimages,
--displayserver <ip:port>, --baseseed <n>, --denoise, --warmup,
--outdir, --iterations, --strictassets, --profile, --mesh, and the same
output lines.  --device picks the card (the default) or the CPU, which
runs every kernel's plain PyTorch version; --profile DIR writes a
torch.profiler chrome trace of the render loop into DIR.  On the card, the
last line on standard error gives the launches of each kernel over the
render (or denoise) loop, as JSON: ``Kernel launches: {"B1": n, ...}``,
with the bounce step's graph counters (``"graph.bounce.replay": n``, ...).

--mesh SPPxPX renders on a mesh of SPP*PX ranks (parallel/shard.py):
samples strided over SPP ranks, image rows over PX.  The command starts
the ranks itself, one process a rank on cuda:0 .. cuda:n-1 (NCCL), or on
the CPU under --device cpu (gloo); under torchrun (WORLD_SIZE = SPP*PX)
each process is one rank, on cuda:LOCAL_RANK.  --mesh auto is 1 x the
CUDA devices when there are more than one.  Rank 0 prints and writes;
on the card it also prints every rank's launches, ``Kernel launches by
rank: [...]``, before its own line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="statmc_tpu_torch",
        description="statistical Monte Carlo renderer (PyTorch/CUDA)")
    ap.add_argument("scene", help="pbrt scene description file")
    ap.add_argument("--writeimages", action="store_true",
                    help="write regex-selected buffers to disk")
    ap.add_argument("--displayserver", default=None, metavar="IP:PORT",
                    help="stream buffers to a tev display server")
    ap.add_argument("--baseseed", type=int, default=0,
                    help="base seed for the sampler")
    ap.add_argument("--denoise", action="store_true",
                    help="skip rendering; denoise prerendered buffers")
    ap.add_argument("--warmup", action="store_true",
                    help="run one throwaway iteration first")
    ap.add_argument("--outdir", default="out",
                    help="output directory (default: out/)")
    ap.add_argument("--mesh", default=None, metavar="SPPxPX",
                    help="multi-device mesh, e.g. 2x4 (samples x pixel "
                         "rows), or 'auto' for 1 x n_devices")
    ap.add_argument("--iterations", type=int, default=None,
                    help="override iteration count")
    ap.add_argument("--strictassets", action="store_true",
                    help="error (instead of warn) on missing PLY/texture "
                         "asset files")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler chrome trace of the "
                         "render loop into DIR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="render on the card (default) or on the CPU")
    args = ap.parse_args(argv)

    if args.mesh:
        from .parallel import launch

        shape = launch.mesh_shape(args.mesh, args.device)
        if shape is not None:
            return launch.run_cli(args, *shape)
    from .driver import load

    r = load(args.scene, base_seed=args.baseseed, device=args.device,
             strict_assets=True if args.strictassets else None)
    return run(args, r)


def run(args, r, mesh=None) -> int:
    """The command's loop on the renderer r: on one device, or on every
    rank of `mesh` (each calls the collectives; rank 0 prints and
    writes)."""
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    tev = None
    if args.displayserver and lead:
        from .io.display import TevClient

        tev = TevClient(args.displayserver)
        tev.connect()

    def display(label):
        if args.displayserver:
            bufs = _selected(r)  # gathers under a mesh: every rank calls
            if tev is not None:
                tev.display_buffers(label, bufs)

    n_it = args.iterations or r.s.ecfg.iterations
    if args.denoise:
        launches(reset=True)
        for i in range(1, n_it + 1):
            written = r.denoise_from_disk(args.outdir, i)
            say(f"Iteration: {i}")
            for w in written:
                say(f"  wrote {w}")
            display(f"{os.path.basename(args.scene)}-{r.total_spp(i)}")
        _report_launches(r, mesh)
        return 0

    if args.warmup:
        say("==== Warm-Up Start ====")
        r.render(iterations=1, verbose=True)
        r.reset()
        say("==== Warm-Up End ====")

    prof = contextlib.nullcontext()
    if args.profile and lead:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if r.device.type == "cuda" else []))
    launches(reset=True)
    with prof:
        for i in range(1, n_it + 1):
            log = r.run_iteration(i)
            say(f"Iteration: {log['iteration']}")
            say(f"SPP: {log['spp']}")
            say(f"Rendering time [ns]: {int(log['render_s'] * 1e9)}")
            # Label kept for script compatibility with the reference's
            # per-iteration report (statpath.cpp:402-429).
            say(f"CUDA time [ns]: {int(log['denoise_s'] * 1e9)}")
            if "comm_s" in log:  # under a mesh
                say(f"Rays traced: {int(log['rays_total'])}")
                say("Collectives time [ns]: " + json.dumps(
                    {k: int(v * 1e9) for k, v in log["comm_s"].items()}))
                say("Collectives bytes: " + json.dumps(log["comm_bytes"]))
            t0 = time.perf_counter()
            if args.writeimages:
                for w in r.write_outputs(args.outdir, i):
                    say(f"  wrote {w}")
            display(f"{os.path.basename(args.scene)}-{log['spp']}")
            say(f"Output time [ns]: "
                f"{int((time.perf_counter() - t0) * 1e9)}")
    if args.profile and lead:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        say(f"profiler trace written to {args.profile}")
    if tev is not None:
        tev.close()
    r.print_stats()
    sys.stdout.flush()
    _report_launches(r, mesh)
    return 0


GRAPH_COUNTERS = ("graph.bounce.capture", "graph.bounce.replay",
                  "graph.bounce.eager")


def launches(reset=False):
    """Each kernel's launch count ({"B1": n, ...}, the counters kernel.B1
    .. kernel.B4 and kernel.R1 of spans.py), set to 0 if asked, as are
    the bounce step's graph counters (graph_counts)."""
    from . import spans

    if reset:
        spans.reset("kernel.")
        spans.reset("graph.")
    return {k: spans.counted("kernel." + k)
            for k in ("B1", "B2", "B3", "B4", "R1")}


def graph_counts() -> dict:
    """The bounce step's graph counters: segments captured, steps
    replayed and steps run op by op on the card."""
    from . import spans

    return {k: spans.counted(k) for k in GRAPH_COUNTERS}


def _report_launches(r, mesh=None):
    """On the card: this process's launches as the last line on standard
    error; under a mesh rank 0 prints them, after every rank's."""
    by_rank = None
    if getattr(r, "mesh", None) is not None:
        from .parallel.launch import rank_launches

        by_rank = rank_launches(mesh)
    if r.device.type == "cuda" and (mesh is None or mesh.rank == 0):
        if by_rank is not None:
            print(f"Kernel launches by rank: {json.dumps(by_rank)}",
                  file=sys.stderr, flush=True)
        counts = {**launches(), **graph_counts()}
        print(f"Kernel launches: {json.dumps(counts)}", file=sys.stderr,
              flush=True)


def _selected(r):
    rx = re.compile(r.s.ecfg.output_regex)
    return {k: v for k, v in r.buffers().items() if rx.fullmatch(k)}


if __name__ == "__main__":
    sys.exit(main())
