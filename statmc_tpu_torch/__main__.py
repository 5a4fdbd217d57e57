"""CLI: ``python -m statmc_tpu_torch [options] scene.pbrt``.

The flags of ``python -m statmc_tpu`` (the reference's extended pbrt
flag surface, src/main/pbrt.cpp:97-220): --writeimages,
--displayserver <ip:port>, --baseseed <n>, --denoise, --warmup,
--outdir, --iterations, --strictassets, --profile, --mesh, and the same
output lines.  --device picks the card (the default) or the CPU, which
runs every kernel's plain PyTorch version; --profile DIR writes a
torch.profiler chrome trace of the render loop into DIR.  --mesh
(multi-device rendering) is not ported yet and raises.  On the card, the
last line on standard error gives the launches of each kernel over the
render (or denoise) loop, as JSON: ``Kernel launches: {"B1": n, ...}``.
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
                    help="multi-device mesh (not ported yet)")
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

    from .driver import _ITEM_MESH, _unported, load

    if args.mesh:
        raise _unported("multi-device rendering (--mesh)", _ITEM_MESH)
    r = load(args.scene, base_seed=args.baseseed, device=args.device,
             strict_assets=True if args.strictassets else None)
    tev = None
    if args.displayserver:
        from .io.display import TevClient

        tev = TevClient(args.displayserver)
        tev.connect()

    n_it = args.iterations or r.s.ecfg.iterations
    if args.denoise:
        _launches(reset=True)
        for i in range(1, n_it + 1):
            written = r.denoise_from_disk(args.outdir, i)
            print(f"Iteration: {i}")
            for w in written:
                print(f"  wrote {w}")
            if tev is not None:
                tev.display_buffers(
                    f"{os.path.basename(args.scene)}-{r.total_spp(i)}",
                    _selected(r))
        _report_launches(r)
        return 0

    if args.warmup:
        print("==== Warm-Up Start ====")
        r.render(iterations=1, verbose=True)
        r.reset()
        print("==== Warm-Up End ====")

    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if r.device.type == "cuda" else []))
    _launches(reset=True)
    with prof:
        for i in range(1, n_it + 1):
            log = r.run_iteration(i)
            print(f"Iteration: {log['iteration']}")
            print(f"SPP: {log['spp']}")
            print(f"Rendering time [ns]: {int(log['render_s'] * 1e9)}")
            # Label kept for script compatibility with the reference's
            # per-iteration report (statpath.cpp:402-429).
            print(f"CUDA time [ns]: {int(log['denoise_s'] * 1e9)}")
            t0 = time.perf_counter()
            if args.writeimages:
                for w in r.write_outputs(args.outdir, i):
                    print(f"  wrote {w}")
            if tev is not None:
                tev.display_buffers(
                    f"{os.path.basename(args.scene)}-{log['spp']}",
                    _selected(r))
            print(f"Output time [ns]: "
                  f"{int((time.perf_counter() - t0) * 1e9)}")
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"profiler trace written to {args.profile}")
    if tev is not None:
        tev.close()
    r.print_stats()
    _report_launches(r)
    return 0


def _launches(reset=False):
    """Each kernel's launch count ({"B1": n, ...}), set to 0 if asked."""
    from .accel import fused, twolevel
    from .denoise import filter_cuda

    fns = {"B1": fused.intersect_tiles, "B2": filter_cuda.run_filter,
           "B3": twolevel.cull, "B4": twolevel.walk}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def _report_launches(r):
    if r.device.type == "cuda":
        print(f"Kernel launches: {json.dumps(_launches())}", file=sys.stderr,
              flush=True)


def _selected(r):
    rx = re.compile(r.s.ecfg.output_regex)
    return {k: v for k, v in r.buffers().items() if rx.fullmatch(k)}


if __name__ == "__main__":
    sys.exit(main())
