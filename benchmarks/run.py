"""Benchmark of statmc_tpu_torch: one run of one cell.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of the repository, on a machine with the card(s) the cell
asks for.  The run builds the cell's inputs from the seed (set-up: the
scene, the port's renderer or denoiser, the nvcc build on the first run of
a checkout, one warm-up of every shape), measures for --seconds, checks
what the timed path produced against the plain reference
(statbench/reference.py), and prints as the last line of standard output
one JSON object: correct, attempted, failed, metrics, device (and with
--trace 1, breakdown), and last the numbers compared, each with its limit.
The same numbers end standard error.

--trace 0 reports the cell's end-to-end metrics of BENCHMARK.json;
--trace 1 runs the cell once more under the profiler and reports its
per-layer metrics (metrics/<name>.py each).  Without CUDA, or with fewer
cards than the cell asks for, the run prints no result and exits 2.  It
exits 3 without a result if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# One host thread for the libraries' CPU work: the loop is one Python
# thread launching kernels, and idle pool threads spinning on the host's
# few shared cores only slow it.  Set before torch and numpy load.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

BENCH = os.path.dirname(os.path.abspath(__file__))
# The harness (statbench) and the program (statmc_tpu_torch, at the root
# of the checkout).
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from statbench import cells, guard  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return [float(x) for x in out.stdout.split()]
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def run(args, device=None, overrides=None, out=sys.stdout,
        err=sys.stderr) -> int:
    """One run; returns the exit code.  device and overrides are for the
    CPU tests, which drive a run on the CPU at small frames; a measured run
    passes neither and needs the card."""
    import torch

    from statbench import judge, trace

    phases = {"imports": time.perf_counter() - T_START}
    cell = cells.find(args.workload)
    chips = int(cell["entry"]["chips"])
    if device is None:
        if not torch.cuda.is_available():
            print("run.py: no CUDA device: the benchmark measures the card "
                  "and never falls back to the CPU", file=err)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"run.py: the cell asks for {chips} cards, torch finds "
                  f"{torch.cuda.device_count()}", file=err)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.init()
        phases["cuda"] = time.perf_counter() - T_START
    loop = cells.loop_class(cell)(cell, args.seed, device, overrides)
    phases["build"] = time.perf_counter() - T_START
    loop.warm_up()
    setup_s = time.perf_counter() - T_START
    t = time.perf_counter()
    if args.trace:
        res = loop.traced(args.seconds)
    else:
        res = loop.window(args.seconds)
    t_window = time.perf_counter() - t
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_reserved(device))
    loop.release()
    t = time.perf_counter()
    notes = []
    numbers = loop.check(notes=notes)
    ok = judge.correct(numbers)
    for line in notes:
        print("run.py: " + line, file=err)
    print(f"run.py: set-up {setup_s:.3f} s (by then: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"), window {t_window:.3f} s, "
          f"check {time.perf_counter() - t:.3f} s; "
          + json.dumps({k: v for k, v in res.items()
                        if isinstance(v, (int, float)) or k == "jobs_s"}),
          file=err)

    metrics = {}
    if args.trace:
        ctx = dict(res, loop=loop, notes=[])
        for m in cell["per_layer"]:
            v = cells.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        for line in ctx["notes"]:
            print("run.py: " + line, file=err)
    else:
        for m in cell["end_to_end"]:
            v = setup_s if m["name"] == "setup_s" else res[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips if cuda else 1,
           "memory_peak_bytes": peak if cuda else 0}
    if cuda:
        dev["power_limit_w"] = _power_limit()
    # attempted: the numbers compared; failed: those past their limit.
    result = {"correct": ok, "attempted": len(numbers),
              "failed": len(numbers) - sum(judge.correct([x])
                                           for x in numbers),
              "metrics": metrics, "device": dev}
    if args.trace:
        tr = res["trace"]
        dev["busy_s"] = tr["busy_ns"] / 1e9
        dev["window_s"] = (tr["window_ns"][1] - tr["window_ns"][0]) / 1e9
        result["breakdown"] = trace.breakdown(tr)
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in numbers}

    loaded = guard.forbidden_loaded()
    if loaded:
        print("run.py: the run loaded " + ", ".join(loaded)
              + ": no run may import JAX or the JAX package", file=err)
        return 3
    for n, v, lim in numbers:
        print(f"{n} {v!r} limit {lim!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None) -> int:
    import torch

    torch.set_num_threads(1)
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
