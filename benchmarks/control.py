"""The readings that set the limits of ``correct``, on the card.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 0

runs the cell's set-up and warm-up once, then for each seed a window
(its first job, or its passes, as a measured run drives them; the
program's state carried on from the seed before) and the check, and
prints one JSON line a seed: the program's readings of every number
compared, and the control's, the reference in bfloat16 in the program's
place (each limit lies between the program's largest reading and the
control's smallest), with the check's notes.  The benchmark's own runs
do not run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def main(argv=None) -> int:
    import torch

    from statbench import cells

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    c = cells.find(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    lp = cells.loop_class(c)(c, seeds[0], torch.device("cuda", 0))
    lp.warm_up()
    for seed in seeds:
        lp.seed, lp.job = seed, 0
        window = lp.window(args.seconds)
        t = time.perf_counter()
        notes, notes_c = [], []
        program = {n: v for n, v, _ in lp.check(notes=notes)}
        t_check = time.perf_counter() - t
        control = {n: v for n, v, _ in lp.check(control=True,
                                                notes=notes_c)}
        line = {"workload": args.workload, "seed": seed,
                "window": {k: v for k, v in window.items()
                           if isinstance(v, (int, float))},
                "check_s": t_check, "program": program, "control": control,
                "notes": [n for n in notes + notes_c
                          if "query differs" not in n]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
