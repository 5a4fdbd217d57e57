"""Integrator: the share of the bounce steps run on the card that
replayed CUDA graphs of the step's own tensor code
(statmc_tpu_torch/render/bounce_graphs.py), 100 x graph.bounce.replay
over graph.bounce.replay + graph.bounce.eager, in %.  The program's host
counters run from the process's start; every job of a run takes the
same path, so the share is the traced job's.  A program without the
counters reads nothing.  Moves samples_per_s."""
from statbench import spans as S


def read(ctx):
    snap = S.snapshot(ctx)
    if snap is None:
        return None
    c = snap["counters"]
    replay = c.get("graph.bounce.replay", 0)
    steps = replay + c.get("graph.bounce.eager", 0)
    return 100.0 * replay / steps if steps else None
