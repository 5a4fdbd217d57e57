"""Integrator: the host's time in the threefry draws (spans rng.draw:
every draw site of the bounce step and the camera's) in the traced job,
per sample a pixel, in ms.  Read in the profiled job, whose host times
carry the profiler's cost a launch on both sides of a comparison.  Moves
samples_per_s."""
from statbench import spans as S


def read(ctx):
    snap = S.snapshot(ctx)
    if snap is None:
        return None
    return S.per_spp_ms(ctx, [S.duration_ns(s) for s in snap["spans"]
                              if s["name"] == "rng.draw"])
