"""Integrator: the self time of the bounce step (span
integrator.bounce_step less its draws and intersect calls: shading, NEE,
MIS, Russian roulette, the G-buffer) in the traced job, per sample a
pixel, in ms.  Read in the profiled job, whose host times carry the
profiler's cost a launch on both sides of a comparison.  Moves
samples_per_s."""
from statbench import spans as S


def read(ctx):
    snap = S.snapshot(ctx)
    if snap is None:
        return None
    sp = snap["spans"]
    own = S.self_ns(sp)
    return S.per_spp_ms(ctx, [own[i] for i, s in enumerate(sp)
                              if s["name"] == "integrator.bounce_step"])
