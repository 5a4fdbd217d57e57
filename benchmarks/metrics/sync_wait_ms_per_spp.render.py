"""Host loop: the host's time inside the program's synchronizes within a
render (spans sync.wavefront, the wavefront's bool(torch.any(...)) each
step, and sync.iteration, the render's last synchronize) in the traced
job, per sample a pixel, in ms.  Read in the profiled job, whose host
times carry the profiler's cost a launch on both sides of a comparison.
Moves samples_per_s."""
from statbench import spans as S


def read(ctx):
    snap = S.snapshot(ctx)
    if snap is None:
        return None
    sp = snap["spans"]
    return S.per_spp_ms(ctx, [S.duration_ns(s) for i, s in enumerate(sp)
                              if s["name"].startswith("sync.")
                              and S.within(sp, i, "render")])
