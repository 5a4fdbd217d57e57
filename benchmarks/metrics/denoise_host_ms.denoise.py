"""Denoise: the host's time of a traced pass in the program's denoiser
(spans denoise.gbuffers and denoise.filter: the G-buffer planes, the
per-bounce launches of B2 and their outputs), over the traced passes, in
ms.  The rest of a pass's denoise_ms is the wait for the device.  Read
in the profiled passes, whose host times carry the profiler's cost a
launch on both sides of a comparison.  Moves denoise_ms."""
from statbench import spans as S

SPANS = ("denoise.gbuffers", "denoise.filter")


def read(ctx):
    snap = S.snapshot(ctx)
    if snap is None or not ctx["frames_run"]:
        return None
    ns = [S.duration_ns(s) for s in snap["spans"] if s["name"] in SPANS]
    return sum(ns) / 1e6 / len(ctx["frames_run"]) if ns else None
