"""Denoise inside the render loop: the denoise seconds of the untraced
job's iterations (Renderer.run_iteration's denoise_s, host clock around
synchronizes) over its passes, in ms.  Moves samples_per_s."""


def read(ctx):
    passes = [x["denoise_s"] for x in ctx["span_logs"] if x["denoise_s"] > 0]
    return sum(passes) / len(passes) * 1e3 if passes else None
