"""Host loop: device operations (kernels, copies, fills) that the traced
job enqueued, per sample a pixel of the job.  Moves samples_per_s."""


def read(ctx):
    n = len(ctx["trace"]["kernels"])
    return n / ctx["spp"] if n else None
