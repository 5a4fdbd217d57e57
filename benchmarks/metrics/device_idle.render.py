"""Device: the share of a render job in which no operation ran on the
card, in %: 1 - the traced job's device busy time over the wall time of
the untraced job run just before it in the same process (the profiler
stretches the traced job's own wall time by 30-50%, not its device
time).  Moves samples_per_s."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["kernels"] or not ctx.get("untraced_job_s"):
        return None
    return 100.0 * (1.0 - tr["busy_ns"] / 1e9 / ctx["untraced_job_s"])
