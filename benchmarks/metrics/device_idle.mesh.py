"""Device: the share of a render job on the mesh in which no operation
ran on rank 0's card, in %: 1 - the traced job's device busy time over
rank 0's wall time of the untraced job run just before it, as
device_idle.render reads a one-card job.  Moves samples_per_s."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["kernels"] or not ctx.get("untraced_job_s"):
        return None
    return 100.0 * (1.0 - tr["busy_ns"] / 1e9 / ctx["untraced_job_s"])
