"""Kernel B2: the least time the card could take for the traced passes'
filter work (statbench/peaks.py: FP32 operations of every in-image pair
and of every accepted pair under the reference's test, bytes read and
written once; 67 TFLOP/s, 3.35 TB/s at 700 W) over the device time of
stat_filter_kernel, in %.  Moves denoise_ms."""
from statbench import peaks
from statbench.readers import device_ns


def read(ctx):
    ns = device_ns(ctx["trace"], ("stat_filter_kernel",))
    if not ns:
        return None
    work = ctx["loop"].b2_work(ctx["frames_run"])
    ctx["notes"].append(f"the traced passes' frames accept "
                        f"{work['accepted_share']!r} of in-image pairs")
    return 100.0 * peaks.bound_s(work["ops"], work["bytes"]) / (ns / 1e9)
