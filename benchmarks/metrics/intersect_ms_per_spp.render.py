"""Intersection: device time of kernels B1 (fused_intersect), B3
(twolevel_cull) and B4 (twolevel_walk) in the traced job, per sample a
pixel, in ms.  Moves samples_per_s."""
from statbench.readers import device_ns

KERNELS = ("fused_intersect_kernel", "twolevel_cull_kernel",
           "twolevel_walk_kernel")


def read(ctx):
    ns = device_ns(ctx["trace"], KERNELS)
    return ns / 1e6 / ctx["spp"] if ns else None
