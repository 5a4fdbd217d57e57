"""Mesh: the host's time in the mesh's collectives in the traced job
(spans mesh.<kind>: spp_merge, film_sums, counters, halo; each from the
rank's arrival to its device's synchronize after the collective, so its
wait for slower peers included), ms a spp, the median over the ranks.
Moves samples_per_s."""
import statistics

from statbench import meshspans as MS


def read(ctx):
    ns = MS.collective_ns(ctx)
    return None if ns is None else statistics.median(ns) / 1e6 / ctx["spp"]
