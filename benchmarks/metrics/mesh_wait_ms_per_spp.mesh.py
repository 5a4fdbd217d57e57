"""Mesh: the time a rank waits at the mesh's collectives for slower peers
in the traced job (the latest arrival among the ranks of each collective
less its own, from every rank's spans mesh.arrive.<kind>), ms a spp, the
largest rank's.  Moves samples_per_s."""
from statbench import meshspans as MS


def read(ctx):
    ns = MS.wait_ns(ctx)
    return None if ns is None else max(ns) / 1e6 / ctx["spp"]
