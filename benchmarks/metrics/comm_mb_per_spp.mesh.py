"""Mesh: the bytes the ranks hand to the mesh's collectives in the traced
job (the counters mesh.bytes.<kind>, summed over kinds and ranks), MB a
spp.  Moves samples_per_s."""
from statbench import meshspans as MS


def read(ctx):
    n = MS.bytes_total(ctx)
    return None if n is None else n / 1e6 / ctx["spp"]
