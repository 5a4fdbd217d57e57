"""Intersection: the share of the rays handed to the closest-hit and
shadow queries in the traced job that could hit anything (t_max > 0;
dead lanes are queried with t_max = 0), from the program's counters
intersect.{closest,occluded}.{live,lanes}, in %.  Moves samples_per_s."""
from statbench import spans as S

KINDS = ("closest", "occluded")


def read(ctx):
    snap = S.snapshot(ctx)
    if snap is None:
        return None
    c = snap["counters"]
    lanes = sum(c.get(f"intersect.{k}.lanes", 0) for k in KINDS)
    live = sum(c.get(f"intersect.{k}.live", 0) for k in KINDS)
    return 100.0 * live / lanes if lanes else None
