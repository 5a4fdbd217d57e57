"""Device: the share of the traced passes in which no operation ran on the
card, in %.  Moves denoise_ms."""
from statbench.readers import idle_percent


def read(ctx):
    return idle_percent(ctx["trace"])
