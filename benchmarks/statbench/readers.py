"""Arithmetic that several per-layer readers share."""
from __future__ import annotations


def device_ns(tr: dict, names) -> int:
    """Device time of the traced operations whose name holds any of
    `names`, in ns."""
    return sum(d for n, _, d in tr["kernels"] if any(k in n for k in names))


def idle_percent(tr: dict):
    """The device's idle share of the traced window, in %; None when the
    trace holds no device operation."""
    if not tr["kernels"]:
        return None
    t0, t1 = tr["window_ns"]
    return 100.0 * (1.0 - tr["busy_ns"] / (t1 - t0))
