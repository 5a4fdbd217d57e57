"""Reading the device's work in a traced window.

``Profiled`` runs torch.profiler over the window with the device's
activity only (the host's ops would be hundreds of thousands of events
more), and reads the raw events (the profiler's own event tree takes
minutes to build for a million of them).  The profiler's clock is the
wall clock in ns, so the harness marks what the host is doing with
``time.time_ns()``, and an idle gap on the device is named by the mark
that precedes it.

On a machine without a card the window is run without a profiler and
nothing is read: per-layer metrics there have nothing to read.
"""
from __future__ import annotations

import bisect
import time

import torch


def now_ns() -> int:
    """The profiler's clock."""
    return time.time_ns()


class Profiled:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = 0

    def __enter__(self):
        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda.synchronize(self.device)
        self.t0 = now_ns()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = now_ns()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def read(self, marks) -> dict:
        """summarize() of the device's operations in the window."""
        kernels = []
        if self.prof is not None:
            cuda = torch.autograd.DeviceType.CUDA
            for e in self.prof.profiler.kineto_results.events():
                if e.device_type() != cuda or e.is_user_annotation():
                    continue
                kernels.append((e.name(), e.start_ns(), e.duration_ns()))
        return summarize(kernels, self.t0, self.t1, marks)


def summarize(kernels, t0: int, t1: int, marks) -> dict:
    """{"kernels": [(name, start_ns, dur_ns)] sorted by start,
    "window_ns": (t0, t1), "busy_ns": the union of their intervals inside
    the window, "gaps": [(the host's mark before the gap, idle ns)]};
    marks: [(ns, what the host does from then on)], sorted."""
    kernels = sorted(kernels, key=lambda k: k[1])
    busy, gaps = 0, []
    mt = [m[0] for m in marks]

    def doing(t):
        k = bisect.bisect_right(mt, t) - 1
        return marks[k][1] if k >= 0 else "window start"

    end = t0
    for _, s, d in kernels:
        s, e = max(s, t0), min(s + d, t1)
        if e <= s:
            continue
        if s > end:
            gaps.append((doing(end), s - end))
        busy += max(0, e - max(s, end))
        end = max(end, e)
    if kernels and t1 > end:
        gaps.append((doing(end), t1 - end))
    return {"kernels": kernels, "window_ns": (t0, t1), "busy_ns": busy,
            "gaps": gaps}


def breakdown(tr: dict) -> dict:
    """The ten device operations that took most time, and the device's
    idle time summed by what the host was doing (the ten largest), in
    seconds."""
    by_name = {}
    for name, _, d in tr["kernels"]:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = {}
    for name, d in tr["gaps"]:
        idle[name] = idle.get(name, 0) + d
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], d / 1e9] for n, d in ops],
            "idle_gaps": [[n, d / 1e9] for n, d in gaps]}
