# Copied from statmc_tpu/io/progress.py (numpy host code; imports rewritten, behaviour unchanged).
"""Terminal progress reporter.

Replaces the reference's ProgressReporter (src/core/progressreporter.cpp:
a background thread repainting a `+`-bar with elapsed/ETA).  Here the
driver calls update() between dispatches instead of running a thread --
XLA dispatch boundaries are the natural tick points and a thread would
add nothing (the GIL-side work is already non-blocking dispatch).
Output is suppressed when stdout is not a TTY (matching pbrt's
TerminalWidth guard) or when quiet=True.
"""
from __future__ import annotations

import shutil
import sys
import time


class ProgressReporter:
    def __init__(self, total: int, title: str, quiet: bool = False,
                 out=None):
        self.total = max(int(total), 1)
        self.title = title
        self.done = 0
        self.t0 = time.time()
        self.out = out if out is not None else sys.stdout
        is_tty = bool(getattr(self.out, "isatty", lambda: False)())
        self.enabled = (not quiet) and is_tty
        self._last_len = 0

    def update(self, n: int = 1):
        self.done = min(self.done + n, self.total)
        self._paint()

    def _paint(self):
        if not self.enabled:
            return
        width = shutil.get_terminal_size((80, 24)).columns
        bar_w = max(10, width - len(self.title) - 32)
        frac = self.done / self.total
        fill = int(bar_w * frac)
        elapsed = time.time() - self.t0
        eta = elapsed / max(frac, 1e-9) - elapsed if frac > 0 else 0.0
        line = (f"\r{self.title}: [{'+' * fill}{' ' * (bar_w - fill)}] "
                f"({elapsed:.1f}s|{eta:.1f}s)")
        pad = max(0, self._last_len - len(line))
        self.out.write(line + " " * pad)
        self.out.flush()
        self._last_len = len(line)

    def finish(self):
        self.done = self.total
        self._paint()
        if self.enabled:
            self.out.write("\n")
            self.out.flush()
