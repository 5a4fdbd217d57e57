"""The port's one recorder of spans and counters.

A span is a named interval of the host's time, ``with span(name,
**attrs):``, read from ``time.time_ns()``, the clock of torch.profiler's
device traces, so the two line up.  Each span keeps the index of its
parent span and, as its trace id, the index of its root span: every span
of one render iteration (root ``iteration``) or of one denoise call
(roots ``denoise.gbuffers``, ``denoise.filter``) carries the same id.
A counter is a named sum: ``count(name, n)`` adds a host int, or the sum
of a device tensor into one device tensor a name, with no synchronize.

Tracing is on between ``enable()`` and ``disable()``, and whenever a
torch profiler session records (``torch.autograd.profiler.
_is_profiler_enabled``); while a profiler records, each span also opens a
``torch.profiler.record_function`` range of its name, so the spans show
in ``--profile``'s chrome trace.  With tracing off, ``span()`` returns
one shared context that records nothing, and ``count()`` of a device
tensor launches nothing; ``count()`` of a host int always counts (the
kernels' launch counters, ``kernel.B1`` .. ``kernel.B4`` and
``kernel.R1``, which the CLI's ``Kernel launches:`` line reads).  A call
site whose count would itself launch work (a reduction) asks
``enabled()`` first.

``snapshot()`` returns what was recorded (reading each device counter
once); ``reset()`` clears it.  The recorder serves one thread, the
host loop's.

Spans and counters of the port (PERF.md §3 names the metric of each):
``iteration`` > ``render`` > ``chunk``, ``denoise``, ``feedback``,
``sync.iteration`` (driver.py); ``wavefront.regen``, ``sync.wavefront``,
``wavefront.record``, ``integrator.bounce_step`` (render/integrator.py);
``rng.draw`` (core/rng.py); ``moments.update`` (stats/estimator.py);
``intersect.closest``, ``intersect.occluded`` and their counters
``.lanes`` and ``.live`` (render/intersect.py), with the ``twolevel.*``
stages inside; the host counters ``graph.bounce.capture``,
``graph.bounce.replay`` and ``graph.bounce.eager``
(render/bounce_graphs.py: a replayed step records no span inside its
graphs, its draws' ``rng.draw`` included); ``denoise.gbuffers``,
``denoise.filter`` (denoise/filter.py); ``mesh.<kind>``, ``mesh.arrive.<kind>`` and
``mesh.bytes.<kind>`` (parallel/shard.py); the feature paths' ``textures.*``, ``lights.*``,
``hair.*``, ``sss.*``, ``volume.*``, ``fourier.*`` and ``bdpt.*``.
"""
from __future__ import annotations

import functools
import time

import torch
from torch.autograd import profiler as _profiler

_on = False
# One record a span: [name, start_ns, end_ns (0 while open), parent
# index (-1 for a root), trace id, attrs].
_records: list = []
_open: list = []  # indices of the open spans, innermost last
_host: dict = {}  # counter name -> int
_device: dict = {}  # counter name -> 0-d int64 tensor


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    """Whether spans record: after enable(), or while a torch profiler
    session records."""
    return _on or _profiler._is_profiler_enabled


class _Off:
    """The context of a span while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "index", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        parent = _open[-1] if _open else -1
        self.index = len(_records)
        trace = _records[parent][4] if parent >= 0 else self.index
        _records.append([self.name, time.time_ns(), 0, parent, trace,
                         self.attrs])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        _records[self.index][2] = time.time_ns()
        _open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context that records the span `name` with `attrs` while tracing
    is on."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """Decorator: each call of the function runs in the span `name`; the
    function keeps its name, signature and docstring."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n):
    """Adds n to the counter `name`: a host int always, a tensor's sum
    (on its device, no synchronize) only while tracing is on."""
    if not torch.is_tensor(n):
        _host[name] = _host.get(name, 0) + int(n)
    elif enabled():
        s = torch.sum(n, dtype=torch.int64)
        acc = _device.get(name)
        if acc is None:
            _device[name] = s
        else:
            acc.add_(s)


def counted(name: str) -> int:
    """The host counter `name` (0 if nothing was counted)."""
    return _host.get(name, 0)


def snapshot() -> dict:
    """{"spans": [{"name", "start_ns", "end_ns" (None while open),
    "parent", "trace", "attrs"}], "counters": {name: int}}: the spans in
    the order they opened, and every counter, the device ones read
    here."""
    out = [{"name": n, "start_ns": t0, "end_ns": t1 or None,
            "parent": p, "trace": tr, "attrs": dict(a)}
           for n, t0, t1, p, tr, a in _records]
    counters = dict(_host)
    for name, v in _device.items():
        counters[name] = counters.get(name, 0) + int(v.item())
    return {"spans": out, "counters": counters}


def self_ns(records: list) -> list:
    """Each span's self time in ns: its duration less the union of its
    children's intervals (`records`: snapshot()["spans"], all closed)."""
    children = [[] for _ in records]
    for r in records:
        if r["parent"] >= 0:
            children[r["parent"]].append((r["start_ns"], r["end_ns"]))
    out = []
    for r, kids in zip(records, children):
        t0, t1 = r["start_ns"], r["end_ns"]
        covered, reach = 0, t0
        for a, b in sorted(kids):
            a, b = max(a, reach), min(b, t1)
            if b > a:
                covered += b - a
                reach = b
        out.append(t1 - t0 - covered)
    return out


def reset(prefix: str | None = None):
    """Clears the spans and every counter; with `prefix`, only the
    counters whose names start with it."""
    if prefix is not None:
        for d in (_host, _device):
            for k in [k for k in d if k.startswith(prefix)]:
                del d[k]
        return
    if _open:
        raise RuntimeError(f"spans.reset() inside the open span "
                           f"{_records[_open[-1]][0]!r}")
    _records.clear()
    _host.clear()
    _device.clear()
