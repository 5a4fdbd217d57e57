"""The program's spans and counters in a traced run.

The port records spans and counters whenever a torch profiler records
(statmc_tpu_torch/spans.py), on ``time.time_ns()``, the clock of the
device trace and of the harness's marks; so the traced window's spans
line up with its device operations.  ``snapshot(ctx)`` reads the
program's record once a run and keeps it in ctx.  It gives None where the
program has no recorder or recorded no span (no profiler ran: the CPU),
and every reader then returns None.

The arithmetic is the benchmark's own:

- ``self_ns``: a span's duration less the union of its children's
  intervals;
- ``idle_by_span``: each idle gap of the device in the traced window,
  under the innermost program span open at the gap's start (the rule
  trace.summarize applies to the harness's marks).

The first snapshot of a run adds the idle-by-span table to ctx["notes"],
which run.py prints on standard error.
"""
from __future__ import annotations

_KEY = "program_spans"
NO_SPAN = "(no span)"


def _read():
    try:
        from statmc_tpu_torch import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    return snap if snap["spans"] else None


def snapshot(ctx: dict):
    """{"spans": [...], "counters": {...}} of the program, or None."""
    if _KEY not in ctx:
        snap = ctx[_KEY] = _read()
        if snap is not None and ctx.get("trace", {}).get("kernels"):
            idle = idle_by_span(snap["spans"], ctx["trace"])
            top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
            ctx.setdefault("notes", []).append(
                "device idle by program span (s): "
                + ", ".join(f"{n} {ns / 1e9!r}" for n, ns in top))
    return ctx[_KEY]


def duration_ns(s: dict) -> int:
    return s["end_ns"] - s["start_ns"]


def within(records: list, i: int, name: str) -> bool:
    """Whether an ancestor of span i is named `name`."""
    p = records[i]["parent"]
    while p >= 0:
        if records[p]["name"] == name:
            return True
        p = records[p]["parent"]
    return False


def self_ns(records: list) -> list:
    """Each span's duration less the union of its children's intervals,
    in ns."""
    children = [[] for _ in records]
    for r in records:
        if r["parent"] >= 0:
            children[r["parent"]].append((r["start_ns"], r["end_ns"]))
    out = []
    for r, kids in zip(records, children):
        covered, reach = 0, r["start_ns"]
        for a, b in sorted(kids):
            a, b = max(a, reach), min(b, r["end_ns"])
            if b > a:
                covered += b - a
                reach = b
        out.append(duration_ns(r) - covered)
    return out


def gaps(tr: dict) -> list:
    """[(start_ns, idle_ns)]: trace.summarize's gaps, with their starts."""
    t0, t1 = tr["window_ns"]
    out, end = [], t0
    for _, s, d in tr["kernels"]:
        s, e = max(s, t0), min(s + d, t1)
        if e <= s:
            continue
        if s > end:
            out.append((end, s - end))
        end = max(end, e)
    if tr["kernels"] and t1 > end:
        out.append((end, t1 - end))
    return out


def idle_by_span(records: list, tr: dict) -> dict:
    """{span name: the device's idle ns in the gaps that start inside it
    (the innermost span open then; NO_SPAN outside every span)}."""
    events = []
    for i, r in enumerate(records):
        events.append((r["start_ns"], 1, i))
        if r["end_ns"] is not None:
            events.append((r["end_ns"], 0, -i))
    # At one instant: closes before opens, children close before parents
    # and open after them.
    events.sort()
    out, stack, k = {}, [], 0
    for start, idle in sorted(gaps(tr)):
        while k < len(events) and events[k][0] <= start:
            _, opens, i = events[k]
            if opens:
                stack.append(i)
            else:
                stack.remove(-i)
            k += 1
        name = records[stack[-1]]["name"] if stack else NO_SPAN
        out[name] = out.get(name, 0) + idle
    return out


def per_spp_ms(ctx: dict, ns: list):
    """The sum of `ns` over the traced job's samples a pixel, in ms; None
    for an empty list."""
    return sum(ns) / 1e6 / ctx["spp"] if ns else None
