"""The readers of the program's spans and counters (statbench/spans.py and
the six metrics that use it) on a synthetic snapshot and trace."""
import pytest

from statbench import cells, trace
from statbench import spans as S

MS = 1_000_000  # ns


def _spans(*rows):
    """[(name, start ms, end ms, parent)] -> snapshot()["spans"]."""
    out = []
    for name, a, b, parent in rows:
        root = len(out) if parent < 0 else out[parent]["trace"]
        out.append({"name": name, "start_ns": a * MS, "end_ns": b * MS,
                    "parent": parent, "trace": root, "attrs": {}})
    return out


# One render iteration: ms on the host's clock.
RENDER = _spans(
    ("iteration", 0, 1000, -1),
    ("render", 10, 900, 0),
    ("chunk", 20, 800, 1),
    ("sync.wavefront", 30, 40, 2),
    ("wavefront.regen", 40, 100, 2),
    ("rng.draw", 50, 70, 4),
    ("integrator.bounce_step", 100, 500, 2),
    ("rng.draw", 110, 130, 6),
    ("intersect.closest", 200, 300, 6),
    ("wavefront.record", 500, 600, 2),
    ("moments.update", 520, 580, 9),
    ("sync.iteration", 800, 900, 1),
    ("denoise", 900, 1000, 0),
    ("sync.iteration", 950, 1000, 12))  # after the render: not counted
COUNTERS = {"intersect.closest.lanes": 100, "intersect.closest.live": 60,
            "intersect.occluded.lanes": 50, "intersect.occluded.live": 15,
            "kernel.B1": 3}
# Device busy [0, 35], [45, 50], [120, 420], [850, 860] of [0, 1000].
KERNELS = [("k", 0, 35 * MS), ("k", 45 * MS, 5 * MS),
           ("k", 120 * MS, 300 * MS), ("k", 850 * MS, 10 * MS)]
TRACE = trace.summarize(KERNELS, 0, 1000 * MS, [])


def _ctx(snap, **kw):
    return dict({S._KEY: snap, "trace": TRACE, "notes": []}, **kw)


@pytest.mark.parametrize("name, want", [
    ("sync_wait_ms_per_spp.render", (10 + 100) / 2),
    ("rng_ms_per_spp.render", (20 + 20) / 2),
    ("bounce_self_ms_per_spp.render", (400 - 20 - 100) / 2),
    ("moments_ms_per_spp.render", 60 / 2),
    ("intersect_live_share.render", 100.0 * 75 / 150)])
def test_render_readers(name, want):
    snap = {"spans": RENDER, "counters": COUNTERS}
    assert cells.metric_reader(name)(_ctx(snap, spp=2)) == pytest.approx(want)
    assert cells.metric_reader(name)(_ctx(None, spp=2)) is None


def test_denoise_host_ms():
    snap = {"spans": _spans(("denoise.gbuffers", 0, 2, -1),
                            ("denoise.filter", 2, 7, -1),
                            ("denoise.gbuffers", 10, 11, -1),
                            ("denoise.filter", 11, 15, -1)),
            "counters": {}}
    read = cells.metric_reader("denoise_host_ms.denoise")
    assert read(_ctx(snap, frames_run=[3, 5])) == pytest.approx(6.0)
    assert read(_ctx(None, frames_run=[3, 5])) is None


def test_self_time_and_gaps():
    own = S.self_ns(RENDER)
    assert own[6] == 280 * MS and own[2] == (780 - 10 - 60 - 400 - 100) * MS
    # Under `render`, the self times add up to its duration.
    under = [i for i in range(len(RENDER)) if i == 1
             or S.within(RENDER, i, "render")]
    assert sum(own[i] for i in under) == S.duration_ns(RENDER[1])
    # The gaps are trace.summarize's, with their starts.
    assert S.gaps(TRACE) == [(35 * MS, 10 * MS), (50 * MS, 70 * MS),
                             (420 * MS, 430 * MS), (860 * MS, 140 * MS)]
    assert [g for _, g in S.gaps(TRACE)] == [g for _, g in TRACE["gaps"]]


def test_idle_by_innermost_span():
    assert S.idle_by_span(RENDER, TRACE) == {
        "sync.wavefront": 10 * MS, "rng.draw": 70 * MS,
        "integrator.bounce_step": 430 * MS, "sync.iteration": 140 * MS}
    # A gap outside every span, and one at the instant a span opens.
    tr = trace.summarize([("k", 0, 5 * MS), ("k", 50 * MS, 5 * MS)], 0,
                         60 * MS, [])
    sp = _spans(("a", 5, 20, -1), ("b", 55, 70, -1))
    assert S.idle_by_span(sp, tr) == {"a": 45 * MS, "b": 5 * MS}
    sp = _spans(("a", 0, 4, -1))
    assert S.idle_by_span(sp, tr) == {S.NO_SPAN: 50 * MS}


def test_snapshot_is_read_once_and_notes_idle():
    ctx = {"trace": TRACE, "notes": [], "spp": 2}
    ctx[S._KEY] = {"spans": RENDER, "counters": COUNTERS}
    for name in ("rng_ms_per_spp.render", "moments_ms_per_spp.render"):
        cells.metric_reader(name)(ctx)
    assert ctx["notes"] == []  # a snapshot already kept: no new note
    del ctx[S._KEY]
    from statmc_tpu_torch import spans

    spans.reset()
    assert S.snapshot(ctx) is None  # no profiler ran: nothing recorded
    spans.enable()
    try:
        with spans.span("render"):
            pass
    finally:
        spans.disable()
    del ctx[S._KEY]
    assert [s["name"] for s in S.snapshot(ctx)["spans"]] == ["render"]
    # The trace's gaps lie long before the span: outside every span.
    assert len(ctx["notes"]) == 1 and S.NO_SPAN in ctx["notes"][0]
    spans.reset()
