"""The port's recorder of spans and counters (statmc_tpu_torch/spans.py):
nesting and trace ids, self time, the off path, tracing under
torch.profiler, device counters, and a tiny render that records every
span of the render loop and renders the same with tracing on and off."""
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from statmc_tpu_torch import spans
from statmc_tpu_torch.driver import load
from statmc_tpu_torch.testscenes import scene_text

# Every span and counter that one denoised statpath iteration records
# (the fused path: no two-level stages).
RENDER_SPANS = {"iteration", "render", "chunk", "denoise", "feedback",
                "sync.iteration", "wavefront.regen", "sync.wavefront",
                "wavefront.record", "integrator.bounce_step", "rng.draw",
                "moments.update", "intersect.closest", "intersect.occluded",
                "denoise.gbuffers", "denoise.filter"}


class _Ops(TorchDispatchMode):
    """The aten ops dispatched inside the block."""

    def __enter__(self):
        self.ops = []
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def recorder():
    spans.disable()
    spans.reset()
    yield spans
    spans.disable()
    spans.reset()


def test_spans_nest_with_parents_and_trace_ids(recorder):
    spans.enable()
    with spans.span("a", i=1):
        with spans.span("b"):
            with spans.span("c"):
                pass
        with spans.span("d"):
            pass
    with spans.span("e"):
        pass
    got = spans.snapshot()["spans"]
    assert [s["name"] for s in got] == ["a", "b", "c", "d", "e"]
    assert [s["parent"] for s in got] == [-1, 0, 1, 0, -1]
    assert [s["trace"] for s in got] == [0, 0, 0, 0, 4]
    assert got[0]["attrs"] == {"i": 1} and got[1]["attrs"] == {}
    for s in got:
        assert s["end_ns"] >= s["start_ns"]
        if s["parent"] >= 0:
            p = got[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    with spans.span("open"):
        with pytest.raises(RuntimeError):
            spans.reset()
        assert spans.snapshot()["spans"][-1]["end_ns"] is None


def test_self_time_of_a_hand_built_tree():
    def rec(t0, t1, parent):
        return {"name": "x", "start_ns": t0, "end_ns": t1, "parent": parent,
                "trace": 0, "attrs": {}}

    # root [0, 100]: children [10, 30] and [20, 50] overlap (union 40) and
    # [60, 70]; the first child has a child [12, 14].
    tree = [rec(0, 100, -1), rec(10, 30, 0), rec(12, 14, 1), rec(20, 50, 0),
            rec(60, 70, 0)]
    assert spans.self_ns(tree) == [50, 18, 2, 30, 10]


def test_off_path_records_and_launches_nothing(recorder):
    assert not spans.enabled()
    x = torch.ones(5, dtype=torch.bool)
    with _Ops() as seen:
        ctx = spans.span("a", i=1)
        with ctx:
            spans.count("dev", x)
            spans.count("host", 3)
    assert seen.ops == []
    assert ctx is spans.span("b")  # one shared context, nothing allocated
    snap = spans.snapshot()
    assert snap == {"spans": [], "counters": {"host": 3}}
    assert spans.counted("host") == 3 and spans.counted("none") == 0
    spans.count("kernel.B1", 1)
    spans.reset("kernel.")
    assert spans.snapshot()["counters"] == {"host": 3}


def test_tracing_turns_on_under_the_profiler(recorder):
    from torch.profiler import ProfilerActivity, profile

    assert not spans.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.enabled()
        with spans.span("under.profiler"):
            torch.ones(3).sum()
    assert not spans.enabled()
    assert [s["name"] for s in spans.snapshot()["spans"]] == ["under.profiler"]
    # The span is a record_function range of the same name in the trace.
    assert "under.profiler" in {e.name for e in prof.events()}


def test_device_counters_are_read_by_snapshot_only(recorder):
    spans.enable()
    x = torch.tensor([0.0, 1.0, 2.0, -1.0])
    with _Ops() as seen:
        spans.count("live", x > 0)
        spans.count("live", x >= 0)
    assert not any("_local_scalar_dense" in op for op in seen.ops)
    assert spans.counted("live") == 0  # not a host counter
    with _Ops() as seen:
        assert spans.snapshot()["counters"] == {"live": 5}
    assert any("_local_scalar_dense" in op for op in seen.ops)


def _film_states(r):
    return (r.film_mean.clone(), float(r.ray_total),
            {t: {k: v.clone() for k, v in st.items()}
             for t, st in r.states.items()})


def test_tiny_render_records_every_span_and_renders_the_same(recorder,
                                                             tmp_path):
    path = tmp_path / "tiny.pbrt"
    path.write_text(scene_text(width=8, height=6, spp=1, iterations=1,
                               maxdepth=2, denoise=True))
    r = load(os.fspath(path), device="cpu")
    r.progress = False
    r.run_iteration(1)
    off = _film_states(r)
    assert spans.snapshot()["spans"] == []

    r.reset()
    spans.enable()
    log = r.run_iteration(1)
    spans.disable()
    on = _film_states(r)
    assert torch.equal(on[0], off[0]) and on[1] == off[1]
    for t, st in off[2].items():
        for k, v in st.items():
            assert torch.equal(on[2][t][k], v), (t, k)

    snap = spans.snapshot()
    got = snap["spans"]
    assert {s["name"] for s in got} == RENDER_SPANS
    # One root, the iteration, whose index every span carries.
    assert got[0]["name"] == "iteration" and got[0]["parent"] == -1
    assert got[0]["attrs"] == {"i": 1, "n_samples": 1}
    assert all(s["trace"] == 0 for s in got)
    assert all(s["parent"] >= 0 for s in got[1:])
    parent = {s["name"]: got[s["parent"]]["name"] for s in got[1:]}
    assert parent["render"] == "iteration" and parent["chunk"] == "render"
    assert parent["integrator.bounce_step"] == "chunk"
    assert parent["intersect.occluded"] == "integrator.bounce_step"
    assert parent["moments.update"] == "wavefront.record"
    assert parent["denoise.filter"] == "denoise"
    render = next(s for s in got if s["name"] == "render")
    assert abs((render["end_ns"] - render["start_ns"]) / 1e9
               - log["render_s"]) < 1e-3
    # The self times under `render` add up to its duration.
    under = [i for i, s in enumerate(got) if s["name"] != "iteration"
             and _inside(got, i, "render")]
    own = spans.self_ns(got)
    assert sum(own[i] for i in under) == render["end_ns"] - render["start_ns"]
    c = snap["counters"]
    for kind in ("closest", "occluded"):
        lanes, live = c[f"intersect.{kind}.lanes"], c[f"intersect.{kind}.live"]
        assert 0 < live <= lanes
    assert c["intersect.closest.lanes"] == 2 * 3 * 48  # 2 calls, 3 steps


def _inside(got, i, name):
    while i >= 0:
        if got[i]["name"] == name:
            return True
        i = got[i]["parent"]
    return False
