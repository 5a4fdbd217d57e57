"""The end-to-end arithmetic on synthetic timings, and the trace's
reduction."""
import time
import types

import pytest
import torch

from statbench import cells, readers, trace

W, H = 8, 4


class FakeRenderer:
    """Renderer's surface as the render loop uses it; an iteration takes
    `dt` seconds, and `stall` more in the iterations listed."""

    def __init__(self, dt, stall=0.0, stall_at=()):
        self.s = types.SimpleNamespace(base_seed=0)
        self.dt, self.stall, self.stall_at = dt, stall, set(stall_at)
        self.calls = 0
        self.reset()

    def reset(self):
        self.states, self.film_mean, self.film_f = {}, None, None

    def iteration_spp(self, i):
        return (0, 4) if i == 1 else (4 << (i - 2), 4 << (i - 2))

    def total_spp(self, i):
        return 4 << (i - 1)

    def run_iteration(self, i):
        time.sleep(self.dt + (self.stall if self.calls in self.stall_at
                              else 0))
        self.calls += 1
        return {"render_s": self.dt, "denoise_s": 0.0, "rays_total": 1.0}


def _loop(name):
    """Loop of loops/<name>.py, found as a cell's mix finds it."""
    return cells.loop_class({"traffic": {"loop": name}})


def _jobs(r):
    RenderJobs = _loop("render_jobs")
    lp = RenderJobs.__new__(RenderJobs)
    lp.r, lp.W, lp.H, lp.n_iter = r, W, H, 3
    lp.seed, lp.job, lp.kept = 7, 0, None
    lp.device = torch.device("cpu")
    lp.params = {"check_pixels": 4, "rays_per_call": 2,
                 "filter_centres": 1, "path_lanes": 2}
    lp.cfg = {"integrator": {"integer filterradius": [1]}, "sampler": {},
              "film": {}}
    lp.text = ""
    return lp


def test_samples_per_s_is_all_work_over_all_time():
    lp = _jobs(FakeRenderer(0.01))
    t = time.perf_counter()
    res = lp.window(0.25)
    wall = time.perf_counter() - t
    assert res["samples"] == sum(W * H * (4, 4, 8)[k % 3]
                                 for k in range(res["iterations"]))
    assert res["samples_per_s"] == pytest.approx(
        res["samples"] / res["elapsed_s"] / 1e6)
    assert res["elapsed_s"] <= wall and res["elapsed_s"] >= 0.25
    assert res["iterations"] >= 3


def test_a_stall_moves_samples_per_s():
    clean = _jobs(FakeRenderer(0.01)).window(0.3)["samples_per_s"]
    stalled = _jobs(FakeRenderer(0.01, 0.15, (4,))).window(0.3)
    assert stalled["samples_per_s"] < 0.8 * clean


def _frames(dt, stall=0.0, every=0):
    DenoiseFrames = _loop("denoise_frames")
    lp = DenoiseFrames.__new__(DenoiseFrames)
    lp.device = torch.device("cpu")
    lp.n_pass = 0

    def one(events=None):
        k = lp.n_pass
        time.sleep(dt + (stall if every and k % every == every - 1 else 0))
        lp.n_pass += 1

    lp._pass = one
    return lp


def test_denoise_ms_and_p95():
    res = _frames(0.002).window(0.2)
    assert res["denoise_ms"] == pytest.approx(
        res["elapsed_s"] / res["passes"] * 1e3)
    assert 2.0 <= res["denoise_p95_ms"] < 10
    stalled = _frames(0.002, 0.03, every=10).window(0.4)
    assert stalled["denoise_p95_ms"] > 25
    assert stalled["denoise_ms"] > res["denoise_ms"] * 1.5


def test_trace_summary_union_and_gaps():
    kernels = [("a", 110, 20), ("b", 120, 30), ("c", 200, 10),
               ("d", 50, 70), ("e", 290, 50)]
    marks = [(100, "iteration 1"), (180, "iteration 2")]
    tr = trace.summarize(kernels, 100, 300, marks)
    # [100,150] from a, b, d; [200,210] from c; [290,300] from e.
    assert tr["busy_ns"] == 50 + 10 + 10
    assert sorted(tr["gaps"]) == [("iteration 1", 50), ("iteration 2", 80)]
    assert readers.idle_percent(tr) == pytest.approx(65.0)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["d", 70e-9]
    assert b["idle_gaps"][0] == ["iteration 2", 80e-9]
    assert readers.idle_percent(trace.summarize([], 0, 10, [])) is None


def test_readers_on_a_synthetic_trace():
    tr = trace.summarize([("fused_intersect_kernel", 0, 2_000_000),
                          ("elementwise", 0, 1_000_000),
                          ("twolevel_walk_kernel", 0, 3_000_000)], 0,
                         10_000_000, [])
    ctx = {"trace": tr, "spp": 4, "untraced_job_s": 0.006,
           "span_logs": [{"render_s": 1.0, "denoise_s": 0.005,
                          "rays_total": 1e6},
                         {"render_s": 1.0, "denoise_s": 0.007,
                          "rays_total": 3e6}]}
    rd = {n: cells.metric_reader(n)(ctx) for n in (
        "launches_per_spp.render", "intersect_ms_per_spp.render",
        "render_mrays_per_s.render", "filter_pass_ms.render",
        "device_idle.render")}
    assert rd["launches_per_spp.render"] == 3 / 4
    assert rd["intersect_ms_per_spp.render"] == pytest.approx(5.0 / 4)
    assert rd["render_mrays_per_s.render"] == pytest.approx(1.5)
    assert rd["filter_pass_ms.render"] == pytest.approx(6.0)
    # Busy 3 ms (the union) of the untraced job's 6 ms; of the 10-ms
    # traced window for the denoise cell.
    assert rd["device_idle.render"] == pytest.approx(50.0)
    assert cells.metric_reader("device_idle.denoise")(ctx) == \
        pytest.approx(70.0)


@pytest.mark.parametrize("trace_on", [0, 1])
def test_result_line_on_the_cpu(trace_on):
    """A whole run of the denoise cell on the CPU at small frames: the
    last line is the result, the compared numbers come last in it and end
    standard error."""
    import io
    import json

    import run
    from conftest import SMALL

    out, err = io.StringIO(), io.StringIO()
    args = run.parse_args(["--workload", "staircase-denoise-frames",
                           "--seed", "2147483999", "--seconds", "0.2",
                           "--trace", str(trace_on)])
    assert run.run(args, device=torch.device("cpu"), overrides=SMALL,
                   out=out, err=err) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert res["attempted"] == len(res["compared"]) == 3
    if not trace_on:
        assert set(res["metrics"]) == {"denoise_ms", "denoise_p95_ms",
                                       "setup_s"}
    else:
        assert "breakdown" in res and "window_s" in res["device"]
    tail = err.getvalue().strip().splitlines()[-3:]
    assert [t.split()[0] for t in tail] == list(res["compared"])
