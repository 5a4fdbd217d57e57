"""The cell staircase-mesh2x2-4chip on the CPU: the loop mesh_render on a
2x2 world of CPU ranks over gloo (the launcher's CPU path), this process
rank 0, at small frames (16x12, r = 3: two row slabs of 6 rows, filtered
on slabs with a halo exchange).  Its check reads every rank's share and
is correct; the control (the reference in bfloat16 in the program's
place) fails, and so does each fault planted in every rank: one spp
rank's samples left out of the merge, the halo exchange returning zeros,
and the spp rank 1's draws read at spp rank 0's sample index.  A spawned
rank cannot see this process's monkeypatch, so each fault is a function
of this module, which the loop hands to the spawned ranks to install
(overrides "plant") while this process installs it by monkeypatch.  Each
world has its own timeout, so that a hang fails one test."""
import pytest
import torch
import torch.distributed as dist
from conftest import SMALL

from statbench import cells, judge
from statbench import meshspans as MS

SEED = 2147483999
CELL = "staircase-mesh2x2-4chip"
WORLD_TIMEOUT_S = 90


def _run(plant=None, monkeypatch=None):
    c = cells.find(CELL)
    if plant is not None:
        plant(monkeypatch.setattr)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lp = cells.loop_class(c)(c, SEED, torch.device("cpu"), dict(
            SMALL, world_timeout_s=WORLD_TIMEOUT_S, plant=plant))
        lp.warm_up()
        lp.window(0.05)
        lp.release()
    finally:
        torch.set_num_threads(threads)
    assert not dist.is_initialized()
    return lp


def _values(numbers):
    return {n: v for n, v, _ in numbers}


def test_mesh_cell_correct_on_every_share_and_control_fails():
    lp = _run()
    shares = lp.kept["shares"]
    assert [(sh["spp_index"], sh["px_index"]) for sh in shares] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(sh["slabs"] for sh in shares)  # B2 ran on halo row slabs
    # Every rank holds captured pixels, lanes and queries of its own.
    for sh in shares:
        assert sh["pos"].numel() and sh["lane_pos"].numel()
        assert sh["hits"] and sh["samples"].shape[1] == 8  # 16 spp / 2
    # The last filter centre lies within r = 3 rows of the seam at row 6,
    # so its window holds rows of both slabs.
    _, _, centres = lp.kept["draws"]
    assert 3 <= int(centres[-1]) // 16 <= 8
    notes = []
    numbers = lp.check(notes=notes)
    assert judge.correct(numbers), (numbers, notes)
    got = _values(numbers)
    assert set(got) == set(cells.find(CELL)["limits"])
    assert not judge.correct(lp.check(control=True))


def _left_out(set_):
    """The spp rank 1's samples left out of the merge: its chunk's
    states enter combine_across empty."""
    from statmc_tpu_torch.stats import moments

    across = moments.combine_across

    def left_out(state, group=None):
        if dist.get_rank(group) == 1:
            state = {k: torch.zeros_like(v) for k, v in state.items()}
        return across(state, group)

    set_(moments, "combine_across", left_out)


def _halo_zeros(set_):
    """The halo exchange returning zeros in place of the neighbours'
    rows."""
    from statmc_tpu_torch.parallel import comm

    def zeros(x, r, group, prev, nxt):
        z = x.new_zeros((r, *x.shape[1:]))
        return torch.cat([z, x, z])

    set_(comm, "halo_rows", zeros)


def _draws_shifted(set_):
    """The spp rank 1 ranks (2 and 3 of the 2x2 mesh) draw their samples
    at spp rank 0's sample index."""
    from statmc_tpu_torch import driver

    make = driver.make_sample_fn

    def made(setup):
        step = make(setup)

        def shifted(*a, **kw):
            a = list(a)
            a[6] -= dist.get_rank() // 2  # sample_index
            return step(*a, **kw)

        return shifted

    set_(driver, "make_sample_fn", made)


@pytest.mark.parametrize("plant,number", [
    (_left_out, "samples_missing"),
    (_halo_zeros, "film_f_gap"),
    (_draws_shifted, "path_mismatch_share"),
])
def test_planted_fault_fails_its_number(plant, number, monkeypatch):
    lp = _run(plant, monkeypatch)
    limits = cells.find(CELL)["limits"]
    got = _values(lp.check())
    assert got[number] > limits[number], got


def test_mesh_readers_on_spans():
    """The mesh readers' arithmetic on two ranks' records: the waits from
    the arrivals, the collectives' time by rank, the bytes summed."""
    def span(name, t0, t1, **attrs):
        return {"name": name, "start_ns": t0, "end_ns": t1, "parent": -1,
                "trace": 0, "attrs": attrs}

    ranks = (0, 1)
    ctx = {"spp": 2, "rank_spans": [
        {"spans": [span("mesh.arrive.spp_merge", 0, 100, ranks=ranks),
                   span("mesh.spp_merge", 100, 400),
                   span("mesh.arrive.spp_merge", 500, 600, ranks=ranks),
                   span("mesh.spp_merge", 600, 700)],
         "counters": {"mesh.bytes.spp_merge": 3_000_000, "kernel.B1": 5}},
        {"spans": [span("mesh.arrive.spp_merge", 0, 300, ranks=ranks),
                   span("mesh.spp_merge", 300, 400),
                   span("mesh.arrive.spp_merge", 500, 650, ranks=ranks),
                   span("mesh.spp_merge", 650, 700)],
         "counters": {"mesh.bytes.spp_merge": 1_000_000}}]}
    assert MS.wait_ns(ctx) == [200 + 50, 0]
    assert MS.collective_ns(ctx) == [400, 150]
    assert MS.bytes_total(ctx) == 4_000_000
    assert ctx["notes"][0].startswith("mesh by rank")
    read = {m: cells.metric_reader(m) for m in (
        "comm_ms_per_spp.mesh", "mesh_wait_ms_per_spp.mesh",
        "comm_mb_per_spp.mesh")}
    assert read["comm_ms_per_spp.mesh"](ctx) == pytest.approx(275 / 1e6 / 2)
    assert read["mesh_wait_ms_per_spp.mesh"](ctx) == pytest.approx(
        250 / 1e6 / 2)
    assert read["comm_mb_per_spp.mesh"](ctx) == pytest.approx(2.0)
    # Nothing recorded (the CPU: no profiler ran): every reader None.
    empty = {"spp": 2, "rank_spans": [{"spans": [], "counters": {}}] * 2}
    assert all(f(empty) is None for f in read.values())
