"""The port's mesh (statmc_tpu_torch/parallel/) against the JAX package's
mesh invariants, on the CPU over gloo: Chan's combine and its merge over
a group of ranks against the JAX package's combine (rtol 1e-6), the
filter with zeros in `valid` and the row-sharded filter with its halo
exchange against the JAX package's (tests/test_sharded_filter.py's
inputs, rtol 1e-5 / atol 1e-6) and against the port's unsharded filter,
and the sharded render chunk on a 2x2 mesh against the one-device render
at tests/test_sharding.py's tolerances.  The launcher's world with the
calling process as rank 0 (launch.start_world) against run_world's, a
rank that fails ending such a world within its timeout, and render jobs
run back to back with reset() against separate loads.

Each world is a set of spawned processes (parallel/launch.py, one thread
a rank) that meet through a file store under tmp_path and write rank 0's
results there for the test to read back; its worker lives in the port,
so no rank imports JAX.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import statmc_tpu.driver as JD
from statmc_tpu.denoise.filter_jax import stat_filter as j_stat_filter
from statmc_tpu.denoise.ttest import quantile_table
from statmc_tpu.parallel.shard import make_mesh as j_make_mesh
from statmc_tpu.parallel.shard import make_sharded_filter as j_sharded_filter
from statmc_tpu.stats import moments as JM
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch.denoise import filter as TFL
from statmc_tpu_torch.parallel import launch
from statmc_tpu_torch.stats import moments as TM

torch.set_num_threads(2)
WORLD_TIMEOUT = 90  # s: a world that runs longer (or a rank that fails) fails

# tests/test_sharding.py's SCENE.
SCENE = """
Integrator "statpath" "integer maxdepth" [3] "integer iterations" [1]
  "bool calcstats" ["true"] "float rrthreshold" [0]
Sampler "random" "integer pixelsamples" [4]
Film "image" "integer xresolution" [8] "integer yresolution" [8] "string filename" ["t.pfm"]
Camera "perspective" "float fov" [60]
WorldBegin
  Material "matte" "rgb Kd" [0.5 0.5 0.5]
  Shape "sphere" "float radius" [1.0]
  LightSource "point" "rgb I" [3.14159265 3.14159265 3.14159265]
WorldEnd
"""


def _world(task, n_spp, n_px, *args):
    launch.run_world(task, n_spp, n_px, args, devices=["cpu"] * (n_spp * n_px),
                     timeout=WORLD_TIMEOUT, threads=1)


def _state(rng, shape, transform):
    """A moment state of `shape` pixels x 3 channels from a few samples
    (n may be 0), as numpy arrays."""
    n = rng.integers(0, 6, shape + (1,)).astype(np.float32)
    st = {"n": n}
    for k in ("mean", "m2", "m3") + (("film_mean", "film_m2")
                                     if transform else ()):
        v = rng.gamma(2.0, 0.5, shape + (3,)).astype(np.float32)
        st[k] = np.where(n > 0, v, 0.0).astype(np.float32)
    return st


@pytest.mark.parametrize("transform", [False, True])
def test_combine_matches_jax(transform):
    rng = np.random.default_rng(5)
    a, b = _state(rng, (2, 50), transform), _state(rng, (2, 50), transform)
    ref = JM.combine({k: jnp.asarray(v) for k, v in a.items()},
                     {k: jnp.asarray(v) for k, v in b.items()})
    got = TM.combine({k: torch.as_tensor(v) for k, v in a.items()},
                     {k: torch.as_tensor(v) for k, v in b.items()})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, err_msg=k)


def test_combine_across_three_ranks_matches_sequential_jax(tmp_path):
    """combine_across over a group of 3 ranks (a 3x1 mesh's "spp" axis)
    equals the JAX package's combine of member 0 with 1, then with 2."""
    rng = np.random.default_rng(6)
    states = [_state(rng, (2, 40), True) for _ in range(3)]
    torch.save([{k: torch.as_tensor(v) for k, v in st.items()}
                for st in states], tmp_path / "in.pt")
    _world(launch.combine_task, 3, 1, str(tmp_path / "in.pt"),
           str(tmp_path / "out.pt"))
    got = torch.load(tmp_path / "out.pt", weights_only=True)
    j = [{k: jnp.asarray(v) for k, v in st.items()} for st in states]
    ref = JM.combine(JM.combine(j[0], j[1]), j[2])
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, err_msg=k)


def _filter_inputs():
    """tests/test_sharded_filter.py's inputs: 32x16, C = 3, one G-buffer,
    r = 3, sd 2."""
    H, W, C, G = 32, 16, 3, 1
    rng = np.random.default_rng(0)
    xs = rng.gamma(4.0, 0.25, size=(16, H, W, C)).astype(np.float32)
    ys = 2.0 * (np.sqrt(xs) - 1.0)
    n = np.full((H, W), 16, np.float32)
    mean = ys.mean(0)
    d = ys - mean
    m2 = (d ** 2).sum(0)
    m3 = (d ** 3).sum(0)
    fm = xs.mean(0)
    gb = rng.random((G, H, W, 3)).astype(np.float32)
    film = rng.random((H, W, 3)).astype(np.float32)
    return n, mean, m2, m3, fm, gb, film


GB_FACTOR, DS = -0.5 / 0.1 ** 2, -0.5 / 2.0 ** 2
KEYS = ("mean_corr", "discriminator", "film_mean_f", "film_f")


def test_stat_filter_with_valid_zeros_matches_jax():
    """stat_filter(valid=) with zero rows and scattered zeros, against the
    JAX package's stat_filter(valid=)."""
    n, mean, m2, m3, fm, gb, film = _filter_inputs()
    valid = (np.random.default_rng(1).random(n.shape) > 0.2).astype(
        np.float32)
    valid[:3] = 0.0
    valid[-3:] = 0.0
    tq = quantile_table(0.005)
    ref = j_stat_filter(*(jnp.asarray(x) for x in (n, mean, m2, m3, fm, gb)),
                        jnp.asarray([GB_FACTOR]), jnp.asarray(DS),
                        jnp.asarray(tq), 3, film_img=jnp.asarray(film),
                        valid=jnp.asarray(valid))
    got = TFL.stat_filter(*(torch.as_tensor(x) for x in (
        n, mean, m2, m3, fm, gb[0])), (GB_FACTOR,) * 3, DS,
        torch.as_tensor(tq), 3, film_img=torch.as_tensor(film),
        valid=torch.as_tensor(valid))
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_sharded_filter_on_1x4_matches_jax_and_unsharded(tmp_path):
    """make_sharded_filter on a 1x4 world (8-row slabs, 3 halo rows from
    each neighbour, valid = 0 past the image's edges) against the JAX
    package's make_sharded_filter on make_mesh(1, 4), and bit for bit
    against the port's filter of the whole image."""
    n, mean, m2, m3, fm, gb, film = _filter_inputs()
    H, W, C = mean.shape
    torch.save({"n": torch.as_tensor(n), "mean": torch.as_tensor(mean),
                "m2": torch.as_tensor(m2), "m3": torch.as_tensor(m3),
                "fm": torch.as_tensor(fm), "gb_planes": torch.as_tensor(gb[0]),
                "film": torch.as_tensor(film),
                "gb_factors": [GB_FACTOR] * 3, "ds_factor": DS, "radius": 3},
               tmp_path / "in.pt")
    _world(launch.filter_task, 1, 4, str(tmp_path / "in.pt"),
           str(tmp_path / "out.pt"))
    got = dict(zip(KEYS, torch.load(tmp_path / "out.pt", weights_only=True)))
    jfn = j_sharded_filter(j_make_mesh(1, 4), H, W, C, 1, 3, DS, [GB_FACTOR])
    ref = dict(zip(KEYS, jfn(*(jnp.asarray(x) for x in (
        n, mean, m2, m3, fm, gb, film)))))
    whole = TFL.stat_filter(*(torch.as_tensor(x) for x in (
        n, mean, m2, m3, fm, gb[0])), (GB_FACTOR,) * 3, DS,
        torch.as_tensor(quantile_table(0.005)), 3,
        film_img=torch.as_tensor(film))
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        # The zero halo rows with valid = 0 add exactly nothing.
        assert torch.equal(got[k], whole[k]), k


def test_sharded_chunk_on_2x2_matches_one_device(tmp_path):
    """One call of make_sharded_chunk_fn on a 2x2 world (4 samples, 2 a
    rank, 32 pixels a rank) against the JAX package's and the port's
    one-device render of the same samples: n exact, film and mean within
    rtol 1e-4 / atol 1e-5, m2 within rtol 1e-3 / atol 1e-4
    (tests/test_sharding.py); the counters summed over the mesh."""
    path = tmp_path / "s.pbrt"
    path.write_text(SCENE)
    _world(launch.chunk_task, 2, 2, str(path),
           str(tmp_path / "out.pt"), 4)
    got = torch.load(tmp_path / "out.pt", weights_only=True)
    rj = JD.load(str(path))
    rj.render(iterations=1, verbose=False)
    rt = TD.load(str(path), device="cpu")
    rt.render(iterations=1, verbose=False)
    assert got["stats"]["n_camera_rays"] == 4 * rt.P
    assert got["stats"] == {k: float(v) for k, v in rt.stats.items()}
    assert got["ray_total"] == float(rt.ray_total)
    film = (got["film_sum"] / got["film_w"][:, None]).numpy()
    st = got["states"][0]
    for ref_film, ref_st in (
            (np.asarray(rj.film_sum) / np.asarray(rj.film_w)[:, None],
             {k: np.asarray(v) for k, v in rj.states[0].items()}),
            ((rt.film_sum / rt.film_w[:, None]).numpy(),
             {k: v.numpy() for k, v in rt.states[0].items()})):
        np.testing.assert_allclose(film, ref_film, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(st["n"].numpy(), ref_st["n"])
        np.testing.assert_allclose(st["mean"].numpy(), ref_st["mean"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(st["m2"].numpy(), ref_st["m2"],
                                   rtol=1e-3, atol=1e-4)


def test_spp_merge_differs_from_one_device_in_m3_only(tmp_path):
    """Why a mesh's denoise can miss the one-device render: after one
    iteration of 2 samples split over 2 "spp" ranks, every moment field
    equals the one-device per-sample render's bit for bit except the
    Radiance m3, which is 0 in exact arithmetic: the mesh's merge of two
    one-sample states gives 0, the serial update the rounding left by its
    first sample.  With the mesh's m3 in its states,
    the one-device denoise gives the mesh's film-f and ACRR feedback bit
    for bit (at this size, r = 4, the m3 alone moves the feedback on some
    pixels: the skew correction's acceptance decisions)."""
    from statmc_tpu_torch.stats import estimator as TE
    from statmc_tpu_torch.testscenes import scene_text

    path = tmp_path / "s.pbrt"
    path.write_text(scene_text(
        width=64, height=48, spp=2, iterations=1, maxdepth=4, denoise=True,
        filterradius=4, extra_integrator='"bool acrr" ["true"] '
        '"bool smis" ["true"] '))
    _world(launch.render_task, 2, 1, str(path), str(tmp_path / "out.pt"),
           1, 0, True)
    got = torch.load(tmp_path / "out.pt", weights_only=False)["iterations"][0]
    r = TD.load(str(path), device="cpu")
    r.progress = False
    r.chunk_fn = TD.make_chunk_fn(r.s)
    r.run_iteration(1)
    for t, st in r.states.items():
        for k, v in st.items():
            if (t, k) != (TE.RADIANCE, "m3"):
                assert torch.equal(got["states"][t][k], v), (t, k)
    m3 = r.states[TE.RADIANCE]["m3"]
    assert not torch.equal(got["states"][TE.RADIANCE]["m3"], m3)
    assert not torch.equal(r.avg_ls, got["avg_ls"])
    m3.copy_(got["states"][TE.RADIANCE]["m3"])
    r._denoise()
    assert torch.equal(r.film_f.reshape(-1, 3), got["film_f"])
    assert torch.equal(r.avg_ls, got["avg_ls"])


def _denoised_scene(tmp_path):
    """A 16x12 staircase job of 2 iterations with a denoise of radius 2:
    on a 2x2 mesh, two row slabs of 6 rows."""
    from statmc_tpu_torch.testscenes import scene_text, staircase_proxy

    path = tmp_path / "d.pbrt"
    path.write_text(scene_text(
        width=16, height=12, spp=2, iterations=2, maxdepth=3, denoise=True,
        filterradius=2, body=staircase_proxy(n_steps=4, clutter=4)))
    return str(path)


def test_start_world_matches_run_world(tmp_path):
    """start_world, with this process as rank 0 running render_task
    itself, writes the same whole-image film, film-f, feedback and n as
    run_world's render, bit for bit."""
    path = _denoised_scene(tmp_path)
    _world(launch.render_task, 2, 2, path, str(tmp_path / "a.pt"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as run_world's ranks
    try:
        with launch.start_world(
                launch.render_task, 2, 2, (path, str(tmp_path / "b.pt")),
                devices=["cpu"] * 4, timeout=WORLD_TIMEOUT,
                threads=1) as world:
            assert (world.mesh.rank, world.mesh.spp_index,
                    world.mesh.px_index) == (0, 0, 0)
            launch.render_task(world.mesh, path, str(tmp_path / "b.pt"))
    finally:
        torch.set_num_threads(threads)
    assert not dist.is_initialized()
    a = torch.load(tmp_path / "a.pt", weights_only=False)
    b = torch.load(tmp_path / "b.pt", weights_only=False)
    assert a["denoise"] == b["denoise"] == "slabs"
    for ia, ib in zip(a["iterations"], b["iterations"], strict=True):
        for k in ("film", "film_f", "avg_ls", "n"):
            assert torch.equal(ia[k], ib[k]), k


def test_failing_rank_ends_the_world(tmp_path):
    """A spawned rank that raises (combine_task given one state for two
    "spp" ranks: the ranks at spp 1 raise) while rank 0, this process,
    waits in the merge: the world ends with an error well within its
    timeout, with no rank left alive and this process out of the
    world."""
    rng = np.random.default_rng(7)
    torch.save([{k: torch.as_tensor(v) for k, v in
                 _state(rng, (2, 8), True).items()}], tmp_path / "in.pt")
    args = (str(tmp_path / "in.pt"), str(tmp_path / "out.pt"))
    t0 = time.monotonic()
    world = None
    with pytest.raises(Exception):
        with launch.start_world(launch.combine_task, 2, 2, args,
                                devices=["cpu"] * 4, timeout=WORLD_TIMEOUT,
                                threads=1) as world:
            launch.combine_task(world.mesh, *args)
    assert time.monotonic() - t0 < WORLD_TIMEOUT / 2
    assert world is not None
    assert not any(p.is_alive() for p in world._procs.processes)
    assert not dist.is_initialized()
    assert not (tmp_path / "out.pt").exists()


def test_jobs_after_reset_match_separate_loads(tmp_path):
    """Two render jobs back to back on one mesh Renderer (base seed 3,
    then 5 after reset(): fresh slab states, the same base key on every
    rank, the same groups) against a separate load with base seed 5: the
    second job's film, film-f and every moment state bit for bit."""
    path = _denoised_scene(tmp_path)
    _world(launch.jobs_task, 2, 2, path, str(tmp_path / "jobs.pt"), [3, 5])
    _world(launch.render_task, 2, 2, path, str(tmp_path / "one.pt"), None,
           5, True)
    jobs = torch.load(tmp_path / "jobs.pt", weights_only=False)
    one = torch.load(tmp_path / "one.pt", weights_only=False)["iterations"]
    assert not torch.equal(jobs[0]["film"], jobs[1]["film"])
    assert torch.equal(jobs[1]["film"], one[-1]["film"])
    assert torch.equal(jobs[1]["film_f"], one[-1]["film_f"])
    for t, st in one[-1]["states"].items():
        for k, v in st.items():
            assert torch.equal(jobs[1]["states"][t][k], v), (t, k)
