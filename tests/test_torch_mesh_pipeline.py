"""The port's product mesh path, Renderer(mesh=...) through
load(mesh=...), against the JAX package's one-device Renderer on the
CPU over gloo: tests/test_sharding.py's full pipeline (16x16 staircase,
2 iterations, ACRR, SMIS, a denoise of radius 2 on halo-exchange row
slabs) on a 2x2 world, a 15x15 image whose rows do not divide over
"px" (the loud fallback to the replicated filter, and a pixel pad), and
a mesh checkpoint restored into a one-device Renderer.  Film, film-f,
and the ACRR and SMIS feedback within rtol 1e-4 / atol 1e-5 of the port's
one-device render on every pixel, and of the JAX package's on every
pixel of the 16x16 image; n exact.  On the 15x15 image the port's
one-device render itself misses the JAX package's on 1 of 675 ACRR
feedback values after iteration 1 (by 1.4e-4 relative: the packages'
rounding, tests/test_torch_slice.py's module docstring), so the mesh is
held to the JAX package there by tests/test_torch_slice.py's rule: rtol
1e-4 on >= 98.5% of the values."""
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.testscenes import scene_text, staircase_proxy
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch.parallel import launch

torch.set_num_threads(2)
WORLD_TIMEOUT = 120  # s


def _scene(tmp_path, width, height):
    path = tmp_path / f"s{width}x{height}.pbrt"
    path.write_text(scene_text(
        width=width, height=height, spp=2, iterations=2, maxdepth=4,
        denoise=True, filtersd=1.5, filterradius=2,
        body=staircase_proxy(n_steps=4, clutter=4),
        extra_integrator='"bool acrr" ["true"] "integer trackedbounces" '
                         '[3] "bool smis" ["true"] '))
    return str(path)


def _mesh_render(tmp_path, path, states=False, checkpoint=None):
    """render_task on a 2x2 world: rank 0's whole-image results."""
    out = tmp_path / "mesh.pt"
    launch.run_world(launch.render_task, 2, 2,
                     (path, str(out), None, 0, states, checkpoint),
                     devices=["cpu"] * 4, timeout=WORLD_TIMEOUT, threads=1)
    return torch.load(out, weights_only=False)


def _close(got, ref, name, share=1.0):
    got = np.asarray(got).reshape(np.shape(ref))
    if share == 1.0:
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    else:
        close = np.isclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
        assert close.mean() >= share, (name, close.mean())


def _hold(mesh_it, rj, rt, jax_share=1.0):
    """The mesh's whole-image buffers after an iteration against the JAX
    and the port's one-device renderers after the same iteration."""
    for name, j, t in (
            ("film", rj.film_mean, rt.film_mean),
            ("film_f", rj.film_f, rt.film_f),
            ("avg_ls", rj.avg_ls[:rj.P], rt.avg_ls),
            ("win_b", rj.win_b[:rj.P], rt.win_b),
            ("win_l", rj.win_l[:rj.P], rt.win_l)):
        got = mesh_it[name].numpy()
        _close(got, t.numpy(), f"{name} against the port")
        _close(got, j, f"{name} against JAX", jax_share)
    np.testing.assert_array_equal(mesh_it["n"].numpy(),
                                  np.asarray(rj.states[0]["n"])[:, :rj.P])


@pytest.mark.parametrize("width,height,choice,jax_share", [
    (16, 16, "sharded over px=2", 1.0),
    # 225 pixels pad to 226; 15 rows do not divide over px = 2.
    (15, 15, "falling back to the REPLICATED filter", 0.985),
])
def test_mesh_2x2_pipeline_matches_jax(tmp_path, capfd, width, height,
                                       choice, jax_share):
    path = _scene(tmp_path, width, height)
    got = _mesh_render(tmp_path, path, states=True)
    assert choice in capfd.readouterr().out
    assert got["denoise"] == ("slabs" if "sharded" in choice
                              else "replicated")
    rj, rt = JD.load(path), TD.load(path, device="cpu")
    for i, it in enumerate(got["iterations"], 1):
        rj.run_iteration(i)
        rt.run_iteration(i)
        _hold(it, rj, rt, jax_share)
        assert it["stats"] == {k: float(v) for k, v in rt.stats.items()}
        # The pad lane traces pixel 224 again; its rays count, as they do
        # in the JAX package's mesh (the counters above leave it out).
        pad = width * height % 2
        assert (it["log"]["rays_total"] > float(rt.ray_total) if pad
                else it["log"]["rays_total"] == float(rt.ray_total))
        assert set(it["log"]["comm_s"]) >= {"spp_merge", "film_sums"}
        assert it["log"]["comm_bytes"]["spp_merge"] > 0
        assert it["log"]["comm_bytes"]["film_sums"] > 0
        if got["denoise"] == "slabs":
            # The row slabs with their halos filter as the whole image
            # does on the mesh's gathered states.
            derived, film_f = rt._filter(
                it["states"], it["film"].reshape(height, width, 3), height)
            assert torch.equal(it["film_f"], film_f.reshape(-1, 3))
            assert torch.equal(it["avg_ls"], rt._feedback(derived)[0])


def test_mesh_checkpoint_restores_into_one_device(tmp_path):
    """A 2x2 mesh's checkpoint after iteration 1 restores into a
    one-device Renderer bit for bit (the whole image, in the one-device
    format), and the restored renderer's iteration 2 meets the mesh's."""
    path = _scene(tmp_path, 16, 16)
    ck = str(tmp_path / "ck.pt")
    got = _mesh_render(tmp_path, path, states=True, checkpoint=ck)
    it1, it2 = got["iterations"]
    r = TD.load(path, device="cpu")
    r.progress = False
    assert r.restore_checkpoint(ck) == 2
    for t, st in it1["states"].items():
        for k, v in st.items():
            assert torch.equal(r.states[t][k], v), (t, k)
    for k in ("avg_ls", "win_b", "win_l"):
        assert torch.equal(getattr(r, k), it1[k]), k
    assert {k: float(v) for k, v in r.stats.items()} == it1["stats"]
    r.run_iteration(2)
    for k in ("film", "film_f", "avg_ls", "win_b"):
        ref = r.film_mean if k == "film" else getattr(r, k)
        _close(it2[k].numpy(), ref.numpy().reshape(it2[k].shape), k)
