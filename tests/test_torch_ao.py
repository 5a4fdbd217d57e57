"""`Integrator "ao"` (statmc_tpu_torch/render/ao.py on the shared driver
render/alt_integrators.py) against the JAX package's render/ao.py.

The port probes only the lanes whose camera ray found a surface (the
JAX package masks the others with t_max = 0) and runs the null
pass-through on the null lanes only; each lane's visibility is the same.
On the 16x12 staircase the film is equal to the JAX package's bit for
bit, cosine and uniform (measured); this file holds rtol 1e-5 on
>= 98.5% of pixels and equal ray totals.  tests/test_ao.py's analytic
cases (an open plane gives pi, a closed sphere 0) and a null-material
pane in front of the plane hold the port on its own.
"""
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.render.ao import AORenderer

from test_ao import PLANE, SPHERE, _scene

torch.set_num_threads(2)


def _write(tmp_path, text, name="ao.pbrt"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _films(path, iterations=2):
    rj = JD.load(path, base_seed=3)
    tj = [x["rays_total"] for x in rj.render(iterations=iterations,
                                              verbose=False)]
    rt = TD.load(path, base_seed=3, device="cpu")
    tt = [x["rays_total"] for x in rt.render(iterations=iterations,
                                              verbose=False)]
    return rj, rt, tj, tt


@pytest.mark.parametrize("cossample", [True, False])
def test_staircase_matches_jax(cossample, tmp_path):
    """16x12 staircase, 2 spp, 2 iterations (expiterations), 16 probes:
    the same renderer surface, film within rtol 1e-5 on >= 98.5% of
    pixels, equal ray totals and sample counts."""
    path = _write(tmp_path, TS.ao_scene_text(
        nsamples=16, cossample=cossample, width=16, height=12, spp=2,
        iterations=2))
    rj, rt, tj, tt = _films(path)
    assert isinstance(rt, AORenderer) and rt.cos_sample == cossample
    assert tt == tj and rt.n_cam == rj.n_cam == 4
    a, b = np.asarray(rj.film_mean), rt.film_mean.numpy()
    close = np.isclose(b, a, rtol=1e-5, atol=0).all(-1)
    assert close.mean() >= 0.985, close.mean()
    assert np.isfinite(b).all() and 0 < b.mean() < np.pi
    assert rt.buffers()["film"].shape == (12, 16, 3)


def test_resume_from_jax_state(tmp_path):
    """Iteration 2 from the JAX package's state after iteration 1
    (convert.alt_renderer_state) equals the port's own two iterations."""
    path = _write(tmp_path, TS.ao_scene_text(
        nsamples=8, width=16, height=12, spp=1, iterations=2))
    rj = JD.load(path, base_seed=3)
    rj.render(iterations=1, verbose=False)
    rt = TD.load(path, base_seed=3, device="cpu")
    convert.alt_renderer_state(rj, rt)
    rt.render(iterations=2, start_iteration=2, verbose=False)
    rs = TD.load(path, base_seed=3, device="cpu")
    rs.render(iterations=2, verbose=False)
    assert rt.n_cam == rs.n_cam == 2
    np.testing.assert_allclose(rt.film_mean.numpy(), rs.film_mean.numpy(),
                               rtol=1e-5, atol=0)
    assert float(rt.ray_total) == float(rs.ray_total)


def test_open_plane_is_pi(tmp_path):
    """ao.cpp:97's unnormalized estimator gives pi for an open plane."""
    r = TD.load(_write(tmp_path, _scene(world=PLANE)), device="cpu")
    r.render(iterations=1, verbose=False)
    np.testing.assert_allclose(r.film_mean.numpy(), np.pi, atol=1e-3)


def test_closed_sphere_is_zero(tmp_path):
    r = TD.load(_write(tmp_path, _scene(world=SPHERE)), device="cpu")
    r.render(iterations=1, verbose=False)
    np.testing.assert_allclose(r.film_mean.numpy(), 0.0, atol=1e-6)


def test_null_pane_passes_through(tmp_path):
    """A null-material pane between the camera and the open plane: the
    first hit re-spawns through it (ao.cpp:67-71) to the plane, whose
    probes the pane then occludes (shadow rays do not pass null
    surfaces, in either package), so the film is far below the pane's
    own open-sky pi; the port equals the JAX package."""
    pane = ('Material ""\n'
            'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            '"point P" [-5 1 -5  5 1 -5  5 1 5  -5 1 5]\n')
    path = _write(tmp_path, _scene(world=PLANE + pane))
    rj, rt, tj, tt = _films(path, iterations=1)
    assert tt == tj
    np.testing.assert_allclose(rt.film_mean.numpy(),
                               np.asarray(rj.film_mean), rtol=1e-5)
    assert rt.film_mean.numpy().max() < 1.0


def test_cli_renders_ao(tmp_path, capsys):
    """python -m statmc_tpu_torch --device cpu renders an ao scene and
    writes its film, equal to load(...).render()'s."""
    import statmc_tpu_torch.__main__ as TM
    from statmc_tpu_torch.io.pfm import read_pfm

    path = _write(tmp_path, TS.ao_scene_text(
        nsamples=4, width=8, height=6, spp=1, iterations=1))
    out = tmp_path / "out"
    assert TM.main([path, "--writeimages", "--baseseed", "3", "--outdir",
                    str(out), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "Iteration: 1" in text and "Rays traced 240" in text
    r = TD.load(path, base_seed=3, device="cpu")
    r.render(verbose=False)
    np.testing.assert_array_equal(
        read_pfm(str(out / "staircase-proxy-1-film.pfm")),
        r.buffers()["film"])
