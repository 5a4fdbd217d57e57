"""The realistic camera (statmc_tpu_torch/render/realistic.py, the lens
half of render/camera.py and the driver's lens slot) against the JAX
package.

The host half (the element trace in float64, the thick-lens autofocus,
the 64-slot exit-pupil bounds) is a copy and agrees bit for bit.  The
device half rounds the norms' sums of squares as XLA's compiled code
does (core/math.py dot_fused); on 4,096 seeded film and lens points
`alive` agrees on every lane, origins and weights within rtol 1e-5 and
directions within 1.8e-7 of the jitted JAX function (measured).  The
lens draw (core/rng.py SLOT_LENS) is bit-equal in every sampler mode but
lockstep, whose table has no lens entry in either package.  End to end, the 16x12 realistic staircase agrees with the JAX
package on >= 98.5% of pixels from the JAX package's camera rays and on
96.88% from the port's own (ROADMAP.md section C).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.core import rng as JR
from statmc_tpu.render import camera as JC
from statmc_tpu.render import realistic as JRL
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.core import rng as TR
from statmc_tpu_torch.render import camera as TC
from statmc_tpu_torch.render import realistic as TRL

from test_torch_hair_sss import hold_to_jax

torch.set_num_threads(2)
LENS = os.path.join(os.path.dirname(__file__), "fixtures", "biconvex.dat")


def _rows():
    rows = []
    with open(LENS) as f:
        for line in f:
            rows.extend(float(t) for t in line.split("#", 1)[0].split())
    return np.asarray(rows, np.float64)


C2W = np.array([[0.8, 0.0, 0.6, 1.0], [0.0, 1.0, 0.0, 2.0],
                [-0.6, 0.0, 0.8, -3.0], [0.0, 0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def cams():
    """The JAX package's and the port's realistic cameras, 48x32, an
    aperture of 10 mm focused at 2 m."""
    args = (C2W, _rows(), 48, 32, 10.0, 2.0, 35.0)
    return JC.make_realistic(*args), TC.make_realistic(*args)


def test_slot_lens_is_the_jax_packages():
    assert TR.SLOT_LENS == JR.SLOT_LENS == 12


@pytest.mark.parametrize("aperture,focus,res", [
    (10.0, 2.0, (48, 32)),
    (4.0, TS.STAIRCASE_FOCUS, (16, 12)),
])
def test_make_lens_system_matches_jax(aperture, focus, res):
    """The focused prescription, the rear z, the 64 pupil bounds (each
    from 65,536 host traces) and the film extent, bit for bit."""
    args = (_rows(), aperture, focus, 35e-3, *res)
    lj, lt = JRL.make_lens_system(*args), TRL.make_lens_system(*args)
    for f in ("curvature", "thickness", "eta", "ap_radius", "rear_z",
              "film_diag"):
        assert getattr(lt, f) == getattr(lj, f), f
    np.testing.assert_array_equal(lt.pupil_bounds.numpy(),
                                  np.asarray(lj.pupil_bounds))
    np.testing.assert_array_equal(lt.film_ext.numpy(),
                                  np.asarray(lj.film_ext))


def test_generate_rays_realistic_matches_jax(cams):
    """4,096 seeded film and lens points: alive equal on every lane;
    origins, directions and weights within rtol 1e-5 (the unit
    directions' components near 0 within atol 1e-6: XLA fuses the jitted
    trace differently, 1.8e-7 off at most, measured); dead lanes keep
    direction (0, 0, 1) and weight 0."""
    jc, tc = cams
    rng = np.random.default_rng(7)
    pf = (rng.random((4096, 2)) * [48, 32]).astype(np.float32)
    ul = rng.random((4096, 2)).astype(np.float32)
    oj, dj, wj = (np.asarray(x) for x in jax.jit(
        lambda p, u: JC.generate_rays_weighted(jc, p, u))(
            jnp.asarray(pf), jnp.asarray(ul)))
    ot, dt, wt = (x.numpy() for x in TC.generate_rays_weighted(
        tc, torch.tensor(pf), torch.tensor(ul)))
    alive = wj > 0
    np.testing.assert_array_equal(wt > 0, alive)
    assert 0.5 < alive.mean() < 1.0
    for a, b, atol in ((oj, ot, 0.0), (dj, dt, 1e-6), (wj, wt, 0.0)):
        np.testing.assert_allclose(b[alive], a[alive], rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(dt[~alive], np.tile([0.0, 0.0, 1.0],
                                                      ((~alive).sum(), 1)))
    assert (wt[~alive] == 0).all()


def test_trace_from_film_of_converted_lens(cams):
    """The JAX package's lens system carried across (convert.lens_system)
    traces as the port's own: the same (o, d, alive)."""
    jc, tc = cams
    lens = convert.lens_system(jc.lens)
    rng = np.random.default_rng(3)
    o = torch.tensor(np.c_[rng.uniform(-0.01, 0.01, (512, 2)),
                          np.zeros(512)], dtype=torch.float32)
    d = torch.tensor(np.c_[rng.uniform(-0.2, 0.2, (512, 2)),
                          -np.ones(512)], dtype=torch.float32)
    for a, b in zip(TRL.trace_from_film(lens, o, d),
                    TRL.trace_from_film(tc.lens, o, d)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [JR.MODE_RANDOM, JR.MODE_02,
                                  JR.MODE_HALTON, JR.MODE_SOBOL])
def test_lens_draws_bitwise(mode):
    """draw_2d at SLOT_LENS, bounce 0, in every LD mode and random: the
    LD modes address the slot through N_SLOTS, as the JAX package does."""
    ids = np.arange(2048, dtype=np.int32)
    kj = JR.pixel_keys(JR.base_key(5), jnp.asarray(ids), 3)
    kt = TR.pixel_keys(TR.base_key(5), torch.tensor(ids), 3)
    ld_j = ld_t = None
    if mode != JR.MODE_RANDOM:
        ld_j = (JR.pixel_scramble(JR.base_key(5), jnp.asarray(ids)), 3)
        ld_t = (TR.pixel_scramble(TR.base_key(5), torch.tensor(ids)), 3)
    a = np.asarray(JR.draw_2d(kj, ld_j, mode, 0, JR.SLOT_LENS))
    b = TR.draw_2d(kt, ld_t, mode, 0, TR.SLOT_LENS).numpy()
    np.testing.assert_array_equal(b, a)


def test_lockstep_has_no_lens_slot():
    """Neither package's lockstep table has a lens entry: both raise."""
    tab = np.zeros((4, 2, 40), np.float32)
    with pytest.raises(KeyError):
        JR.draw_2d(None, (jnp.asarray(tab), 0), JR.MODE_LOCKSTEP, 0,
                   JR.SLOT_LENS)
    with pytest.raises(KeyError):
        TR.draw_2d(None, (torch.tensor(tab), 0), TR.MODE_LOCKSTEP, 0,
                   TR.SLOT_LENS)


@pytest.fixture(scope="module")
def staircase(tmp_path_factory):
    """The realistic staircase at 16x12, 2 spp, 2 iterations, maxdepth 3,
    denoised: (path, JAX setup, JAX render)."""
    path = tmp_path_factory.mktemp("real") / "scene.pbrt"
    path.write_text(TS.realistic_scene_text(
        LENS, width=16, height=12, spp=2, iterations=2, maxdepth=3,
        filterradius=2))
    rj = JD.load(str(path))
    totals = [x["rays_total"] for x in rj.render(verbose=False)]
    return str(path), rj.s, (totals, {k: np.asarray(v)
                                      for k, v in rj.buffers().items()})


def test_staircase_end_to_end(staircase):
    """From the port's own camera: equal ray totals, >= 96% of pixels in
    every buffer (measured 96.88%, the denoised film; its camera rays
    differ from those of the JAX package's compiled program by up to
    1.8e-7, and the filter spreads the few paths that part); the
    per-sample driver is pinned."""
    path, js, jax_render = staircase
    rt = TD.load(path, device="cpu")
    assert rt.s.cam.lens is not None
    assert rt.chunk_fn.__qualname__.startswith("make_chunk_fn")
    hold_to_jax(jax_render, rt, 0.96)


def test_staircase_end_to_end_jax_camera(staircase, monkeypatch):
    """From the JAX package's camera rays and weights: >= 98.5%."""
    path, js, jax_render = staircase
    gen_j = jax.jit(lambda p, u: JC.generate_rays_weighted(js.cam, p, u))

    def generate_rays_weighted(cam, p_film, u_lens):
        return tuple(torch.tensor(np.asarray(x)) for x in gen_j(
            jnp.asarray(p_film.numpy()), jnp.asarray(u_lens.numpy())))

    monkeypatch.setattr(TC, "generate_rays_weighted", generate_rays_weighted)
    hold_to_jax(jax_render, TD.load(path, device="cpu"), 0.985)
