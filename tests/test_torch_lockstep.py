"""The lockstep modes of the port against the JAX package and against the
C++ reference's own PFMs.

* core/lockstep.py's tables and streams equal the JAX package's.
* The per-sample driver (driver.make_chunk_fn, which the lockstep table
  pins) equals path regeneration bit for bit, as tests/test_regen.py
  holds for the JAX package (there to XLA's rounding, here exactly: both
  drivers run the same eager ops on the same lanes).
* A render under Sampler "lockstep" matches the JAX package's at the
  slice's rule (tests/test_torch_slice.py).
* The exact replay (render/lockstep_exact.py) consumes the reference's
  per-tile PCG32 streams at the same positions as the JAX package's, and
  matches tests/fixtures/refparity/ (rendered by the reference renderer
  itself, see its README) at tests/test_refparity.py's tolerances: tiny
  and arealight here, mirrorbox, fourtile and tracked in
  tests/test_torch_refparity.py.
"""
import os

import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.core import lockstep as JLS
from statmc_tpu_torch import driver as TD
from statmc_tpu_torch.core import lockstep as TLS
from statmc_tpu_torch.core import rng as TR
from statmc_tpu_torch.io.pfm import read_pfm
from statmc_tpu_torch.render.lockstep_exact import moments_from_samples

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refparity")

# tests/test_regen.py's scene: multi-bounce paths, RR kills, specular
# lobes and rays that miss everything.
SCENE = """
Integrator "statpath" "integer maxdepth" [{maxdepth}] "integer iterations" [1]
  "bool denoiseimage" ["false"] "bool calcstats" ["true"]
  {extra}
Sampler "{sampler}" "integer pixelsamples" [{spp}]
Film "image" "integer xresolution" [8] "integer yresolution" [6]
  "string filename" ["mini.pfm"]
LookAt 0 0.6 -3  0 0.5 0  0 1 0
Camera "perspective" "float fov" [55]
WorldBegin
  Material "matte" "rgb Kd" [0.6 0.5 0.4]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
  Material "mirror" "rgb Kr" [0.8 0.8 0.8]
  AttributeBegin
    Translate 0.8 0.5 0.2
    Shape "sphere" "float radius" [0.45]
  AttributeEnd
  Material "matte" "rgb Kd" [0.3 0.6 0.3]
  AttributeBegin
    Translate -0.8 0.4 0
    Shape "sphere" "float radius" [0.4]
  AttributeEnd
  AttributeBegin
    AreaLightSource "diffuse" "rgb L" [6 5 4]
    Material "matte" "rgb Kd" [0 0 0]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-1 2.5 -1  1 2.5 -1  1 2.5 1  -1 2.5 1]
  AttributeEnd
WorldEnd
"""


def _scene(tmp_path, sampler="random", maxdepth=5, spp=4, extra=""):
    path = tmp_path / "s.pbrt"
    path.write_text(SCENE.format(sampler=sampler, maxdepth=maxdepth,
                                 spp=spp, extra=extra))
    return str(path)


@pytest.mark.parametrize("W,H,spp,steps,seed", [(16, 16, 2, 3, 0),
                                                 (24, 8, 3, 2, 7)])
def test_tables_and_streams_equal_jax(W, H, spp, steps, seed):
    np.testing.assert_array_equal(
        TLS.make_table(W, H, spp, steps, seed),
        JLS.make_table(W, H, spp, steps, seed))
    for a, b in zip(TLS.make_streams(W, H, spp, steps, seed),
                    JLS.make_streams(W, H, spp, steps, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampler,extra,iterations", [
    ("random", "", 1),
    ("02sequence", "", 1),
    ("halton", '"integer pixelbounds" [2 6 1 5]', 1),
    ("random", '"bool acrr" ["true"] "bool smis" ["true"] '
     '"bool denoiseimage" ["true"] "integer filterradius" [2] '
     '"float filtersd" [1.5]', 2),
])
def test_per_sample_driver_equals_regeneration(sampler, extra, iterations,
                                               tmp_path):
    path = _scene(tmp_path, sampler=sampler, maxdepth=6, extra=extra)
    setup = TD.prepare(TD.parse_scene(path), base_seed=3, device="cpu")
    runs = []
    for per_sample in (False, True):
        r = TD.Renderer(setup)
        if per_sample:
            r.chunk_fn = TD.make_chunk_fn(setup)
        r.progress = False
        r.render(iterations=iterations, verbose=False)
        runs.append(r)
    ra, rb = runs
    for name in ("film_sum", "film_w", "ray_total", "avg_ls", "win_b",
                 "win_l"):
        assert torch.equal(getattr(ra, name), getattr(rb, name)), name
    for k in ra.stats:
        assert torch.equal(ra.stats[k], rb.stats[k]), k
    for t, st in ra.states.items():
        for k, v in st.items():
            assert torch.equal(v, rb.states[t][k]), (t, k)


def test_lockstep_sampler_matches_jax(tmp_path):
    """Sampler "lockstep" (the padded PCG32 table, per-sample driver) in
    both packages: equal counts and ray totals, the buffers at the
    slice's rule."""
    path = _scene(tmp_path, sampler="lockstep", maxdepth=5, spp=4)
    rj = JD.load(path, base_seed=3)
    rt = TD.load(path, base_seed=3, device="cpu")
    assert rt.s.icfg.sampler_mode == TR.MODE_LOCKSTEP
    np.testing.assert_array_equal(rt.s.lockstep_tab.numpy(),
                                  np.asarray(rj.s.lockstep_tab))
    lj = rj.render(verbose=False)
    lt = rt.render(verbose=False)
    assert [x["rays_total"] for x in lj] == [x["rays_total"] for x in lt]
    bj, bt = rj.buffers(), rt.buffers()
    assert bj.keys() == bt.keys()
    for k in bj:
        a, b = np.asarray(bj[k]), np.asarray(bt[k])
        if k.endswith("-n"):
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        close = np.isclose(b, a, rtol=1e-4, atol=1e-6)
        close = close.all(-1) if close.ndim == 3 else close
        assert close.mean() >= 0.985, (k, close.mean())


def test_lockstep_table_limit(tmp_path):
    """The table is refused past 512 MiB, as in the JAX package."""
    text = SCENE.format(sampler="lockstep", maxdepth=5, spp=64, extra="")
    text = text.replace('"integer xresolution" [8] "integer yresolution" [6]',
                        '"integer xresolution" [512] '
                        '"integer yresolution" [512]')
    path = tmp_path / "big.pbrt"
    path.write_text(text)
    with pytest.raises(ValueError, match="lockstep sampler table"):
        TD.load(str(path), device="cpu")


# test_lockstep_exact.py's scene: a matte wall (12 draws a sample), a
# mirror strip (7) and the void (5) side by side, maxdepth 1.
MIXED = (
    'Integrator "statpath" "integer maxdepth" [1] '
    '"integer iterations" [1] "bool expiterations" ["false"] '
    '"bool denoiseimage" ["false"] "bool calcstats" ["false"]\n'
    'Sampler "random" "integer pixelsamples" [4]\n'
    'Film "image" "integer xresolution" [24] '
    '"integer yresolution" [8] "string filename" ["x.pfm"]\n'
    "LookAt 0 0 -2  0 0 0  0 1 0\n"
    'Camera "orthographic" "float screenwindow" [-1 1 -1 1]\n'
    "WorldBegin\n"
    'LightSource "point" "rgb I" [10 10 10] "point from" [0 0 -0.5]\n'
    'Material "matte" "rgb Kd" [0.5 0.5 0.5]\n'
    'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" '
    "[-1.2 -1.2 1  0 -1.2 1  0 1.2 1  -1.2 1.2 1]\n"
    'Material "mirror" "rgb Kr" [0.9 0.9 0.9]\n'
    'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" '
    "[0 -1.2 0.9  0.5 -1.2 0.9  0.5 1.2 0.9  0 1.2 0.9]\n"
    "WorldEnd\n")


def test_exact_positions_match_jax_and_geometry(tmp_path):
    """24x8 at 4 spp (a 16-wide tile and a cropped 8-wide one): every
    sample starts and ends at the JAX package's stream positions, the
    positions the geometry implies (matte 12 draws, mirror 7, void 5, in
    the tiles' serial order), and consumes the stream's own values."""
    path = tmp_path / "mixed.pbrt"
    path.write_text(MIXED)
    W, H, spp = 24, 8, 4
    rep = TD.load(str(path), device="cpu").render_lockstep_exact(spp=spp)
    rj = JD.load(str(path)).render_lockstep_exact(spp=spp)
    np.testing.assert_array_equal(rep.cursor_start, rj.cursor_start)
    np.testing.assert_array_equal(rep.cursor_end, rj.cursor_end)
    np.testing.assert_array_equal(rep.u_cam, rj.u_cam)

    xs = np.arange(W * H) % W
    consume = np.where(xs < W // 2, 12, np.where(xs < 3 * W // 4, 7, 5))
    tid, idx, n_tx, n_ty = TLS._tile_geometry(W, H)
    stream, _, _ = TLS.make_streams(W, H, spp, 1)
    for t in range(n_tx * n_ty):
        cur = 0
        for p in np.nonzero(tid == t)[0][np.argsort(idx[tid == t])]:
            for s in range(spp):
                assert rep.cursor_start[p, s] == cur
                np.testing.assert_array_equal(rep.u_cam[p, s],
                                              stream[t, cur:cur + 2])
                cur += consume[p]
                assert rep.cursor_end[p, s] == cur
    assert (rep.film[xs < W // 2].sum(-1) > 0).all()


def check_reference(stem, seed, film_tol, mom_tol, WH=16, tracked=0):
    """tests/test_refparity.py's _check on the port's replay: film, n
    exact, mean / m2 / m3, film-mean, and the tracked bounces' moments."""
    r = TD.load(os.path.join(FIX, f"{stem}.pbrt"), base_seed=seed,
                device="cpu")
    rep = r.render_lockstep_exact(spp=4)
    hold_to_reference(rep, stem, film_tol, mom_tol, WH, tracked)
    return rep


def hold_to_reference(rep, stem, film_tol, mom_tol, WH=16, tracked=0):
    def ref(name):
        return read_pfm(os.path.join(FIX, f"{stem}-4-{name}.pfm"))

    shape = (WH, WH, 3)
    np.testing.assert_allclose(rep.film.reshape(shape), ref("film"),
                               atol=film_tol, rtol=0)
    n, mean, m2, m3 = moments_from_samples(rep.radiance)
    np.testing.assert_array_equal(n.reshape(WH, WH), ref("t0-b0-n"))
    for name, x in (("mean", mean), ("m2", m2), ("m3", m3)):
        np.testing.assert_allclose(x.reshape(shape), ref(f"t0-b0-{name}"),
                                   atol=mom_tol, rtol=0, err_msg=name)
    _, fmean, _, _ = moments_from_samples(rep.radiance, bc_lambda=None)
    np.testing.assert_allclose(fmean.reshape(shape), ref("t0-b0-film-mean"),
                               atol=mom_tol, rtol=0)
    for b in range(1, tracked):
        _, mean, m2, m3 = moments_from_samples(rep.radiance_b[:, :, b])
        for name, x in (("mean", mean), ("m2", m2), ("m3", m3)):
            np.testing.assert_allclose(x.reshape(shape),
                                       ref(f"t0-b{b}-{name}"), atol=1e-3,
                                       rtol=0, err_msg=f"b{b} {name}")


def test_refparity_tiny_matte():
    """Camera-only, NEE + continuation and escape consumption classes; the
    stream positions equal the JAX package's (integers, exact)."""
    rep = check_reference("tiny", 0, film_tol=2e-6, mom_tol=2e-5)
    rj = JD.load(os.path.join(FIX, "tiny.pbrt")).render_lockstep_exact(spp=4)
    np.testing.assert_array_equal(rep.cursor_start, rj.cursor_start)
    np.testing.assert_array_equal(rep.cursor_end, rj.cursor_end)
    np.testing.assert_array_equal(rep.u_cam, rj.u_cam)


def test_refparity_arealight_mis():
    """Area-light NEE draws, the triangle sample's vertex order and the
    BSDF-MIS probe's Le path."""
    check_reference("arealight", 3, film_tol=1e-5, mom_tol=3e-4)
