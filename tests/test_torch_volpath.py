"""volpath with participating media end to end: load(...).render() of
the small volpath staircase (a homogeneous haze the camera starts in, an
8^3 grid smoke behind a null-material box, three Fourier spheres and
Fourier clutter boxes; fused path) in both packages, and the JAX
package's media invariants (tests/test_media.py) run on the port.

Ray totals agree within 0.1% and sample counts are equal; every other
buffer agrees within rtol 1e-4 on >= 98.5% of its pixels, from the
port's camera and from the JAX package's camera rays (measured: 99.48%
of pixels at worst from both; tests/test_torch_volpath_floor.py stands
the smoke box on the floor).  Paths diverge
where a tracking decision, a Fourier inversion or a hit point's fused
rounding comes out an ulp apart (tests/test_torch_volume.py and
tests/test_torch_fourier.py count those lane by lane): 0.13% of the
camera paths of a 64x48 render carried a film value off by more than
rtol 1e-4 there.  tests/test_torch_media_twolevel.py holds the
two-level path; tests/test_torch_media.py the JAX package's media
invariants on the port.
"""
import tempfile

import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.render import volume as JV
from statmc_tpu.scene.api import parse_scene as j_parse
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.render import fourier as TF
from statmc_tpu_torch.render import volume as TV
from test_torch_hair_sss import jax_camera
from test_torch_media import HEAD, NULL_FOG, QUAD

torch.set_num_threads(2)
SHARE = 0.985


def _render_jax(path):
    rj = JD.load(str(path))
    totals = [x["rays_total"] for x in rj.render(verbose=False)]
    return rj.s, (totals, {k: np.asarray(v) for k, v in rj.buffers().items()})


def hold_to_jax(jax_render, rt, share=SHARE, max_drift=1e-3):
    """rt.render() against the JAX package's: ray totals within
    max_drift, equal sample counts, every other buffer within rtol 1e-4
    on >= share of its pixels, the film finite with mean > 0."""
    totals, bj = jax_render
    rays = [x["rays_total"] for x in rt.render(verbose=False)]
    assert all(abs(a - b) <= max_drift * b for a, b in zip(rays, totals)), \
        (rays, totals)
    bt = rt.buffers()
    assert bj.keys() == bt.keys()
    shares = {}
    for k in bj:
        a, b = bj[k], np.asarray(bt[k])
        assert a.shape == b.shape, k
        if k.endswith("-n"):
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        close = np.isclose(b, a, rtol=1e-4, atol=1e-6)
        shares[k] = (close.all(-1) if close.ndim == 3 else close).mean()
    worst = min(shares, key=shares.get)
    print(f"worst buffer {worst}: {shares[worst]:.4f} of pixels")
    assert shares[worst] >= share, (worst, shares[worst])
    assert np.isfinite(bt["film"]).all() and bt["film"].mean() > 0


_SHARED = {}


@pytest.fixture(scope="session")
def volpath_staircase(tmp_path_factory):
    """The volpath staircase at 16x12, 1 spp, maxdepth 4, an 8^3 smoke,
    denoised at radius 2: (path, the JAX package's setup), made once per
    process and shared with tests/test_torch_volume.py, which imports
    this fixture (the JAX package's setup takes ~7 s here)."""
    if not _SHARED:
        d = tmp_path_factory.mktemp("volpath")
        path = d / "scene.pbrt"
        path.write_text(TS.volpath_scene_text(
            str(d), width=16, height=12, spp=1, iterations=1, maxdepth=4,
            grid=8, filterradius=2))
        _SHARED["staircase"] = (str(path), JD.prepare(j_parse(str(path))))
    return _SHARED["staircase"]


@pytest.fixture(scope="module")
def staircase(volpath_staircase):
    """(path, JAX setup, JAX render) of the shared volpath staircase.
    (The JAX package compiles and runs it in ~40 s here; at 2 spp, in
    ~110 s.)"""
    path, js = volpath_staircase
    rj = JD.Renderer(js)
    totals = [x["rays_total"] for x in rj.render(verbose=False)]
    return path, js, (totals, {k: np.asarray(v)
                               for k, v in rj.buffers().items()})


def test_volpath_end_to_end(staircase):
    """From the port's own camera."""
    path, js, jax_render = staircase
    rt = TD.load(path, device="cpu")
    assert rt.s.icfg.volumetric and rt.s.icfg.has_grid_media
    assert rt.s.scene.fourier is not None
    assert rt.s.bvh.n_tris == js.bvh.n_tris <= 16384
    hold_to_jax(jax_render, rt)


def test_volpath_end_to_end_jax_camera(staircase, monkeypatch):
    """From the JAX package's camera rays."""
    path, js, jax_render = staircase
    jax_camera(monkeypatch, js)
    hold_to_jax(jax_render, TD.load(path, device="cpu"))


def test_plain_scenes_run_no_media_or_fourier_code(tmp_path, monkeypatch):
    """A scene without media and Fourier materials (and volpath on such a
    scene) never enters render/volume.py or render/fourier.py."""
    def refuse(*a, **k):
        raise AssertionError("media or Fourier code ran on a plain scene")

    for name in ("trace_volpath", "sample_medium", "transmittance_walk"):
        monkeypatch.setattr(TV, name, refuse)
    for name in ("eval_f", "pdf_wi", "sample_wi"):
        monkeypatch.setattr(TF, name, refuse)
    text = TS.scene_text(width=8, height=6, spp=1, iterations=1, maxdepth=3,
                         denoise=False)
    for integ in ("statpath", "volpath"):
        path = tmp_path / f"{integ}.pbrt"
        path.write_text(text.replace('Integrator "statpath"',
                                     f'Integrator "{integ}"'))
        r = TD.load(str(path), device="cpu")
        assert not (r.s.icfg.volumetric or r.s.scene.has_media
                    or r.s.scene.fourier is not None)
        r.render(verbose=False)
        assert np.isfinite(r.film_mean.numpy()).all()


def test_medium_transition_defect_mirrored():
    """ROADMAP.md section C: a surface with no MediumInterface inside a
    fog that a null sphere bounds.  pbrt keeps the ray's medium at such a
    surface (GeometricPrimitive::Intersect: no medium transition), so the
    box's NEE rays start in the fog; the JAX package's _crossing_medium
    returns the shape's own ids, -1, and the port mirrors it: the shadow
    ray from the box starts in vacuum.  Both packages give -1 at the
    box's surface where pbrt gives the fog (0)."""
    import jax.numpy as jnp

    from statmc_tpu.render import intersect as JX
    from statmc_tpu.scene.api import parse_scene
    from statmc_tpu.scene.build import build_scene
    from statmc_tpu_torch.render.intersect import intersect_scene
    from statmc_tpu_torch.scene import build as sb

    text = (HEAD.format(depth=4, spp=1, rr=1, w=8, h=8)
            + NULL_FOG.format(s=0.4)
            + 'Material "matte" "rgb Kd" [0.5 0.5 0.5]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            '"point P" [-0.2 -0.2 1.1  0.2 -0.2 1.1  0.2 0.2 1.1  '
            '-0.2 0.2 1.1]\n'
            + QUAD + 'WorldEnd\n')
    with tempfile.TemporaryDirectory() as tmp:
        p = tmp + "/scene.pbrt"
        with open(p, "w") as f:
            f.write(text)
        js = build_scene(parse_scene(p)).to_device()
        ts = TD.load(p, device="cpu").s
    # A ray inside the fog (medium 0) toward the box's face, and the NEE
    # ray leaving that face back toward the camera side.
    o = np.array([[0.0, 0.0, 0.8]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    med = np.zeros(1, np.int32)
    hj = JX.intersect_scene(js, jnp.asarray(o), jnp.asarray(d),
                            t_max=jnp.full((1,), 1e30))
    ht = intersect_scene(ts.scene, torch.tensor(o), torch.tensor(d),
                         torch.full((1,), 1e30), ts.bvh)
    for scene, hit in ((js, hj), (ts.scene, ht)):
        assert int(hit.prim_kind[0]) == 1  # a triangle of the box, at
        assert abs(float(hit.t[0]) - 0.3) < 1e-5  # z = 1.1
        assert int(scene.mat_type[int(hit.mat_id[0])]) == sb.MAT_MATTE
    back = -d
    assert int(JV._crossing_medium(js, hj, jnp.asarray(back),
                                   jnp.asarray(med))[0]) == -1
    assert int(TV._crossing_medium(ts.scene, ht, torch.tensor(back),
                                   torch.tensor(med))[0]) == -1
