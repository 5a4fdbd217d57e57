"""The port's main path against the JAX package, module by module and as
a whole, on the staircase proxy at small sizes.

Where both packages compute the same function on the same inputs, they
agree to float rounding; they cannot agree bit for bit, because XLA's
CPU code contracts products and sums into fused multiply-adds and uses
its own rsqrt, sin, cos, exp and atan2, each off by an ulp from
PyTorch's on some inputs.  The port rounds its camera rays and sphere
tests as XLA does (core/math.py dot_fused, normalize_fused), so its
camera rays equal the JAX package's on ~83% of lanes; the rest differ
by XLA's approximate rsqrt.  From identical rays the bounce loop tracks
the JAX package lane for lane (test_bounce_steps_track_jax).  End to
end, an ulp in a ray decides the spatial light distribution's voxel for
points that lie exactly on a voxel plane (the staircase's risers sit at
integer z, where the 16-voxel grid over z = -8..8 puts its planes) and
moves grazing sphere hits, so about 1 sample in 500 takes another path;
the 5x5 filter then spreads its pixel into up to 25 pixels of the
filtered buffers.  The end-to-end test holds exact counts (n,
rays_total), means within 1e-4, and rtol 1e-4 on 98.5% of the pixels of
every buffer (measured: 98.96-100%).
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.core import rng as JR
from statmc_tpu.render import bsdf as JB
from statmc_tpu.render import camera as JC
from statmc_tpu.render import integrator as JI
from statmc_tpu.render import intersect as JX
from statmc_tpu.render import lights as JL
from statmc_tpu.render.lightdistrib import make_distribution as j_dist
from statmc_tpu.scene.api import parse_scene as j_parse
from statmc_tpu.testscenes import scene_text
import statmc_tpu_torch
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch.render import bsdf as TB
from statmc_tpu_torch.render import integrator as TI
from statmc_tpu_torch.render import intersect as TX
from statmc_tpu_torch.render import lights as TL

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.tensor(np.asarray(x))


def _write(text, tmp_path, name="scene.pbrt"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX and port setups of a 24x16 staircase proxy (maxdepth 4)."""
    path = _write(scene_text(width=24, height=16, spp=2, iterations=2,
                             maxdepth=4, denoise=True, filterradius=2),
                  tmp_path_factory.mktemp("tiny"))
    return path, JD.prepare(j_parse(path)), TD.prepare(
        TD.parse_scene(path), device="cpu")


def test_package_imports_without_jax():
    """Every statmc_tpu_torch module imports with jax blocked, and no
    source file imports jax or the JAX package."""
    pkg = os.path.dirname(statmc_tpu_torch.__file__)
    mods = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
                src = open(os.path.join(root, f)).read()
                assert not re.search(
                    r"^\s*(import|from)\s+(jax|statmc_tpu)(\s|\.|$)",
                    src, re.M), f
    code = ("import sys; sys.modules['jax'] = None\n"
            f"import importlib; [importlib.import_module(m) for m in {mods!r}]\n"
            "assert not any(m == 'jax' or m.startswith('statmc_tpu.') "
            "for m in sys.modules if sys.modules[m] is not None)\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


@pytest.mark.parametrize("edit,cls", [
    (("Integrator \"statpath\"", "Integrator \"mlt\""), "MLTRenderer"),
    (("Integrator \"statpath\"", "Integrator \"bdpt\""), "BDPTRenderer"),
    (("Integrator \"statpath\"",
      "Integrator \"mlt\" \"bool bidirectional\" [\"false\"]"),
     "MLTRenderer"),
])
def test_bdpt_and_mlt_scenes_load(edit, cls, tmp_path, monkeypatch):
    """bdpt and mlt (both mutation modes) are no longer gated: each scene
    loads on the CPU into its renderer and renders a finite film with
    mean > 0 (MLT with 256 chains and a 1,024-path bootstrap)."""
    from statmc_tpu_torch.render import pssmlt

    monkeypatch.setattr(pssmlt, "N_CHAINS", 256)
    monkeypatch.setattr(pssmlt, "N_BOOTSTRAP", 1024)
    text = scene_text(width=8, height=8, spp=1, iterations=1, maxdepth=2)
    assert edit[0] in text
    path = _write(text.replace(edit[0], edit[1]), tmp_path)
    r = TD.load(path, device="cpu")
    assert type(r).__name__ == cls
    if cls == "MLTRenderer":
        assert r.bidirectional == ("false" not in edit[1])
    r.render(verbose=False)
    f = r.film_mean.numpy()
    assert np.isfinite(f).all() and f.mean() > 0


@pytest.mark.parametrize("edit", [
    ("Integrator \"statpath\"",
     "MakeNamedMedium \"fog\" \"string type\" \"homogeneous\" "
     "\"rgb sigma_a\" [0.05 0.05 0.05] \"rgb sigma_s\" [0.1 0.1 0.1]\n"
     "MediumInterface \"\" \"fog\"\nIntegrator \"volpath\""),
    ("Material \"glass\" \"float index\" [1.5]",
     "Material \"fourier\" \"string bsdffile\" [\"{bsdf}\"]"),
])
def test_volpath_and_fourier_scenes_load(edit, tmp_path):
    """Participating media under volpath and Fourier materials are no
    longer gated: such a scene loads on the CPU and renders finite,
    through load() and through the command line."""
    from statmc_tpu_torch import __main__ as TM
    from statmc_tpu_torch.io.pfm import read_pfm
    from statmc_tpu_torch.render import fourier as TF

    mu, ak = TF.lambertian_file([0.6, 0.5, 0.4], n_mu=12)
    bsdf = str(tmp_path / "lamb.bsdf")
    TF.write_bsdf(bsdf, mu, ak, n_channels=3)
    text = scene_text(width=8, height=8, spp=1, iterations=1, maxdepth=2,
                      denoise=False)
    assert edit[0] in text
    path = _write(text.replace(edit[0], edit[1].format(bsdf=bsdf)), tmp_path)
    r = TD.load(path, device="cpu")
    volpath = "volpath" in edit[1]
    assert r.s.icfg.volumetric == volpath
    assert (r.s.scene.fourier is not None) == (not volpath)
    r.render(verbose=False)
    assert np.isfinite(r.film_mean.numpy()).all()
    out = tmp_path / "out"
    TM.main([path, "--device", "cpu", "--writeimages", "--outdir", str(out)])
    pfms = list(out.glob("*-film.pfm"))
    assert pfms and np.isfinite(read_pfm(str(pfms[0]))).all()


@pytest.mark.parametrize("mat", ['Material "hair" "float eumelanin" [0.8]',
                                 'Material "kdsubsurface" "float mfp" [0.1]',
                                 'Material "subsurface" "float scale" [20]'])
def test_hair_and_subsurface_scenes_load(mat, tmp_path):
    """Hair and subsurface materials are no longer gated: such a scene
    loads on the CPU (hair on a curve shape) and renders finite, through
    load() and through the command line."""
    from statmc_tpu_torch import __main__ as TM
    from statmc_tpu_torch.io.pfm import read_pfm

    text = scene_text(width=8, height=8, spp=1, iterations=1, maxdepth=2,
                      denoise=False)
    shape = ('Shape "curve" "point P" [0 1 -4  0.5 2 -4  1 1 -4  1.5 2 -4] '
             '"float width" [0.05]\n' if "hair" in mat
             else 'Shape "sphere" "float radius" [0.5]\n')
    text = text.replace("WorldEnd", f"{mat}\n{shape}WorldEnd")
    path = _write(text, tmp_path)
    r = TD.load(path, device="cpu")
    assert r.s.scene.has_hair == ("hair" in mat)
    assert r.s.icfg.enable_sss == ("hair" not in mat)
    r.render(verbose=False)
    assert np.isfinite(r.film_mean.numpy()).all()
    out = tmp_path / "out"
    TM.main([path, "--device", "cpu", "--writeimages", "--outdir", str(out)])
    pfms = list(out.glob("*-film.pfm"))
    assert pfms and np.isfinite(read_pfm(str(pfms[0]))).all()


def test_camera_and_scene_tables_match(tiny):
    """prepare() builds the JAX package's tables: every SceneTables field
    of the port equals the converted JAX one, and so do the fused
    intersector's tables."""
    _, js, ts = tiny
    cs = convert.scene_tables(js.scene)
    for f in cs._fields:
        a, b = getattr(cs, f), getattr(ts.scene, f)
        if f == "textures":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
        elif a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), f)
    cf = convert.fused_tris(js.bvh)
    for f in ("edge_table", "plane_table", "tile_bounds"):
        np.testing.assert_array_equal(getattr(ts.bvh, f).numpy(),
                                      getattr(cf, f).numpy(), f)
    assert ts.bvh.n_tris == cf.n_tris and (ts.bvh.perm is None) == (
        cf.perm is None)
    assert ts.icfg.max_depth == js.icfg.max_depth
    # arccos of a dot product ~1 turns ulps into ~1e-5 relative.
    np.testing.assert_allclose(ts.icfg.cone_spread, js.icfg.cone_spread,
                               rtol=1e-4)
    px = np.random.default_rng(0).random((500, 2)).astype(np.float32) * 16
    jo, jd = JC.generate_rays(js.cam, jnp.asarray(px))
    to, td = TD.CAM.generate_rays(ts.cam, _t(px))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


def test_rays_round_as_compiled_jax(tiny):
    """Camera rays and sphere distances are rounded as the JAX package's
    compiled code rounds them: camera directions bit-equal on >= 70% of
    lanes (the rest differ by an ulp of XLA's approximate rsqrt; PyTorch's
    own rounding gives ~11%), origins
    and sphere tests bit-equal on every ray, grazing ones included."""
    _, js, ts = tiny
    rng = np.random.default_rng(3)
    R = 2000
    px = (rng.random((R, 2)) * [24, 16]).astype(np.float32)
    jo, jd = jax.jit(lambda p: JC.generate_rays(js.cam, p))(jnp.asarray(px))
    to, td = TD.CAM.generate_rays(ts.cam, _t(px))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert (td.numpy() == np.asarray(jd)).all(-1).mean() >= 0.7
    # Rays from the camera at points just inside and outside each sphere.
    cen = np.asarray(js.scene.sph_center)
    rad = np.asarray(js.scene.sph_radius)
    s = rng.integers(0, len(rad), R)
    u = rng.standard_normal((R, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    aim = cen[s] + u * (rad[s] * rng.uniform(0.9, 1.1, R))[:, None]
    o = np.asarray(jo)
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    args = (o.astype(np.float32), d.astype(np.float32),
            np.full(R, 1e30, np.float32))
    jt, jh = jax.jit(lambda o, d, tm: JX.ray_spheres(
        o, d, js.scene.sph_center, js.scene.sph_radius, tm))(*args)
    tt, th = TX.ray_spheres(*(_t(a) for a in args[:2]), ts.scene.sph_center,
                            ts.scene.sph_radius, _t(args[2]))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.any(-1).float().mean() > 0.3
    np.testing.assert_array_equal(tt.numpy()[th.numpy()],
                                  np.asarray(jt)[np.asarray(jh)])


def test_light_distribution_and_sampling_match(tiny):
    """The spatial voxel pass (sample_li over voxel points, in torch)
    and per-lane light sampling agree with the JAX package."""
    _, js, ts = tiny
    jdist = convert.light_distribution(j_dist(js.scene, "spatial"))
    tdist = ts.dist
    assert jdist.grid_res == tdist.grid_res
    for f in ("world_lo", "world_inv_extent"):
        np.testing.assert_array_equal(getattr(tdist, f).numpy(),
                                      getattr(jdist, f).numpy(), f)
    for f in ("pmf", "cdf"):
        np.testing.assert_allclose(getattr(tdist, f).numpy(),
                                   getattr(jdist, f).numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    rng = np.random.default_rng(1)
    R = 4000
    lo, hi = np.asarray(js.scene.tri_p0).min(0), np.asarray(
        js.scene.tri_p0).max(0)
    p = (lo + rng.random((R, 3)) * (hi - lo)).astype(np.float32)
    u2 = rng.random((R, 2)).astype(np.float32)
    lid = rng.integers(0, int(js.scene.light_kind.shape[0]), R).astype(
        np.int32)
    jl = JL.sample_li(js.scene, jnp.asarray(lid), jnp.asarray(p),
                      jnp.zeros((R, 3)), jnp.asarray(u2))
    tl = TL.sample_li(ts.scene, _t(lid), _t(p), torch.zeros((R, 3)), _t(u2))
    for f in ("wi", "pdf", "li", "p_light", "dist"):
        np.testing.assert_allclose(getattr(tl, f).numpy(),
                                   np.asarray(getattr(jl, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    pj = JL.pdf_li(js.scene, jnp.asarray(lid), jnp.asarray(p), jl.wi,
                   jl.p_light, jnp.asarray(-np.asarray(jl.wi)),
                   jnp.ones(R, bool))
    pt = TL.pdf_li(ts.scene, _t(lid), _t(p), tl.wi, tl.p_light, -tl.wi,
                   torch.ones(R, dtype=torch.bool))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4)


def test_bsdf_sample_and_evaluate_match(tiny):
    """Every ported material family (the scene's matte, substrate, metal
    and glass plus plastic, uber, mirror, disney, rough glass)."""
    _, js, _ = tiny
    rng = np.random.default_rng(2)
    R = 3000
    mats = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9], np.int32)
    mt = mats[rng.integers(0, len(mats), R)]
    rough = np.where(rng.random(R) < 0.5, 0.0, 0.2).astype(np.float32)
    lanes = dict(mat_type=mt, kd=rng.random((R, 3)), ks=rng.random((R, 3)),
                 kr=rng.random((R, 3)), kt=rng.random((R, 3)),
                 eta=np.full((R, 3), 1.5), k=rng.random((R, 3)) * 3,
                 rough_u=np.where(mt == 4, rough, 0.1),
                 rough_v=np.where(mt == 4, rough, 0.15),
                 sigma=np.where(mt == 1, 20.0, 0.3))
    lanes = {k: np.asarray(v, np.int32 if k == "mat_type" else np.float32)
             for k, v in lanes.items()}
    jm = JB.MaterialLanes(**{k: jnp.asarray(v) for k, v in lanes.items()})
    tm = TB.MaterialLanes(**{k: _t(v) for k, v in lanes.items()})
    wo = rng.standard_normal((R, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi = rng.standard_normal((R, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    u2 = rng.random((R, 2)).astype(np.float32)
    uc = rng.random(R).astype(np.float32)
    jf, jp = JB.evaluate(jm, jnp.asarray(wo), jnp.asarray(wi))
    tf, tp = TB.evaluate(tm, _t(wo), _t(wi))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-5)
    js_ = JB.sample(jm, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(uc))
    ts_ = TB.sample(tm, _t(wo), _t(u2), _t(uc))
    for f in ("specular", "transmission"):
        np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                      np.asarray(getattr(js_, f)))
    for f in ("wi", "f", "pdf"):
        a, b = getattr(ts_, f).numpy(), np.asarray(getattr(js_, f))
        close = np.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert close.reshape(R, -1).all(-1).mean() >= 0.999, f


@pytest.mark.parametrize("present", [(1,), (5,), (1, 5), (2, 3), (4,),
                                     (1, 4, 6), (9, 8)])
def test_bsdf_skips_absent_families_bitwise(present):
    """evaluate / sample given the material types that can occur skip
    the other families and leave every lane's value as it was, bit for
    bit."""
    rng = np.random.default_rng(len(present))
    R = 2000
    mt = np.asarray(present, np.int32)[rng.integers(0, len(present), R)]
    rough = np.where(rng.random(R) < 0.5, 0.0, 0.2)
    lanes = dict(mat_type=mt, kd=rng.random((R, 3)), ks=rng.random((R, 3)),
                 kr=rng.random((R, 3)), kt=rng.random((R, 3)),
                 eta=np.full((R, 3), 1.5), k=rng.random((R, 3)) * 3,
                 rough_u=np.where(mt == 4, rough, 0.1),
                 rough_v=np.where(mt == 4, rough, 0.15),
                 sigma=np.where(mt == 1, 20.0 * (rng.random(R) < 0.5), 0.3))
    tm = TB.MaterialLanes(**{k: torch.as_tensor(np.asarray(
        v, np.int32 if k == "mat_type" else np.float32))
        for k, v in lanes.items()})
    wo, wi = (torch.nn.functional.normalize(torch.as_tensor(
        rng.standard_normal((R, 3)).astype(np.float32)), dim=-1)
        for _ in range(2))
    u2 = torch.as_tensor(rng.random((R, 2)).astype(np.float32))
    uc = torch.as_tensor(rng.random(R).astype(np.float32))
    for a, b in zip(TB.evaluate(tm, wo, wi),
                    TB.evaluate(tm, wo, wi, frozenset(present))):
        assert torch.equal(a, b)
    for a, b in zip(TB.sample(tm, wo, u2, uc),
                    TB.sample(tm, wo, u2, uc, frozenset(present))):
        assert torch.equal(a, b)


def test_albedo_curves_match(tiny):
    _, js, ts = tiny
    luts = convert.albedo_luts(js.albedo_luts)
    assert len(luts) == len(ts.albedo_luts) == 2
    for a, b in zip(ts.albedo_luts, luts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_bounce_steps_track_jax(tiny):
    """From the JAX package's camera rays, the port's _bounce_step
    follows the compiled JAX step (as the renderer runs it) lane for lane
    through every bounce (maxdepth 4 + escape), with fused-kernel
    intersection, NEE, BSDF sampling and RR: path state exactly, float
    state within rtol 1e-4 on >= 99% of the lanes (an ulp of a hit point
    moves a later grazing hit on 2 of the 384 lanes)."""
    _, js, ts = tiny
    W, H = 24, 16
    P = W * H
    ids = jnp.arange(P, dtype=jnp.int32)
    keys = JR.pixel_keys(JR.base_key(0), ids, 1)
    u = JR.draw_2d(keys, None, 0, 0, 0)
    px = jnp.stack([(ids % W).astype(jnp.float32),
                    (ids // W).astype(jnp.float32)], -1) + u
    o, d = jax.jit(lambda p: JC.generate_rays(js.cam, p))(px)
    cj = dict(o=o, d=d, **JI._zero_path_carry(P, 1, 1))
    ct = {k: _t(v) for k, v in cj.items()}
    kt = _t(keys).to(torch.int64)
    ones, zeros = jnp.ones((P, 1)), jnp.zeros((P, 1))
    step_j = jax.jit(lambda c, sis: JI._bounce_step(
        js.scene, js.bvh, js.dist, js.icfg, c, sis, keys, ones, zeros, zeros,
        jnp.asarray(False), js.albedo_luts, None))
    for step in range(js.icfg.max_depth + 1):
        sis = jnp.full((P,), step, jnp.int32)
        cj = step_j(cj, sis)
        ct = TI._bounce_step(ts.scene, ts.bvh, ts.dist, ts.icfg, ct,
                             _t(sis), kt, _t(ones), _t(zeros), _t(zeros),
                             False, ts.albedo_luts)
        for k in ("active", "specular", "bounce"):
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
        for k in ("ls", "betas", "n_rays", "path_len", "albedo", "normal"):
            a, b = np.asarray(cj[k]).reshape(P, -1), ct[k].numpy().reshape(
                P, -1)
            close = np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
            assert close.mean() >= 0.99, (step, k, np.nonzero(~close)[0])


@pytest.mark.parametrize("strategy", ["spatial", "power"])
def test_slice_end_to_end(strategy, tmp_path):
    """load(...).render() in both packages: equal buffer names, ray
    totals and sample counts; film, film-f and t*-b*-* buffers within
    rtol 1e-4 on 98.5% of the pixels (module docstring), means within
    1e-4 of the mean magnitude (2e-4 for m3, whose cubes let one
    diverged sample move the mean most: measured 1.03e-4 with the power
    strategy)."""
    extra = f'"string lightsamplestrategy" ["{strategy}"]'
    path = _write(scene_text(width=24, height=16, spp=2, iterations=2,
                             maxdepth=4, denoise=True, filterradius=2,
                             extra_integrator=extra), tmp_path)
    rj, rt = JD.load(path), TD.load(path, device="cpu")
    lj = rj.render(verbose=False)
    lt = rt.render(verbose=False)
    assert [x["rays_total"] for x in lj] == [x["rays_total"] for x in lt]
    bj, bt = rj.buffers(), rt.buffers()
    assert bj.keys() == bt.keys()
    for k in bj:
        a, b = np.asarray(bj[k]), np.asarray(bt[k])
        assert a.shape == b.shape, k
        if k.endswith("-n"):
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        close = np.isclose(b, a, rtol=1e-4, atol=1e-6)
        close = close.all(-1) if close.ndim == 3 else close
        assert close.mean() >= 0.985, (k, close.mean())
        scale = np.abs(a).mean() + 1e-12
        tol = 2e-4 if k.endswith("-m3") else 1e-4
        assert abs(b.mean() - a.mean()) <= tol * scale, k
