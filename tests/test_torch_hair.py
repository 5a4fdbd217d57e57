"""The port's Marschner hair (statmc_tpu_torch/render/hair.py and its
plumbing in bsdf.py, intersect.py and albedo_lut.py) against the JAX
package, and the JAX package's own hair invariants (tests/test_hair.py)
run on the port's functions.

Inputs are made from a seed with numpy and go through both packages; the
JAX functions run eagerly (one XLA program per operation, no multiply-add
contracted across operations), as in tests/test_torch_textures.py.
eval_f and pdf agree within rtol 1e-4 / atol 1e-6 on every lane
(measured: 2.6e-5 relative at worst: the port takes exp, log, sinh,
asin and atan2 in float64 and rounds once, XLA has its own float32
ones); sampled directions within atol 1e-4 on >= 99.9% of the lanes
(measured: 9.1e-6 at worst, every lane).  Integer work (the lobe pick,
the demuxed bits) is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.render import albedo_lut as JA
from statmc_tpu.render import bsdf as JB
from statmc_tpu.render import hair as JH
from statmc_tpu.render import intersect as JX
from statmc_tpu.scene.api import parse_scene as j_parse
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch.render import albedo_lut as TA
from statmc_tpu_torch.render import bsdf as TB
from statmc_tpu_torch.render import hair as TH
from statmc_tpu_torch.render import intersect as TX
from statmc_tpu_torch.scene import build as sb

torch.set_num_threads(2)
N_LANES = 4096


def _t(x):
    return torch.tensor(np.asarray(x))


def _sphere(u):
    """Uniform directions on the sphere, numpy [n,3] float32."""
    z = 1.0 - 2.0 * u[:, 0]
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * np.pi * u[:, 1]
    return np.stack([z, r * np.cos(phi), r * np.sin(phi)], -1).astype(
        np.float32)


def _hair_inputs(seed=0, n=N_LANES):
    """Seeded lanes over h, beta_m, beta_n, alpha and sigma_a, with wo,
    wi and the sampling draws."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lanes = (rng.uniform(-0.95, 0.95, n).astype(f32),
             rng.uniform(1.3, 1.8, n).astype(f32),
             rng.uniform(0.0, 2.0, (n, 3)).astype(f32),
             rng.uniform(0.05, 1.0, n).astype(f32),
             rng.uniform(0.05, 1.0, n).astype(f32),
             rng.uniform(0.0, 4.0, n).astype(f32))
    draws = (_sphere(rng.random((n, 2))), _sphere(rng.random((n, 2))),
             rng.random((n, 2)).astype(f32), rng.random(n).astype(f32))
    return lanes, draws


@pytest.mark.parametrize("fn", ["eval_f", "pdf"])
def test_eval_f_and_pdf_match(fn):
    """eval_f and pdf within rtol 1e-4 / atol 1e-6 on every lane."""
    lanes, (wo, wi, _, _) = _hair_inputs()
    a = getattr(JH, fn)(JH.HairLanes(*map(jnp.asarray, lanes)),
                        jnp.asarray(wo), jnp.asarray(wi))
    b = getattr(TH, fn)(TH.HairLanes(*map(_t, lanes)), _t(wo), _t(wi))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                               atol=1e-6)


def test_sample_wi_matches():
    """Sampled wi within atol 1e-4 on >= 99.9% of the lanes: the lobe
    pick compares uc against a 4-entry CDF, so a lane whose uc lies
    within an ulp of a boundary may pick the next lobe."""
    lanes, (wo, _, u2, uc) = _hair_inputs(1)
    a = np.asarray(JH.sample_wi(JH.HairLanes(*map(jnp.asarray, lanes)),
                                jnp.asarray(wo), jnp.asarray(u2),
                                jnp.asarray(uc)))
    b = TH.sample_wi(TH.HairLanes(*map(_t, lanes)), _t(wo), _t(u2),
                     _t(uc)).numpy()
    err = np.abs(a - b).max(-1)
    print(f"sample_wi: worst lane {err.max():.3e}")
    assert (err <= 1e-4).mean() >= 0.999


def test_demux_bit_equal():
    u = np.random.default_rng(2).random(N_LANES).astype(np.float32)
    u[:4] = [0.0, 1.0, 0.5, np.nextafter(np.float32(1), np.float32(0))]
    for a, b in zip(JH._demux(jnp.asarray(u)), TH._demux(_t(u))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_sigma_a_conversions_match():
    """SigmaAFromConcentration / SigmaAFromReflectance: the numpy forms
    scene/build.py calls, and the tensor forms, against the JAX
    package's."""
    for ce, cp in ((1.3, 0.0), (0.3, 0.7), (0.8, 0.2)):
        want = np.asarray(JH.sigma_a_from_concentration(ce, cp))
        np.testing.assert_allclose(TH.sigma_a_from_concentration(ce, cp),
                                   want, rtol=1e-6)
        np.testing.assert_allclose(
            TH.sigma_a_from_concentration(_t(np.float32(ce)), cp).numpy(),
            want, rtol=1e-6)
    for c, bn in (((0.75, 0.55, 0.35), 0.3), ((0.1, 0.5, 0.9), 0.6),
                  ((1e-7, 1.0, 0.2), 0.05)):
        c = np.asarray(c, np.float32)
        want = np.asarray(JH.sigma_a_from_reflectance(jnp.asarray(c), bn))
        np.testing.assert_allclose(TH.sigma_a_from_reflectance(c, bn), want,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            TH.sigma_a_from_reflectance(_t(c), bn).numpy(), want, rtol=1e-6)


HAIR_SCENE = """
Integrator "statpath" "integer maxdepth" [3] "integer iterations" [1]
Sampler "random" "integer pixelsamples" [2]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 0 -1  0 0 2  0 1 0
Camera "perspective" "float fov" [60]
WorldBegin
LightSource "distant" "rgb L" [3 3 3] "point from" [0 2 0] "point to" [0 0 2]
Material "hair" "float eumelanin" [0.8]
Shape "curve" "point P" [-0.6 -0.3 2  -0.2 0.4 2  0.2 -0.4 2  0.6 0.3 2]
  "float width" [0.25]
Material "hair" "rgb color" [0.7 0.5 0.3] "float beta_m" [0.4]
Shape "curve" "point P" [-0.6 0.5 2.2  -0.2 0.1 2.2  0.2 0.8 2.2  0.6 0.2 2.2]
  "float width" [0.2]
Material "matte" "rgb Kd" [0.4 0.4 0.4]
AttributeBegin
  Translate 0 0 4
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-5 -5 0  5 -5 0  5 5 0  -5 5 0]
AttributeEnd
WorldEnd
"""


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    """JAX and port setups of two hair curves (both parameter routes)
    before a matte wall, and seeded rays aimed at the curves."""
    path = tmp_path_factory.mktemp("hair") / "hair.pbrt"
    path.write_text(HAIR_SCENE)
    js, ts = JD.prepare(j_parse(str(path))), TD.prepare(
        TD.parse_scene(str(path)), device="cpu")
    rng = np.random.default_rng(4)
    n = 2048
    o = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    tgt = np.stack([rng.uniform(-0.7, 0.7, n), rng.uniform(-0.6, 0.9, n),
                    np.full(n, 2.1)], -1)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    return js, ts, o.astype(np.float32), d.astype(np.float32)


def test_hair_tables_and_flags(curves):
    """Both hair rows' slots (kt = sigma_a, sigma = beta_m, rough_u =
    beta_n, rough_v = alpha) equal the JAX package's; has_hair set."""
    js, ts, _, _ = curves
    assert ts.scene.has_hair and js.scene.flags.has_hair
    assert not ts.scene.has_sss and ts.scene.sss is None
    for f in ("mat_type", "mat_kd", "mat_kt", "mat_eta", "mat_sigma",
              "mat_rough_u", "mat_rough_v"):
        np.testing.assert_array_equal(getattr(ts.scene, f).numpy(),
                                      np.asarray(getattr(js.scene, f)), f)


def test_curve_hits_tangent_and_hair_h(curves):
    """intersect_scene on the curve scene: the same primitives, the dpdu
    tangent (assembled because the scene has hair) and gather_materials'
    hair_h from the ribbon's v, within 1e-5 (the barycentrics are
    rounded as XLA rounds them in hair scenes)."""
    js, ts, o, d = curves
    n = o.shape[0]
    hj = JX.intersect_scene(js.scene, jnp.asarray(o), jnp.asarray(d),
                            t_max=jnp.full((n,), 1e30), bvh=js.bvh)
    ht = TX.intersect_scene(ts.scene, _t(o), _t(d), torch.full((n,), 1e30),
                            ts.bvh)
    assert ht.tangent is not None and hj.tangent is not None
    np.testing.assert_array_equal(ht.prim_idx.numpy(),
                                  np.asarray(hj.prim_idx))
    hair = (ts.scene.mat_type[ht.mat_id.long()] == sb.MAT_HAIR).numpy()
    assert hair.mean() > 0.2
    np.testing.assert_allclose(ht.tangent.numpy(), np.asarray(hj.tangent),
                               atol=1e-5)
    mj = JB.gather_materials(js.scene, hj.mat_id, hj.uv, hj.p)
    mt = TB.gather_materials(ts.scene, ht.mat_id, ht.uv, ht.p)
    np.testing.assert_allclose(mt.hair_h.numpy(), np.asarray(mj.hair_h),
                               atol=1e-5)
    lean = TX.intersect_scene(ts.scene, _t(o), _t(d), torch.full((n,), 1e30),
                              ts.bvh, lean=True)
    assert lean.tangent is None


def _mixed_lanes(seed, n=N_LANES):
    """Material lanes that mix hair with matte, plastic, glass and
    metal, as numpy fields of JB.MaterialLanes (hair_h last)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    types = np.asarray([sb.MAT_HAIR, sb.MAT_MATTE, sb.MAT_PLASTIC,
                        sb.MAT_GLASS, sb.MAT_METAL], np.int32)
    t = types[rng.integers(0, len(types), n)]
    hair = t == sb.MAT_HAIR
    rough = np.where(hair, rng.uniform(0.1, 0.8, n), 0.1).astype(f32)
    return [t, rng.uniform(0.1, 0.9, (n, 3)).astype(f32),
            rng.uniform(0.0, 0.3, (n, 3)).astype(f32),
            np.ones((n, 3), f32),
            np.where(hair[:, None], rng.uniform(0, 1.5, (n, 3)), 1.0
                     ).astype(f32),
            np.full((n, 3), 1.55, f32),
            np.full((n, 3), 2.0, f32), rough,
            np.where(hair, rng.uniform(0.0, 3.0, n), 0.1).astype(f32),
            np.where(hair, rng.uniform(0.1, 0.8, n), 0.0).astype(f32),
            rng.uniform(-0.95, 0.95, n).astype(f32)]


@pytest.mark.parametrize("route", ["marschner", "fallback"])
def test_evaluate_and_sample_on_mixed_lanes(route):
    """B.evaluate and B.sample over hair mixed with other families: with
    hair_h set, hair lanes take the Marschner model; without it (no uv),
    the fallback lobe pair.  Non-hair lanes are untouched by hair_h."""
    fields = _mixed_lanes(5)
    h = fields.pop()
    lanes_j = JB.MaterialLanes(*map(jnp.asarray, fields), hair_h=(
        jnp.asarray(h) if route == "marschner" else None))
    lanes_t = TB.MaterialLanes(*map(_t, fields), hair_h=(
        _t(h) if route == "marschner" else None))
    rng = np.random.default_rng(6)
    wo, wi = _sphere(rng.random((N_LANES, 2))), _sphere(rng.random(
        (N_LANES, 2)))
    u2 = rng.random((N_LANES, 2)).astype(np.float32)
    uc = rng.random(N_LANES).astype(np.float32)
    fj, pj = JB.evaluate(lanes_j, jnp.asarray(wo), jnp.asarray(wi))
    ft, pt = TB.evaluate(lanes_t, _t(wo), _t(wi))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-6)
    sj = JB.sample(lanes_j, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(uc))
    st = TB.sample(lanes_t, _t(wo), _t(u2), _t(uc))
    np.testing.assert_array_equal(st.specular.numpy(), np.asarray(sj.specular))
    close = np.isclose(st.wi.numpy(), np.asarray(sj.wi), atol=1e-4).all(-1)
    assert close.mean() >= 0.999
    hair = fields[0] == sb.MAT_HAIR
    below = (st.wi.numpy()[:, 2] * wo[:, 2] < 0) & hair
    if route == "marschner":  # TT transmits through the fibre
        assert below[hair].mean() > 0.05
        assert (st.f.numpy()[below] > 0).any()
    else:  # the fallback pair reflects only
        assert (st.f.numpy()[below] == 0).all()


def test_material_curves_with_hair_rows(curves):
    """precompute_material_curves on the hair scene: hair rows take the
    Marschner model at h = 0 over the whole sphere; every row against
    the JAX package's within rtol 1e-3 (128 Monte Carlo draws a row; a
    draw whose lobe pick flips on an ulp moves its row by ~1/128 of one
    sample's weight)."""
    js, ts, _, _ = curves
    lj = JA.precompute_material_curves(js.scene, n_samples=128)
    lt = TA.precompute_material_curves(ts.scene, n_samples=128)
    hair = ts.scene.mat_type.numpy() == sb.MAT_HAIR
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=1e-5)
    assert (lt[1].numpy()[hair] > 0).all() and (lt[0].numpy()[hair] == 0).all()


# ---------------------------------------------------------------------------
# The JAX package's invariants (tests/test_hair.py) on the port's functions.

N = 1 << 16


def _lanes(n, h, beta_m, beta_n, sigma_a=(0.0, 0.0, 0.0), eta=1.55,
           alpha=0.0):
    ones = torch.ones((n,))
    return TH.HairLanes(h=ones * h, eta=ones * eta,
                        sigma_a=torch.tensor(sigma_a).expand(n, 3),
                        beta_m=ones * beta_m, beta_n=ones * beta_n,
                        alpha=ones * alpha)


def _wo(rng, n=N):
    return _t(_sphere(rng.random((1, 2)))).expand(n, 3)


@pytest.mark.parametrize("beta_m,beta_n", [(0.4, 0.6), (0.8, 0.8)])
def test_white_furnace_uniform(beta_m, beta_n):
    """sigma_a = 0: the integral of f |cos| over the sphere is 1."""
    rng = np.random.default_rng(7)
    u = rng.random((N, 2)).astype(np.float32)
    wo = _wo(rng)
    hp = _lanes(N, float(rng.uniform(-0.9, 0.9)), beta_m, beta_n)
    wi = _t(_sphere(u))
    f = TH.eval_f(hp, wo, wi)
    mean = float((f * torch.abs(wi[..., 2:3]) * (4.0 * np.pi)).mean(0)[1])
    assert 0.90 < mean < 1.10, mean


@pytest.mark.parametrize("beta_m,beta_n", [(0.1, 0.2), (0.4, 0.4),
                                           (0.9, 0.9)])
def test_white_furnace_sampled(beta_m, beta_n):
    """E[f |cos| / pdf] = 1 under sample_wi."""
    rng = np.random.default_rng(11)
    wo = _wo(rng)
    hp = _lanes(N, float(rng.uniform(-0.9, 0.9)), beta_m, beta_n)
    u2 = _t(rng.random((N, 2)).astype(np.float32))
    uc = _t(rng.random((N,)).astype(np.float32))
    wi = TH.sample_wi(hp, wo, u2, uc)
    w = (TH.eval_f(hp, wo, wi) * torch.abs(wi[..., 2:3])
         / torch.clamp(TH.pdf(hp, wo, wi), min=1e-12)[..., None])
    mean = float(w.mean(0)[1])
    assert 0.97 < mean < 1.03, mean


def test_pdf_normalized():
    """The integral of pdf over the sphere is 1."""
    rng = np.random.default_rng(3)
    wo = _wo(rng)
    hp = _lanes(N, 0.3, 0.5, 0.5, sigma_a=(0.3, 0.5, 1.2), alpha=2.0)
    wi = _t(_sphere(rng.random((N, 2))))
    est = float((TH.pdf(hp, wo, wi) * 4.0 * np.pi).mean())
    assert 0.92 < est < 1.08, est


def test_sampling_weights_near_one():
    """alpha = 0: the sampled weight f |cos| / pdf stays near 1."""
    rng = np.random.default_rng(5)
    wo = _t(_sphere(rng.random((N, 2))))
    hp = _lanes(N, -0.25, 0.6, 0.7)
    u2 = _t(rng.random((N, 2)).astype(np.float32))
    uc = _t(rng.random((N,)).astype(np.float32))
    wi = TH.sample_wi(hp, wo, u2, uc)
    w = (TH.eval_f(hp, wo, wi)[:, 1] * torch.abs(wi[:, 2])
         / torch.clamp(TH.pdf(hp, wo, wi), min=1e-12)).numpy()
    assert np.isfinite(w).all()
    assert 0.95 < float(np.median(w)) < 1.05, float(np.median(w))


def test_absorption_darkens():
    """Higher sigma_a strictly reduces the furnace response."""
    rng = np.random.default_rng(9)
    wo = _wo(rng)
    wi = _t(_sphere(rng.random((N, 2))))
    means = []
    for sa in (0.0, 0.5, 2.0):
        f = TH.eval_f(_lanes(N, 0.4, 0.5, 0.5, sigma_a=(sa, sa, sa)), wo, wi)
        means.append(float((f[..., 1] * torch.abs(wi[..., 2])).mean()))
    assert means[0] > means[1] > means[2]


def test_material_lanes_wiring():
    """MaterialLanes -> HairLanes: evaluate/sample route hair lanes
    through the Marschner model when hair_h is set; the sampled weight is
    consistent and some directions transmit through the fibre."""
    n = 4096
    rng = np.random.default_rng(13)
    ones = torch.ones((n, 3))
    m = TB.MaterialLanes(
        mat_type=torch.full((n,), sb.MAT_HAIR, dtype=torch.int32),
        kd=0.5 * ones, ks=0.0 * ones, kr=ones, kt=0.0 * ones,
        eta=1.55 * ones, k=0.0 * ones, rough_u=torch.full((n,), 0.6),
        rough_v=torch.full((n,), 0.0), sigma=torch.full((n,), 0.5),
        hair_h=torch.full((n,), 0.2))
    wo = _t(_sphere(rng.random((n, 2))))
    s = TB.sample(m, wo, _t(rng.random((n, 2)).astype(np.float32)),
                  _t(rng.random((n,)).astype(np.float32)))
    w = (s.f[:, 1] * torch.abs(s.wi[:, 2])
         / torch.clamp(s.pdf, min=1e-12)).numpy()
    assert np.isfinite(w).all()
    assert 0.9 < float(np.median(w)) < 1.1, float(np.median(w))
    below = s.wi.numpy()[:, 2] * wo.numpy()[:, 2] < 0
    assert below.mean() > 0.05, below.mean()
