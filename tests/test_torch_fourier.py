"""The port's FourierBSDF (statmc_tpu_torch/render/fourier.py and its
hooks in render/bsdf.py) against the JAX package's
(statmc_tpu/render/fourier.py), and the JAX package's own invariants
(tests/test_fourier.py) run on the port.

The .bsdf reader and writer, lambertian_file and the table stacking are
numpy in both packages and bit-equal.  The device functions run on the
same inputs through small jitted JAX calls, on the three tables of the
volpath scenes (testscenes.fourier_assets: Lambertian 3-channel, a
16-order glossy lobe, eta 1.5 with a transmission lobe): the node
searches and offsets are bit-equal; the floats within rtol 1e-5 / atol
1e-6, except where an inversion carries XLA's own rounding along its
path (the Newton-bisection samplers: test_samplers says how far).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statmc_tpu.render import bsdf as JB
from statmc_tpu.render import fourier as JF
import statmc_tpu.driver as JD
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.render import bsdf as TB
from statmc_tpu_torch.render import fourier as TF
from statmc_tpu_torch.scene import build as sb

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6
R = 4096


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(JAX FourierTables, the port's on the CPU, the files' paths)."""
    d = tmp_path_factory.mktemp("bsdf")
    TS.fourier_assets(str(d), seed=0)
    paths = [str(d / n) for n in TS.FOURIER_FILES]
    jt = JF.stack_tables([JF.read_bsdf(p) for p in paths])
    tt = TF.stack_tables([TF.read_bsdf(p) for p in paths]).to_device("cpu")
    return jt, tt, paths


def _dirs(seed, n=R):
    """wo, wi over the whole sphere (reflection and transmission pairs),
    a few grazing and polar; fid cycling over the three tables and -1."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(2, n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w[0, ::97] = [0.0, 0.0, 1.0]
    w[1, ::89, 2] = 0.0
    w[1] /= np.linalg.norm(w[1], axis=-1, keepdims=True)
    fid = (np.arange(n) % 4 - 1).astype(np.int32)
    u = rng.random((n, 2)).astype(np.float32)
    return w[0], w[1], fid, u


def test_host_code_bit_equal(tables, tmp_path):
    """write_bsdf, read_bsdf, lambertian_file and stack_tables: the same
    bytes and arrays in both packages."""
    jt, tt, paths = tables
    for p in paths:
        a, b = JF.read_bsdf(p), TF.read_bsdf(p)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    mu_j, ak_j = JF.lambertian_file([0.6, 0.4, 0.2], n_mu=12)
    mu_t, ak_t = TF.lambertian_file([0.6, 0.4, 0.2], n_mu=12)
    np.testing.assert_array_equal(mu_t, mu_j)
    JF.write_bsdf(str(tmp_path / "j.bsdf"), mu_j, ak_j, n_channels=3)
    TF.write_bsdf(str(tmp_path / "t.bsdf"), mu_t, ak_t, n_channels=3)
    assert (tmp_path / "j.bsdf").read_bytes() == \
        (tmp_path / "t.bsdf").read_bytes()
    for x, y in zip(jt, tt):
        np.testing.assert_array_equal(_n(y), np.asarray(x))


def test_catmull_rom_weights(tables):
    """Node search and offsets bit-equal, weights within tolerance, on
    cosines across [-1, 1] (nodes, a hair past the ends, in between)."""
    jt, tt, _ = tables
    rng = np.random.default_rng(1)
    f = rng.integers(0, 3, R)
    x = rng.uniform(-1.00002, 1.00002, R).astype(np.float32)
    x[::50] = np.asarray(jt.mu)[f[::50], 3]
    rows, n = np.asarray(jt.mu)[f], np.asarray(jt.n_mu)[f]
    oj, wj, kj = jax.jit(JF._catmull_rom_weights)(rows, n, x)
    ot, wt, kt = TF._catmull_rom_weights(_t(rows), _t(n), _t(x))
    np.testing.assert_array_equal(_n(ot), np.asarray(oj))
    np.testing.assert_array_equal(_n(kt), np.asarray(kj))
    np.testing.assert_allclose(_n(wt), np.asarray(wj), rtol=RTOL, atol=ATOL)


def test_eval_f_and_pdf(tables):
    """eval_f (every table, fid -1 giving 0) and pdf_wi."""
    jt, tt, _ = tables
    wo, wi, fid, _ = _dirs(2)
    fj = jax.jit(JF.eval_f)(jt, fid, wo, wi)
    ft = TF.eval_f(tt, _t(fid), _t(wo), _t(wi))
    np.testing.assert_allclose(_n(ft), np.asarray(fj), rtol=RTOL, atol=ATOL)
    assert (np.asarray(fj)[fid < 0] == 0).all()
    assert (np.asarray(fj)[fid >= 0] > 0).mean() > 0.3
    pj = jax.jit(JF.pdf_wi)(jt, fid, wo, wi)
    pt = TF.pdf_wi(tt, _t(fid), _t(wo), _t(wi))
    np.testing.assert_allclose(_n(pt), np.asarray(pj), rtol=RTOL, atol=ATOL)


def test_interp_and_luminance(tables):
    """_interp_over_muo and _luminance_ak (the sampler's interpolated
    marginal rows and the Y series)."""
    jt, tt, _ = tables
    wo, wi, fid, _ = _dirs(3)
    f = np.maximum(fid, 0)
    nP = jt.mu.shape[1]
    rows, n = np.asarray(jt.mu)[f], np.asarray(jt.n_mu)[f]
    oo, wO, _ = jax.jit(JF._catmull_rom_weights)(rows, n, wo[:, 2])
    ij = jax.jit(lambda c, ff, a, b: JF._interp_over_muo(c, ff, a, b, nP))(
        jt.cdf.reshape(-1, nP), f, oo, wO)
    it = TF._interp_over_muo(tt.cdf.reshape(-1, nP), _t(f).long(), _t(oo),
                             _t(wO), nP)
    np.testing.assert_allclose(_n(it), np.asarray(ij), rtol=RTOL, atol=ATOL)
    aj = jax.jit(lambda ff, a, b: JF._luminance_ak(jt, ff, a, b))(
        f, -wi[:, 2], wo[:, 2])
    at = TF._luminance_ak(tt, _t(f).long(), _t(-wi[:, 2]), _t(wo[:, 2]))
    np.testing.assert_allclose(_n(at[0]), np.asarray(aj[0]), rtol=RTOL,
                               atol=ATOL)
    for k in (1, 2):
        np.testing.assert_array_equal(_n(at[k]), np.asarray(aj[k]))


def _as_x64(jt):
    """The JAX tables with their float32 arrays in float64."""
    return jt._replace(**{k: jnp.asarray(np.asarray(v), jnp.float64)
                          for k, v in jt._asdict().items()
                          if np.asarray(v).dtype == np.float32})


def test_samplers(tables):
    """sample_mu_i, _sample_fourier_phi and sample_wi against the JAX
    package's, at rtol 1e-5 / atol 1e-6 lane by lane, with the JAX
    package's own spread as the witness for the lanes off.  Both
    inversions run a fixed number of Newton-bisection steps whose bracket
    shrinks only when a step leaves it, so on some lanes the result
    carries the rounding of the CDF or of the azimuth series along its
    path.  The JAX package disagrees with itself there: run in float64
    (jax.enable_x64) and op by op (jax.disable_jit, no fusion) against
    its compiled float32 run, it leaves as many lanes off at rtol 1e-5 as
    the port does, or more.  So each output must agree on at least the
    share of lanes on which the JAX package's compiled run agrees with
    the less faithful of its two other runs (measured: phi on 93.2% of
    lanes against 91.8% for float64, pdf_phi 90.2% against 88.6%, wi
    84.1% against 80.6%, pdf 90.0% against 88.3%; mu and pdf_mu as the
    op-by-op run, 99.93% and 99.85%), and every value within 1e-3.  (The
    port sums the azimuth series in float64, so the card and the CPU
    agree.)"""
    jt, tt, _ = tables
    wo, _, fid, u = _dirs(4)
    f = np.maximum(fid, 0)

    def runs(fn, *args):
        """fn(tables, *args) compiled in float32, compiled in float64 and
        op by op in float32."""
        with jax.enable_x64(True):
            x64 = jax.jit(lambda *a: fn(_as_x64(jt), *a))(*(
                a.astype(np.float64) if a.dtype == np.float32 else a
                for a in args))
        with jax.disable_jit():
            eager = fn(jt, *args)
        return jax.jit(lambda *a: fn(jt, *a))(*args), x64, eager

    def close(a, b):
        c = np.isclose(np.asarray(b, np.float32), np.asarray(a), rtol=RTOL,
                       atol=ATOL)
        return c.all(-1) if c.ndim == 2 else c

    def held(out, port, names):
        for (j32, j64, eager), b, name in zip(zip(*out), port, names):
            b = _n(b)
            witness = min(close(j32, j64).mean(), close(j32, eager).mean())
            share = close(j32, b).mean()
            assert share >= witness, (name, share, witness)
            np.testing.assert_allclose(b, np.asarray(j32), rtol=0,
                                       atol=1e-3, err_msg=name)

    out = runs(JF.sample_mu_i, f, wo[:, 2], u[:, 1])
    mt = TF.sample_mu_i(tt, _t(f).long(), _t(wo[:, 2]), _t(u[:, 1]))
    held(out, mt[:2], ("mu_i", "pdf_mu"))
    assert np.array_equal(np.asarray(out[0][2]), _n(mt[2]))  # ok
    ak = np.asarray(jax.jit(lambda ff, a, b: JF._luminance_ak(
        jt, ff, a, b))(f, np.asarray(out[0][0]), wo[:, 2])[0])
    out = runs(lambda _, a, uu: JF._sample_fourier_phi(a, uu), ak, u[:, 0])
    held(out, TF._sample_fourier_phi(_t(ak), _t(u[:, 0])),
         ("phi", "pdf_phi"))
    out = runs(JF.sample_wi, fid, wo, u)
    held(out, TF.sample_wi(tt, _t(fid), _t(wo), _t(u)), ("wi", "pdf"))


def test_bsdf_hooks(tables):
    """bsdf.evaluate over lanes of mixed materials (Fourier with and
    without a table, substrate, matte) equals the JAX package's, which
    runs the table over every lane; bsdf.sample, with the table run on
    the gathered Fourier lanes, gives those lanes fourier.sample_wi's
    directions and evaluate's f and pdf there, bit for bit, and every
    other lane the values it has without the tables."""
    jt, tt, _ = tables
    wo, wi, fid, u = _dirs(5)
    wo[:, 2] = np.abs(wo[:, 2])
    t = np.where(np.arange(R) % 3 == 0, sb.MAT_MATTE,
                 np.where(np.arange(R) % 3 == 1, sb.MAT_FOURIER,
                          sb.MAT_SUBSTRATE)).astype(np.int32)
    rng = np.random.default_rng(6)
    kd = rng.random((R, 3)).astype(np.float32)
    ks = (0.1 * rng.random((R, 3))).astype(np.float32)
    rough = (0.05 + 0.3 * rng.random(R)).astype(np.float32)
    common = dict(mat_type=t, kd=kd, ks=ks, kr=np.zeros((R, 3), np.float32),
                  kt=np.zeros((R, 3), np.float32),
                  eta=np.full((R, 3), 1.5, np.float32),
                  k=np.zeros((R, 3), np.float32), rough_u=rough,
                  rough_v=rough, sigma=np.zeros(R, np.float32))
    mj = JB.MaterialLanes(**{k: jnp.asarray(v) for k, v in common.items()},
                          fourier_id=jnp.asarray(fid), fourier_tab=jt)
    mt = TB.MaterialLanes(**{k: _t(v) for k, v in common.items()},
                          fourier_id=_t(fid), fourier_tab=tt)
    present = frozenset((sb.MAT_MATTE, sb.MAT_FOURIER, sb.MAT_SUBSTRATE))
    ej = jax.jit(JB.evaluate)(mj, wo, wi)
    et = TB.evaluate(mt, _t(wo), _t(wi), present)
    for a, b in zip(ej, et):
        np.testing.assert_allclose(_n(b), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)

    s = TB.sample(mt, _t(wo), _t(u), _t(u[:, 0]), present)
    s0 = TB.sample(mt._replace(fourier_id=None, fourier_tab=None), _t(wo),
                   _t(u), _t(u[:, 0]), present)
    table = (t == sb.MAT_FOURIER) & (fid >= 0)
    assert table.any()
    wi_f, _ = TF.sample_wi(tt, _t(fid[table]), _t(wo[table]), _t(u[table]))
    assert torch.equal(s.wi[table], wi_f)
    f_e, pdf_e = TB.evaluate(mt, _t(wo), s.wi, present)
    assert torch.equal(s.f[table], f_e[table])
    assert torch.equal(s.pdf[table], pdf_e[table])
    for a, b in zip(s, s0):
        assert torch.equal(a[~table], b[~table])


# ---------------------------------------------------------------------------
# The JAX package's invariants (tests/test_fourier.py), on the port.


def _lambertian_table(tmp_path, albedo, n_mu=32, name="lamb.bsdf"):
    mu, ak = TF.lambertian_file(albedo, n_mu=n_mu)
    p = str(tmp_path / name)
    nch = 3 if np.atleast_1d(albedo).shape[0] == 3 else 1
    TF.write_bsdf(p, mu, ak, eta=1.0, n_channels=nch)
    return p


def test_lambertian_eval_matches_analytic(tmp_path):
    """A Lambertian table evaluates to rho/pi (on average within 5e-3,
    pointwise within 5% away from grazing)."""
    albedo = np.array([0.6, 0.4, 0.2])
    tab = TF.stack_tables([TF.read_bsdf(_lambertian_table(
        tmp_path, albedo, n_mu=64))]).to_device("cpu")
    rng = np.random.default_rng(1)

    def hemi(n):
        w = rng.standard_normal((n, 3)).astype(np.float32)
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        w[:, 2] = np.abs(w[:, 2]) + 0.05
        return w / np.linalg.norm(w, axis=1, keepdims=True)

    wo, wi = hemi(512), hemi(512)
    out = _n(TF.eval_f(tab, torch.zeros(512, dtype=torch.int32), _t(wo),
                       _t(wi)))
    exp = albedo / np.pi
    assert np.abs(out.mean(axis=0) - exp).max() < 5e-3
    mask = (wi[:, 2] > 0.2) & (wo[:, 2] > 0.2)
    assert (np.abs(out[mask] - exp) / exp).max() < 0.05


def test_sampler_chi2_consistency(tmp_path):
    """tests/test_fourier.py's sampler check on the port: sample_wi's pdf
    equals pdf_wi at the sampled direction, E[1/pdf] is the sphere's
    4 pi, and two independent sample sets give the same zenith
    histogram."""
    n_mu = 8
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    ak_list = [[None] * n_mu for _ in range(n_mu)]
    for i in range(n_mu):
        for o in range(n_mu):
            amp = 0.2 + abs(mu[i]) * abs(mu[o])
            ak_list[i][o] = np.array([[amp, 0.0, 0.4 * amp]], np.float32)
    path = str(tmp_path / "glossy.bsdf")
    TF.write_bsdf(path, mu, ak_list, eta=1.0, n_channels=1)
    tab = TF.stack_tables([TF.read_bsdf(path)]).to_device("cpu")
    rng = np.random.default_rng(5)
    wo = _t(np.tile([[0.42, 0.1, 0.9]], (R, 1))
            / np.linalg.norm([0.42, 0.1, 0.9])).float()
    fid = torch.zeros(R, dtype=torch.int32)
    wi, pdf_s = TF.sample_wi(tab, fid, wo, _t(rng.random((R, 2))).float())
    pdf_e = _n(TF.pdf_wi(tab, fid, wo, wi))
    wi, pdf_s = _n(wi), _n(pdf_s)
    ok = pdf_s > 1e-6
    assert ok.mean() > 0.95
    np.testing.assert_allclose(pdf_e[ok], pdf_s[ok], rtol=5e-2, atol=1e-4)
    measure = float(np.mean(1.0 / pdf_s[ok]))
    assert abs(measure - 4.0 * np.pi) / (4.0 * np.pi) < 0.1, measure
    hist, _ = np.histogram(-wi[ok, 2], bins=8, range=(-1, 1))
    wib, pdfb = TF.sample_wi(tab, fid, wo, _t(rng.random((R, 2))).float())
    okb = _n(pdfb) > 1e-6
    histb, _ = np.histogram(-_n(wib)[okb, 2], bins=8, range=(-1, 1))
    assert np.abs(hist / ok.sum() - histb / okb.sum()).max() < 0.05


def test_port_lambertian_table_renders_like_matte(tmp_path):
    """A fourier material with a Lambertian table renders (to Monte Carlo
    noise, 3%) like matte with the same albedo, through load().render()
    on the CPU (tests/test_fourier.py's 8x8 film at 48 spp becomes 32x24
    at 4 spp: as many samples in fewer bounce loops); a missing .bsdf
    keeps the substrate fallback and joins the missing-asset report."""
    bsdf_path = _lambertian_table(tmp_path, np.array([0.5, 0.5, 0.5]),
                                  n_mu=64)
    head = """
Film "image" "integer xresolution" [32] "integer yresolution" [24]
Camera "perspective" "float fov" [90]
Sampler "random" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [5]
WorldBegin
LightSource "point" "rgb I" [3.14159265 3.14159265 3.14159265]
AttributeBegin
  {mat}
  ReverseOrientation
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""
    means = []
    for name, mat in (("fourier", f'Material "fourier" "string bsdffile" '
                                  f'["{bsdf_path}"]'),
                      ("matte", 'Material "matte" "rgb Kd" [0.5 0.5 0.5]')):
        p = tmp_path / f"{name}.pbrt"
        p.write_text(head.format(mat=mat))
        r = TD.load(str(p), device="cpu")
        assert (r.s.scene.fourier is not None) == (name == "fourier")
        r.render(iterations=1, verbose=False)
        means.append(float(r.film_mean.mean()))
    assert abs(means[0] - means[1]) / means[1] < 0.03, means

    p = tmp_path / "missing.pbrt"
    p.write_text(head.format(
        mat='Material "fourier" "string bsdffile" ["/nonexistent/p.bsdf"]'))
    from statmc_tpu_torch.scene.api import parse_scene

    desc = parse_scene(str(p))
    tabs = sb.build_scene(desc)
    assert tabs.fourier is None and (tabs.mat_fourier_id < 0).all()
    with pytest.raises(sb.MissingAssetError):
        sb.build_scene(desc, strict=True)


def test_statpath_fourier_end_to_end(tmp_path):
    """statpath (no media) on the staircase proxy with the three Fourier
    tables on three spheres and a quarter of the clutter boxes, at 16x12,
    1 spp: the port's render against the JAX package's, ray totals
    within 0.1%, sample counts equal, every buffer within rtol 1e-4 on
    >= 98.5% of its pixels."""
    from test_torch_volpath import hold_to_jax

    TS.fourier_assets(str(tmp_path), seed=0)
    mats = [TS._FOURIER.format(tmp_path / n) for n in TS.FOURIER_FILES]
    body = TS.staircase_proxy(clutter_mats=[mats[0], None, None, None])
    body += TS._sss_spheres([(mats[1], (4.0, 0.9, -2.8, 0.9)),
                             (mats[2], (0.2, 0.8, -4.6, 0.75)),
                             (mats[0], (-2.2, 1.2, -0.6, 0.9))])
    path = tmp_path / "scene.pbrt"
    path.write_text(TS.scene_text(width=16, height=12, spp=1, iterations=1,
                                  maxdepth=4, filterradius=2, body=body))
    rj = JD.load(str(path))
    totals = [x["rays_total"] for x in rj.render(verbose=False)]
    bj = {k: np.asarray(v) for k, v in rj.buffers().items()}
    rt = TD.load(str(path), device="cpu")
    assert rt.s.scene.fourier is not None and not rt.s.icfg.volumetric
    hold_to_jax((totals, bj), rt)
