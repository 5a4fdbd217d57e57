"""The port's subsurface scattering (statmc_tpu_torch/render/bssrdf.py,
render/sss.py and the BSSRDF tables of scene/build.py) against the JAX
package, and the JAX package's own invariants (tests/test_sss.py) run on
the port's functions.

The host precompute (Fresnel moments, beam diffusion, the profile grid,
SubsurfaceFromDiffuse, the stacked tables) is numpy in both packages and
bit-equal.  The device functions run on the same inputs, the JAX ones
eagerly; held within rtol 1e-5 / atol 1e-6 (measured: bit-equal).
Sample_Sp and the exit vertex's direct lighting go through the probe
chain's closest-hit calls in both packages (the fused intersector's
plain version here): ok equal on every lane, p, ns and s/pdf within
rtol 1e-4 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.core import rng as JR
from statmc_tpu.render import bsdf as JB
from statmc_tpu.render import bssrdf as JBD
from statmc_tpu.render import sss as JS
from statmc_tpu.scene.api import parse_scene as j_parse
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch.core import rng as TR
from statmc_tpu_torch.render import bsdf as TB
from statmc_tpu_torch.render import bssrdf as TBD
from statmc_tpu_torch.render import intersect as TX
from statmc_tpu_torch.render import sss as TS
from statmc_tpu_torch.scene import build as sb

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6
ENTRIES = [
    dict(sigma_a=np.array([0.0011, 0.0024, 0.014]) * 50,
         sigma_s=np.array([2.55, 3.21, 3.77]) * 50, g=0.0, eta=1.33),
    dict(sigma_a=np.array([0.5, 0.8, 1.2]), sigma_s=np.array([20., 15., 10.]),
         g=0.3, eta=1.5),
]


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def tables():
    """(JAX tables, port tables as tensors) of two materials with
    different g and eta."""
    return JS.build_sss_tables(ENTRIES), TS.build_sss_tables(
        ENTRIES).to_device("cpu")


@pytest.mark.parametrize("g,eta", [(0.0, 1.33), (0.4, 1.5)])
def test_bssrdf_host_bit_equal(g, eta):
    """bssrdf.py: Fresnel moments, beam diffusion MS/SS, the profile
    grid, _invert_catmull_rom and subsurface_from_diffuse, bit for bit."""
    for e in (0.6, 1.0 / eta, eta, 1.8):
        assert TBD.fresnel_moment1(e) == JBD.fresnel_moment1(e)
        assert TBD.fresnel_moment2(e) == JBD.fresnel_moment2(e)
    r = np.geomspace(1e-3, 5.0, 32)
    for f in ("beam_diffusion_ms", "beam_diffusion_ss"):
        np.testing.assert_array_equal(getattr(TBD, f)(0.7, 0.3, g, eta, r),
                                      getattr(JBD, f)(0.7, 0.3, g, eta, r))
    tj = JBD.compute_beam_diffusion_bssrdf(g=g, eta=eta)
    tt = TBD.compute_beam_diffusion_bssrdf(g=g, eta=eta)
    for a, b in zip(tj, tt):
        np.testing.assert_array_equal(b, a)
    for u in (0.0, 0.05, 0.3, 0.77, 1.0):
        assert (TBD._invert_catmull_rom(tt.rho, tt.rho_eff, u)
                == JBD._invert_catmull_rom(tj.rho, tj.rho_eff, u))
    for rgb, mfp in (([0.8, 0.5, 0.3], [0.1, 0.05, 0.02]), (0.5, 1.0)):
        for a, b in zip(JBD.subsurface_from_diffuse(tj, rgb, mfp),
                        TBD.subsurface_from_diffuse(tt, rgb, mfp)):
            np.testing.assert_array_equal(b, a)


def test_build_sss_tables_bit_equal(tables):
    tj, tt = tables
    assert TS.SSSTables._fields == JS.SSSTables._fields
    for f, a, b in zip(tj._fields, tj, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), f)


def _profile_inputs(seed=1, n=4096):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, n).astype(np.int32),
            rng.integers(0, 3, n).astype(np.int32),
            rng.random(n).astype(np.float32),
            (rng.random(n) * 0.1).astype(np.float32),
            rng.uniform(-1, 1, n).astype(np.float32),
            rng.uniform(1.2, 1.6, n).astype(np.float32))


@pytest.mark.parametrize("fn", ["sample_sr", "pdf_sr", "sp", "fr_dielectric",
                                "sw_eval"])
def test_profile_functions_match(fn, tables):
    """Sample_Sr, Pdf_Sr, Sp, FrDielectric and Sw over seeded lanes."""
    tj, tt = tables
    tid, ch, u, r, cw, eta = _profile_inputs()
    J, T = jnp.asarray, _t
    if fn == "sample_sr":
        a = JS.sample_sr(tj, J(tid), J(ch), J(u))
        b = TS.sample_sr(tt, T(tid), T(ch), T(u))
        assert (np.asarray(a) > 0).all()
    elif fn == "pdf_sr":
        a = np.stack([JS.pdf_sr(tj, J(tid), c, J(r)) for c in range(3)])
        b = torch.stack([TS.pdf_sr(tt, T(tid), c, T(r)) for c in range(3)])
    elif fn == "sp":
        a, b = JS.sp(tj, J(tid), J(r)), TS.sp(tt, T(tid), T(r))
    elif fn == "fr_dielectric":
        a = JS.fr_dielectric(J(cw), 1.0, J(eta))
        b = TS.fr_dielectric(T(cw), 1.0, T(eta))
    else:
        c_sw = np.asarray(tj.c_sw)[tid]
        a = JS.sw_eval(J(eta), J(c_sw), J(cw))
        b = TS.sw_eval(T(eta), T(c_sw), T(cw))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                               atol=ATOL)


def test_find_interval_bit_equal(tables):
    """FindInterval's binary search: the same interval on every lane."""
    tj, tt = tables
    tid, ch, u, _, _, _ = _profile_inputs(3)
    ns = tt.radius.shape[0]
    base = (tid.astype(np.int64) * 3 + ch) * ns
    flat_j, flat_t = tj.cdf.reshape(-1), tt.cdf.reshape(-1)
    up = u * np.asarray(tj.cdf).reshape(-1)[base + ns - 1]
    a = JS._find_interval_rows(jnp.asarray(flat_j), jnp.asarray(base), ns,
                               jnp.asarray(up))
    b = TS._find_interval_rows(flat_t, _t(base), ns, _t(up))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


PLANE = (
    'Integrator "statpath" "integer iterations" [1] "integer maxdepth" [2]\n'
    'Sampler "random" "integer pixelsamples" [1]\n'
    'Film "image" "integer xresolution" [4] "integer yresolution" [4]\n'
    'Camera "perspective" "float fov" [60]\nWorldBegin\n'
    'Material "subsurface" "float scale" [50]\n'
    'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
    '"point P" [-50 -50 0  50 -50 0  50 50 0  -50 50 0]\n'
    'AttributeBegin\n'
    'AreaLightSource "diffuse" "rgb L" [5 5 5]\n'
    'Shape "trianglemesh" "integer indices" [0 2 1 0 3 2] '
    '"point P" [-1 -1 4  1 -1 4  1 1 4  -1 1 4]\n'
    'AttributeEnd\nWorldEnd\n')


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """JAX and port setups of tests/test_sss.py's plane: a 100 x 100
    quad of the default subsurface material (scale 50) under a quad
    light, here wound to face the plane."""
    path = tmp_path_factory.mktemp("plane") / "plane.pbrt"
    path.write_text(PLANE)
    return (JD.prepare(j_parse(str(path))),
            TD.prepare(TD.parse_scene(str(path)), device="cpu"))


def _sp_inputs(sc, n, seed=7):
    rng = np.random.default_rng(seed)
    mat = int(np.flatnonzero(np.asarray(sc.mat_sss_id) >= 0)[0])
    po = np.zeros((n, 3), np.float32)
    po[:, :2] = rng.uniform(-5, 5, (n, 2))
    return (rng.random(n).astype(np.float32),
            rng.random((n, 2)).astype(np.float32), po,
            np.tile(np.float32([0, 0, 1]), (n, 1)), mat,
            rng.random(n) < 0.8)


def test_sample_sp_matches(plane):
    """Sample_Sp from the same draws on the plane, through each package's
    probe chain: ok equal on every lane; p, ns and s/pdf within rtol 1e-4
    / atol 1e-6."""
    js, ts = plane
    n = 4096
    u1, u2, po, ns, mat, act = _sp_inputs(js.scene, n)
    sid = np.zeros(n, np.int32)
    jr = JS.sample_sp(js.scene, js.bvh, js.scene.sss, jnp.asarray(sid),
                      jnp.asarray(po), JB.ShadingFrame.from_normal(
                          jnp.asarray(ns)), jnp.full((n,), mat, jnp.int32),
                      jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(act))
    tr = TS.sample_sp(ts.scene, ts.bvh, ts.scene.sss, _t(sid), _t(po),
                      TB.ShadingFrame.from_normal(_t(ns)),
                      torch.full((n,), mat, dtype=torch.int32), _t(u1),
                      _t(u2), _t(act))
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    print(f"sample_sp: ok on {tr.ok.numpy().mean():.4f} of the lanes")
    # On a plane only the probes along the normal (half the draws) exit.
    assert tr.ok.numpy().mean() > 0.35
    for f in ("p", "ns", "s_over_pdf"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)


def test_estimate_direct_sw_matches(plane):
    """The exit vertex's direct lighting with the Sw lobe: light pick,
    light sample, shadow ray, BSDF-MIS ray, from the same keys."""
    js, ts = plane
    n = 2048
    rng = np.random.default_rng(11)
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.uniform(-3, 3, (n, 2))
    nrm = np.tile(np.float32([0, 0, 1]), (n, 1))
    eta = np.full(n, 1.33, np.float32)
    c_sw = np.full(n, float(np.asarray(js.scene.sss.c_sw)[0]), np.float32)
    act = rng.random(n) < 0.9
    keys = JR.pixel_keys(JR.base_key(3), jnp.arange(n, dtype=jnp.int32), 2)
    a = JS.estimate_direct_sw(js.scene, js.bvh, js.dist, keys, 1,
                              jnp.asarray(p), jnp.asarray(nrm),
                              jnp.asarray(eta), jnp.asarray(c_sw),
                              jnp.asarray(act))
    b = TS.estimate_direct_sw(ts.scene, ts.bvh, ts.dist,
                              _t(keys).to(torch.int64), 1, _t(p), _t(nrm),
                              _t(eta), _t(c_sw), _t(act))
    assert (b.numpy()[act] > 0).mean() > 0.5
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                               atol=1e-6)


def test_scene_tables_convert_sss(plane):
    """convert.scene_tables carries the BSSRDF tables, mat_sss_id and the
    has_hair / has_sss flags into tables equal to prepare()'s."""
    js, ts = plane
    cs = convert.scene_tables(js.scene)
    assert cs.has_sss and ts.scene.has_sss and not cs.has_hair
    assert ts.icfg.enable_sss
    for a, b in zip(cs.sss, ts.scene.sss):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    for f in cs._fields:
        a, b = getattr(cs, f), getattr(ts.scene, f)
        if f in ("textures", "sss"):
            continue
        if torch.is_tensor(a):
            np.testing.assert_array_equal(b.numpy(), a.numpy(), f)
        else:
            assert a == b, f


def test_draw_slots():
    """The BSSRDF draw sites take the JAX package's slot numbers and
    always draw threefry uniforms."""
    names = ("AXIS", "RADIUS", "LIGHT_SELECT", "LIGHT", "NEE_BSDF", "SW")
    assert [getattr(TR, f"SLOT_SSS_{k}") for k in names] == [
        getattr(JR, f"SLOT_SSS_{k}") for k in names] == list(range(13, 19))
    keys = JR.pixel_keys(JR.base_key(0), jnp.arange(64, dtype=jnp.int32), 3)
    np.testing.assert_array_equal(
        TR.uniform_2d(_t(keys).to(torch.int64), 2, TR.SLOT_SSS_RADIUS).numpy(),
        np.asarray(JR.uniform_2d(keys, 2, JR.SLOT_SSS_RADIUS)))


# ---------------------------------------------------------------------------
# The JAX package's invariants (tests/test_sss.py) on the port's functions.

def test_sample_pdf_consistency(tables):
    """The CDF of sampled radii equals the integral of Pdf_Sr over area."""
    _, tt = tables
    n = 4096
    u = torch.tensor((np.arange(n) + 0.5) / n, dtype=torch.float32)
    zeros = torch.zeros((n,), dtype=torch.int32)
    r = TS.sample_sr(tt, zeros, zeros, u).numpy()
    assert (r > 0).all()
    rmax = float(tt.rmax[0, 0])
    grid = np.linspace(1e-5, rmax * 1.001, 2048).astype(np.float32)
    pdf = TS.pdf_sr(tt, torch.zeros(grid.shape, dtype=torch.int32), 0,
                    _t(grid)).numpy()
    dens = pdf * 2.0 * np.pi * grid
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (dens[1:] + dens[:-1])
                                           * np.diff(grid))])
    assert abs(cdf[-1] - 0.999) < 0.01
    for q in (0.1, 0.3, 0.5, 0.7, 0.9):
        assert abs(np.interp(np.quantile(r, q), grid, cdf) - q) < 0.02


def test_sample_sp_plane_integrates_to_rhoeff(plane, monkeypatch):
    """E[Sp/pdf] on an infinite plane = 0.999 rho_eff per channel, with
    the probe chain's geometry replaced through the module-level
    intersect_probe wrapper by the analytic plane z = 0."""
    _, ts = plane
    sc = ts.scene
    real = TS.intersect_probe
    calls = []

    def plane_probe(scene, bvh, o, d, t_max):
        calls.append(int((t_max > 0).sum()))
        h = real(scene, bvh, o, d, torch.zeros_like(t_max))
        t = -o[:, 2] / torch.where(d[:, 2] != 0, d[:, 2], 1.0)
        found = (d[:, 2] != 0) & (t > 0) & (t < t_max)
        mat = int(np.flatnonzero(sc.mat_sss_id.numpy() >= 0)[0])
        n = torch.tensor([0.0, 0.0, 1.0]).expand_as(o)
        return h._replace(
            t=torch.where(found, t, t_max), p=o + t[:, None] * d,
            prim_kind=torch.where(found, TX.PRIM_TRI, TX.PRIM_NONE),
            ns=torch.where(found[:, None], n, 0.0),
            mat_id=torch.where(found, mat, 0).to(torch.int32))

    monkeypatch.setattr(TS, "intersect_probe", plane_probe)
    n = 8192
    u1, u2, po, ns, mat, _ = _sp_inputs(sc, n, seed=7)
    res = TS.sample_sp(sc, ts.bvh, sc.sss,
                       torch.zeros((n,), dtype=torch.int32),
                       torch.zeros((n, 3)),
                       TB.ShadingFrame.from_normal(_t(ns)),
                       torch.full((n,), mat, dtype=torch.int32), _t(u1),
                       _t(u2), torch.ones((n,), dtype=torch.bool))
    assert len(calls) == TS.PROBE_STEPS and calls[0] > 0
    est = res.s_over_pdf.numpy().mean(axis=0)
    np.testing.assert_allclose(est, 0.999 * sc.sss.rhoeff[0].numpy(),
                               rtol=0.08)
    assert np.abs(res.p.numpy()[res.ok.numpy()][:, 2]).max() < 1e-2


def test_exact_replay_refuses_sss(tmp_path):
    """The exact lockstep replay does not model the BSSRDF's draw sites:
    both packages refuse a subsurface scene."""
    path = tmp_path / "plane.pbrt"
    path.write_text(PLANE)
    with pytest.raises(ValueError, match="BSSRDF"):
        TD.load(str(path), device="cpu").render_lockstep_exact(spp=1)
    with pytest.raises(AssertionError, match="BSSRDF"):
        JD.load(str(path)).render_lockstep_exact(spp=1)

