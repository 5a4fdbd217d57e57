"""`Integrator "sppm"` (statmc_tpu_torch/render/sppm.py) against the JAX
package's render/sppm.py.

The photon-allocation pmf, the light picks (searchsorted on the power
CDF, summed in the JAX package's order) and sample_le agree on 4,096
lanes; the picks bit for bit.  The port's deposit finds its pairs
through a uniform grid of the visible points (grid_pairs); against the
JAX package's dense [P, Nph] deposit the pair set is the same, m_count
equal and phi within rtol 1e-5.  One SPPM pass at 16x12 with 4,096
photons, and a second from the JAX package's state after its first
(convert.alt_renderer_state), hold radius, n_acc, tau, Ld and the film
within rtol 1e-4 (measured: equal radius and n_acc, tau and Ld within
rtol 1e-4 on every pixel).  Two JAX-package behaviours are mirrored and
recorded in ROADMAP.md section C: spot photons carry no falloff, and
infinite, goniometric and projection lights emit none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.render import bsdf as JB
from statmc_tpu.render import lights as JL
from statmc_tpu.render import sppm as JS
from statmc_tpu.scene.api import parse_scene as j_parse
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.render import sppm as TSP
from statmc_tpu_torch.scene import build as TB

torch.set_num_threads(2)
N = 4096

LIGHTS = (
    'LightSource "point" "rgb I" [3 3 3] "point from" [0 6 0]\n'
    'LightSource "spot" "rgb I" [8 6 4] "point from" [2 7 1] '
    '"point to" [0 0 0] "float coneangle" [35] "float conedeltaangle" [15]\n'
    'LightSource "distant" "rgb L" [0.5 0.5 0.6] "point from" [1 4 2] '
    '"point to" [0 0 0]\n'
    'LightSource "infinite" "rgb L" [0.1 0.1 0.2]\n'
    'LightSource "goniometric" "rgb I" [2 2 2]\n'
    'LightSource "projection" "rgb I" [2 2 2] "float fov" [40]\n'
    'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [4 4 4]\n'
    'Translate 2 3 1\nShape "sphere" "float radius" [0.3]\nAttributeEnd\n'
)


@pytest.fixture(scope="module")
def lights_scene(tmp_path_factory):
    """The 16x12 staircase (its area-light panel) plus a point, a spot, a
    distant, an infinite, a goniometric, a projection and a sphere light:
    (JAX scene tables, the port's)."""
    text = TS.sppm_scene_text(width=16, height=12, spp=1, photons=N)
    text = text.replace("WorldBegin\n", "WorldBegin\n" + LIGHTS, 1)
    path = tmp_path_factory.mktemp("lights") / "scene.pbrt"
    path.write_text(text)
    js = JD.prepare(j_parse(str(path)))
    return js.scene, convert.scene_tables(js.scene)


def _draws(seed, n=N):
    rng = np.random.default_rng(seed)
    return [rng.random(s).astype(np.float32) for s in ((n,), (n, 2), (n, 2))]


def test_light_power_pmf_matches_jax(lights_scene):
    sj, st = lights_scene
    kinds = set(st.light_kind.tolist())
    assert {TB.LIGHT_AREA_TRI, TB.LIGHT_AREA_SPH, TB.LIGHT_POINT,
            TB.LIGHT_SPOT, TB.LIGHT_DISTANT, TB.LIGHT_INFINITE,
            TB.LIGHT_GONIO, TB.LIGHT_PROJ} <= kinds
    np.testing.assert_allclose(TSP._light_power_pmf(st).numpy(),
                               np.asarray(JS._light_power_pmf(sj)),
                               rtol=1e-6)


def test_light_picks_bitwise(lights_scene):
    """searchsorted on the CDF of the JAX package's pmf: the same light
    on every lane (the CDF summed in jnp.cumsum's order)."""
    sj, _ = lights_scene
    pmf = JS._light_power_pmf(sj)
    u = _draws(1)[0]
    lj = np.clip(np.asarray(jnp.searchsorted(jnp.cumsum(pmf),
                                             jnp.asarray(u))),
                 0, pmf.shape[0] - 1)
    lt, sel = TSP.pick_lights(torch.tensor(np.asarray(pmf)), torch.tensor(u))
    np.testing.assert_array_equal(lt.numpy(), lj)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(pmf)[lj])
    assert len(np.unique(lj)) > 8  # every kind is drawn


def test_sample_le_matches_jax(lights_scene):
    """Photon origins, directions and weights of every light kind on
    4,096 lanes, within rtol 1e-5 (atol 1e-5 on the unit directions and
    the origins' components near 0)."""
    sj, st = lights_scene
    u_sel, u_pos, u_dir = _draws(2)
    L = st.light_kind.shape[0]
    lid = (u_sel * L).astype(np.int32)
    oj, dj, bj = (np.asarray(x) for x in jax.jit(
        lambda a, b, c: JS.sample_le(sj, a, b, c))(
            jnp.asarray(lid), jnp.asarray(u_pos), jnp.asarray(u_dir)))
    ot, dt, bt = (x.numpy() for x in TSP.sample_le(
        st, torch.tensor(lid), torch.tensor(u_pos), torch.tensor(u_dir)))
    np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bt, bj, rtol=1e-5, atol=0)


def test_dark_kinds_emit_no_photons(lights_scene):
    """Infinite, goniometric and projection lights give beta 0 in both
    packages (statmc_tpu/render/sppm.py:184); the others do not."""
    sj, st = lights_scene
    kind = st.light_kind.numpy()
    lid = np.repeat(np.arange(kind.shape[0], dtype=np.int32), 16)
    _, u_pos, u_dir = _draws(3, lid.shape[0])
    _, _, bj = JS.sample_le(sj, jnp.asarray(lid), jnp.asarray(u_pos),
                            jnp.asarray(u_dir))
    _, _, bt = TSP.sample_le(st, torch.tensor(lid), torch.tensor(u_pos),
                             torch.tensor(u_dir))
    dark = np.isin(kind[lid], [TB.LIGHT_INFINITE, TB.LIGHT_GONIO,
                               TB.LIGHT_PROJ])
    for b in (np.asarray(bj), bt.numpy()):
        assert (b[dark] == 0).all() and (b[~dark].sum(-1) > 0).all()


def test_spot_photons_carry_no_falloff(lights_scene):
    """The JAX package's sample_le applies the spot falloff only if its
    lights module has _spot_falloff, which it does not
    (statmc_tpu/render/sppm.py:110-111): every spot photon carries
    I / pdf_cone, also in the falloff band where pbrt's SpotLight weighs
    it down.  The port mirrors it."""
    assert not hasattr(JL, "_spot_falloff")
    sj, st = lights_scene
    spot = int(np.nonzero(st.light_kind.numpy() == TB.LIGHT_SPOT)[0][0])
    lid = np.full(N, spot, np.int32)
    _, u_pos, u_dir = _draws(4)
    _, dj, bj = JS.sample_le(sj, jnp.asarray(lid), jnp.asarray(u_pos),
                             jnp.asarray(u_dir))
    _, dt, bt = TSP.sample_le(st, torch.tensor(lid), torch.tensor(u_pos),
                              torch.tensor(u_dir))
    cos_total, cos_falloff = st.light_params[spot].tolist()
    flat = st.light_L[spot].numpy() * 2 * np.pi * (1 - cos_total)
    for d, b in ((np.asarray(dj), np.asarray(bj)), (dt.numpy(), bt.numpy())):
        np.testing.assert_allclose(b, np.broadcast_to(flat, b.shape),
                                   rtol=1e-5)
        cos = d @ st.light_aux[spot].numpy()
        band = cos < cos_falloff  # pbrt: falloff ((cos-ct)/(cf-ct))^4 < 1
        assert band.mean() > 0.3


@pytest.fixture(scope="module")
def visible_points(tmp_path_factory):
    """The port's camera pass on the 16x12 sppm staircase, and 4,096
    seeded photon vertices around its visible points."""
    path = tmp_path_factory.mktemp("vp") / "scene.pbrt"
    path.write_text(TS.sppm_scene_text(width=16, height=12, spp=1,
                                       photons=N, radius=0.3))
    js = JD.prepare(j_parse(str(path)))
    rt = TD.load(str(path), device="cpu")
    cam = rt.camera_pass(torch.tensor([0, 7], dtype=torch.int64))
    rng = np.random.default_rng(5)
    have = cam["have"].numpy()
    src = rng.choice(np.nonzero(have)[0], N)
    ph_p = (cam["vp_p"].numpy()[src]
            + rng.normal(0, 0.15, (N, 3))).astype(np.float32)
    ph_wi = rng.normal(0, 1, (N, 3))
    ph_wi = (ph_wi / np.linalg.norm(ph_wi, axis=-1, keepdims=True)
             ).astype(np.float32)
    ph_beta = rng.uniform(0, 0.01, (N, 3)).astype(np.float32)
    ph_on = rng.random(N) < 0.8
    radius = rng.uniform(0.05, 0.3, have.shape[0]).astype(np.float32)
    return js, rt, cam, (radius, ph_p, ph_wi, ph_beta, ph_on)


def _jax_dense(js, cam, radius, ph_p, ph_wi, ph_beta, ph_on):
    """The JAX package's dense deposit (statmc_tpu/render/sppm.py:349-386,
    a closure there), on the same inputs: (near [P, Nph], phi, m_count)."""
    vp_p, vp_wo, vp_mat, vp_uv, vp_ns, have = (
        jnp.asarray(cam[k].numpy()) for k in ("vp_p", "vp_wo", "vp_mat",
                                              "vp_uv", "vp_ns", "have"))
    P = vp_p.shape[0]

    def run(ph_p, ph_wi, ph_beta, ph_on, radius):
        vp_m = JB.gather_materials(js.scene, vp_mat, vp_uv, vp_p)
        vp_frame = JB.ShadingFrame.from_normal(jnp.where(
            jnp.any(vp_ns != 0, -1, keepdims=True), vp_ns,
            jnp.array([0.0, 0.0, 1.0])))
        r2 = radius * radius
        vp_frame_b = JB.ShadingFrame(t=vp_frame.t[:, None, :],
                                     b=vp_frame.b[:, None, :],
                                     n=vp_frame.n[:, None, :])
        vp_m_b = jax.tree.map(lambda x: x[:, None], vp_m)
        d2 = jnp.sum((vp_p[:, None, :] - ph_p[None, :, :]) ** 2, -1)
        near = (d2 <= r2[:, None]) & ph_on[None, :] & have[:, None]
        wi_l = vp_frame_b.to_local(
            jnp.broadcast_to(-ph_wi[None], (P, ph_p.shape[0], 3)))
        wo_l = vp_frame.to_local(vp_wo)
        f, _ = JB.evaluate(vp_m_b, wo_l[:, None, :], wi_l)
        contrib = jnp.where(near[..., None], f * ph_beta[None], 0.0)
        return near, jnp.sum(contrib, axis=1), jnp.sum(near, axis=1)

    return (np.asarray(x) for x in jax.jit(run)(
        jnp.asarray(ph_p), jnp.asarray(ph_wi), jnp.asarray(ph_beta),
        jnp.asarray(ph_on), jnp.asarray(radius)))


def _vp(rt, cam):
    return TSP.VisiblePoints(rt.s.scene, cam["vp_p"], cam["vp_wo"],
                             cam["vp_mat"], cam["vp_uv"], cam["vp_ns"],
                             cam["have"], rt.s.icfg.mat_types)


def test_grid_deposit_matches_jax_dense(visible_points):
    """The grid's pair set equals the JAX package's dense `near`; m_count
    equal, phi within rtol 1e-5; and the port's dense twin agrees too."""
    js, rt, cam, (radius, ph_p, ph_wi, ph_beta, ph_on) = visible_points
    near, phi_j, m_j = _jax_dense(js, cam, radius, ph_p, ph_wi, ph_beta,
                                  ph_on)
    args = [torch.tensor(x) for x in (ph_p, ph_wi, ph_beta, ph_on)]
    r2 = torch.tensor(radius) ** 2
    vi, jj, tested = TSP.grid_pairs(cam["vp_p"], cam["have"], r2, args[0],
                                    args[3])
    pairs = np.zeros_like(near)
    pairs[vi.numpy(), jj.numpy()] = True
    assert len(vi) == near.sum() > 1000 and tested > len(vi)
    np.testing.assert_array_equal(pairs, near)
    vp = _vp(rt, cam)
    phi, m = TSP.deposit_grid(vp, r2, *args)
    np.testing.assert_array_equal(m.numpy(), m_j.astype(np.float32))
    np.testing.assert_allclose(phi.numpy(), phi_j, rtol=1e-5, atol=1e-9)
    phi_d, m_d = TSP.deposit_dense(vp, r2, *args)
    np.testing.assert_array_equal(m_d.numpy(), m.numpy())
    np.testing.assert_allclose(phi_d.numpy(), phi.numpy(), rtol=1e-5,
                               atol=1e-9)


def test_grid_deposit_is_deterministic(visible_points, monkeypatch):
    """Two runs, and a run in chunks of 64 candidate pairs, give phi bit
    for bit: pairs are summed per visible point in photon order."""
    js, rt, cam, (radius, ph_p, ph_wi, ph_beta, ph_on) = visible_points
    args = [torch.tensor(x) for x in (ph_p, ph_wi, ph_beta, ph_on)]
    r2 = torch.tensor(radius) ** 2
    vp = _vp(rt, cam)
    a = TSP.deposit_grid(vp, r2, *args)
    b = TSP.deposit_grid(vp, r2, *args)
    monkeypatch.setattr(TSP, "PAIR_CHUNK", 64)
    monkeypatch.setattr(TSP, "EVAL_CHUNK", 100)
    c = TSP.deposit_grid(vp, r2, *args)
    for x, y in ((a, b), (a, c)):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


@pytest.fixture(scope="module")
def two_passes(tmp_path_factory):
    """The 16x12 sppm staircase (maxdepth 5, 4,096 photons a pass, radius
    0.3): the JAX package's state after pass 1 and after pass 2."""
    path = tmp_path_factory.mktemp("sppm") / "scene.pbrt"
    path.write_text(TS.sppm_scene_text(width=16, height=12, spp=1,
                                       photons=N, radius=0.3))
    rj = JD.load(str(path), base_seed=3)
    out = []
    for i in (1, 2):
        rj.run_iteration(i)
        out.append({k: np.asarray(getattr(rj, k)) for k in
                    ("radius", "n_acc", "tau", "Ld", "film_mean",
                     "ray_total")})
    return str(path), rj, out


def _hold(rt, ref):
    for k in ("radius", "n_acc", "tau", "Ld", "film_mean"):
        np.testing.assert_allclose(getattr(rt, k).numpy(), ref[k],
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert float(rt.ray_total) == float(ref["ray_total"])


def test_first_pass_matches_jax(two_passes):
    path, rj, ref = two_passes
    rt = TD.load(path, base_seed=3, device="cpu")
    assert isinstance(rt, TSP.SPPMRenderer) and rt.n_photons == N
    rt.run_iteration(1)
    _hold(rt, ref[0])
    assert (rt.radius.numpy() < 0.3).any()  # pass 1 shrank radii


def test_second_pass_from_jax_state(two_passes):
    """Pass 2 from the JAX package's state after its pass 1."""
    path, rj, ref = two_passes
    rt = TD.load(path, base_seed=3, device="cpu")
    rj1 = type("State", (), {k: ref[0][k] for k in ref[0]})
    rj1.n_iters, rj1.total_photons = 1, N
    convert.alt_renderer_state(rj1, rt)
    rt.run_iteration(2)
    assert rt.n_iters == rj.n_iters == 2
    assert rt.total_photons == rj.total_photons == 2 * N
    _hold(rt, ref[1])
    f = rt.buffers()["film"]
    assert np.isfinite(f).all() and f.mean() > 0


def test_cli_renders_sppm(tmp_path, capsys):
    """python -m statmc_tpu_torch --device cpu renders an sppm scene (two
    passes) and writes its film, equal to load(...).render()'s."""
    import statmc_tpu_torch.__main__ as TM
    from statmc_tpu_torch.io.pfm import read_pfm

    path = tmp_path / "s.pbrt"
    path.write_text(TS.sppm_scene_text(width=8, height=6, spp=1,
                                       photons=512, radius=0.3))
    out = tmp_path / "out"
    assert TM.main([str(path), "--writeimages", "--outdir", str(out),
                    "--device", "cpu"]) == 0
    assert "Iteration: 2" in capsys.readouterr().out
    r = TD.load(str(path), device="cpu")
    r.render(verbose=False)
    np.testing.assert_array_equal(
        read_pfm(str(out / "staircase-proxy-2-film.pfm")),
        r.buffers()["film"])
