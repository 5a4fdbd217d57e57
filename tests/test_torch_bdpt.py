"""`Integrator "bdpt"` (statmc_tpu_torch/render/bdpt.py) against the JAX
package's render/bdpt.py.

One JAX BDPT render is shared by the file (the module fixture
`jax_render`): the 8x8 closed box, maxdepth 3, 1 spp, 1 iteration, run
op-by-op under jax.disable_jit (the jitted program takes twice as long
to compile as this takes to run), with its camera rays, subpaths, every
strategy's contribution and MIS weight, film and splat recorded.  The
port renders the same sample from the same keys and the JAX camera rays
(the port's `camera_rays` monkeypatched to return them):

* subpaths: vtype and light_id equal; p, beta, pdf_fwd, pdf_rev within
  rtol 1e-5 (atol 1e-6);
* each (s, t) strategy's contribution and MIS weight within rtol 1e-4
  (atol 1e-6) on every lane;
* film and splat within rtol 1e-4 (atol 1e-6) on >= 98.5% of pixels
  (measured 100%); from the port's own camera the share is reported,
  not held (ROADMAP.md section C: the camera's ulps).

The component tests call jitted JAX functions on 4,096 seeded lanes and
hold the port within rtol 1e-5 (atol 1e-5 on unit vectors and points),
integers and masks exactly.  The JAX package's invariants run on the port
alone: a constant environment renders 1 within 1e-3, and every strategy
is finite and >= 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.render import bdpt as JBD
from statmc_tpu.render import sppm as JS
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.render import bdpt as TBD
from statmc_tpu_torch.scene import build as TB

torch.set_num_threads(2)
N = 4096
SEED = 3

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
    'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [2 2 2]\n'
    'ReverseOrientation\nTranslate -2 3 1\n'
    'Shape "sphere" "float radius" [0.4]\nAttributeEnd\n'
)


def _env_scene(spp: int, size: int = 8) -> str:
    """tests/test_bdpt.py's _env_scene without its floor: every camera ray
    escapes into a constant L = 1 environment."""
    return (
        'Integrator "bdpt" "integer maxdepth" [4] '
        '"integer iterations" [1] "bool expiterations" ["false"]\n'
        f'Sampler "random" "integer pixelsamples" [{spp}]\n'
        f'Film "image" "integer xresolution" [{size}] '
        f'"integer yresolution" [{size}]\n'
        "LookAt 0 0.5 -3  0 0 0  0 1 0\n"
        'Camera "perspective" "float fov" [60]\n'
        "WorldBegin\n"
        'LightSource "infinite" "rgb L" [1 1 1]\n' + "WorldEnd\n"
    )


@pytest.fixture(scope="module")
def lights_pair(tmp_path_factory):
    """The 8x8 bdpt box plus a point, a spot, a distant, an infinite, a
    goniometric, a projection and two sphere lights (one reversed): (the
    JAX renderer, the port's)."""
    text = TS.box_scene_text("bdpt", 1, maxdepth=3, size=8)
    text = text.replace("WorldBegin\n", "WorldBegin\n" + LIGHTS, 1)
    path = tmp_path_factory.mktemp("lights") / "scene.pbrt"
    path.write_text(text)
    return (JD.load(str(path)), TD.load(str(path), device="cpu"))


def _u(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(t, j, rtol=1e-5, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def test_emit_sample_matches_jax(lights_pair):
    """BDPT's own Sample_Le over every light kind on 4,096 lanes: o, d,
    Le, ng and the densities within rtol 1e-5, delta_pos equal; the spot
    lanes carry pbrt's falloff (render/sppm.py's sample_le does not), and
    infinite lights emit nothing."""
    jr, tr = lights_pair
    sj, st = jr.s.scene, tr.s.scene
    kind = st.light_kind.numpy()
    lid = (_u(1, N) * kind.shape[0]).astype(np.int32)
    u_pos, u_dir = _u(2, N, 2), _u(3, N, 2)
    outj = jax.jit(lambda a, b, c: JBD._emit_sample(sj, a, b, c))(
        jnp.asarray(lid), jnp.asarray(u_pos), jnp.asarray(u_dir))
    outt = TBD._emit_sample(st, torch.tensor(lid), torch.tensor(u_pos),
                            torch.tensor(u_dir))
    for name, a, b in zip(("o", "d", "Le", "ng", "pdf_pos", "pdf_dir"),
                          outt[:6], outj[:6]):
        _close(a, b, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(outt[6].numpy(), np.asarray(outj[6]))
    Le = outt[2].numpy()
    assert set(kind[lid]) >= {TB.LIGHT_POINT, TB.LIGHT_SPOT,
                              TB.LIGHT_DISTANT, TB.LIGHT_INFINITE,
                              TB.LIGHT_GONIO, TB.LIGHT_PROJ,
                              TB.LIGHT_AREA_TRI, TB.LIGHT_AREA_SPH}
    assert (Le[kind[lid] == TB.LIGHT_INFINITE] == 0).all()
    spot = kind[lid] == TB.LIGHT_SPOT
    full = st.light_L[int(np.nonzero(kind == TB.LIGHT_SPOT)[0][0])].numpy()
    dimmed = (Le[spot] < full * (1 - 1e-4)).all(-1)
    assert 0.1 < dimmed.mean() < 1.0  # the falloff band


def test_light_densities_match_jax(lights_pair):
    """_pdf_le_dir, _infinite_light_density, _pdf_light_origin and
    _convert_density on 4,096 lanes, within rtol 1e-5."""
    jr, tr = lights_pair
    sj, st = jr.s.scene, tr.s.scene
    L = st.light_kind.shape[0]
    lid = (_u(4, N) * L).astype(np.int32)
    w = _u(5, N, 3) * 2 - 1
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    ng = _u(6, N, 3) * 2 - 1
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    pmf_j = JS._light_power_pmf(sj)
    pmf_t = tr._pmf_all
    _close(pmf_t, pmf_j, rtol=1e-6)
    tl, tw, tn = (torch.tensor(x) for x in (lid, w, ng))
    jl, jw, jn = (jnp.asarray(x) for x in (lid, w, ng))
    _close(TBD._pdf_le_dir(st, tl, tn, tw),
           jax.jit(lambda a, b, c: JBD._pdf_le_dir(sj, a, b, c))(jl, jn, jw))
    _close(TBD._infinite_light_density(st, pmf_t, tw),
           jax.jit(lambda a: JBD._infinite_light_density(sj, pmf_j, a))(jw))
    _close(TBD._pdf_light_origin(st, pmf_t, tl),
           jax.jit(lambda a: JBD._pdf_light_origin(sj, pmf_j, a))(jl))
    pd = _u(7, N) * 3
    p0, p1 = _u(8, N, 3) * 4, _u(9, N, 3) * 4
    on = _u(10, N) < 0.5
    _close(TBD._convert_density(*(torch.tensor(x) for x in
                                  (pd, p0, p1, ng, on))),
           jax.jit(JBD._convert_density)(pd, p0, p1, ng, on))
    assert TBD._scene_has_infinite(st) and JBD._scene_has_infinite(sj)


def test_camera_importance_matches_jax(lights_pair):
    """The pinhole's Pdf_We and Sample_Wi on 4,096 lanes: raster index
    and `inside` equal, the rest within rtol 1e-5."""
    jr, tr = lights_pair
    p_ref = _u(11, N, 3) * np.array([4, 2, 4], np.float32) \
        - np.array([2, 0, 2], np.float32)
    w = _u(12, N, 3) * 2 - 1
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    _, pj = jax.jit(jr._pdf_we)(jnp.asarray(p_ref), jnp.asarray(w))
    _, pt = tr._pdf_we(torch.tensor(p_ref), torch.tensor(w))
    _close(pt, pj)
    assert abs(tr._film_area() - jr._film_area()) == 0
    outj = jax.jit(jr._sample_wi_camera)(jnp.asarray(p_ref))
    outt = tr._sample_wi_camera(torch.tensor(p_ref))
    inside = outt[4].numpy()
    np.testing.assert_array_equal(inside, np.asarray(outj[4]))
    assert 0.2 < inside.mean() < 1.0
    np.testing.assert_array_equal(outt[3].numpy()[inside],
                                  np.asarray(outj[3])[inside])
    for k in (0, 1, 2, 5):
        _close(outt[k], outj[k], atol=1e-5, err_msg=str(k))


@pytest.fixture(scope="module")
def jax_render(tmp_path_factory):
    """The JAX package's BDPT render of the 8x8 box (maxdepth 3, 1 spp,
    1 iteration), op-by-op, with what its sample made recorded."""
    path = tmp_path_factory.mktemp("box") / "box.pbrt"
    path.write_text(TS.box_scene_text("bdpt", 1, maxdepth=3, size=8))
    jr = JD.load(str(path), base_seed=SEED)
    rec = {"connect": {}, "t1": {}}
    cam_walk, light_walk = jr._camera_walk, jr._light_walk
    connect, connect_t1 = jr._connect, jr._connect_t1

    def rec_cam(keys, o0, d0, V):
        rec["keys"], rec["o0"], rec["d0"] = (np.asarray(keys.keys),
                                             np.asarray(o0), np.asarray(d0))
        rec["pt"] = cam_walk(keys, o0, d0, V)
        return rec["pt"]

    def rec_light(keys, V, n_lanes=None):
        rec["qs"] = light_walk(keys, V, n_lanes)
        return rec["qs"]

    def rec_connect(qs, pt, s_n, t_n, *a):
        out = connect(qs, pt, s_n, t_n, *a)
        rec["connect"][(s_n, t_n)] = tuple(np.asarray(x) for x in out)
        return out

    def rec_t1(qs, s_n, *a):
        out = connect_t1(qs, s_n, *a)
        rec["t1"][s_n] = tuple(np.asarray(x) for x in out)
        return out

    jr._camera_walk, jr._light_walk = rec_cam, rec_light
    jr._connect, jr._connect_t1 = rec_connect, rec_t1
    with jax.disable_jit():
        jr.render(iterations=1, verbose=False)
    rec["film_sum"] = np.asarray(jr.film_sum)
    rec["splat_sum"] = np.asarray(jr.splat_sum)
    rec["film_mean"] = np.asarray(jr.film_mean)
    rec["n_samples"] = jr.n_samples
    rec["ray_total"] = float(jr.ray_total)
    return str(path), jr, rec


def _port_render(path, rec=None, monkeypatch=None):
    """The port's render of the box; with rec, from the JAX camera rays,
    recording its subpaths and strategies."""
    tr = TD.load(path, base_seed=SEED, device="cpu")
    out = {"connect": {}, "t1": {}}
    if rec is not None:
        monkeypatch.setattr(TBD, "camera_rays", lambda cam, p: (
            torch.tensor(rec["o0"]), torch.tensor(rec["d0"])))
    cam_walk, light_walk, connect = tr._camera_walk, tr._light_walk, tr.connect

    def rec_cam(keys, o0, d0, V):
        out["keys"] = keys.keys.numpy()
        out["pt"] = cam_walk(keys, o0, d0, V)
        return out["pt"]

    def rec_light(keys, V, n_lanes=None):
        out["qs"] = light_walk(keys, V, n_lanes)
        return out["qs"]

    def rec_connect(qs, pt, keys, sts):
        o = connect(qs, pt, keys, sts)
        for (s_n, t_n), x in zip(sts, o):
            if t_n == 1:
                out["t1"][s_n] = x
            else:
                out["connect"][(s_n, t_n)] = x
        return o

    tr._camera_walk, tr._light_walk = rec_cam, rec_light
    tr.connect = rec_connect
    tr.render(iterations=1, verbose=False)
    return tr, out


@pytest.fixture(scope="module")
def port_from_jax_camera(jax_render):
    path, jr, rec = jax_render
    mp = pytest.MonkeyPatch()
    try:
        return _port_render(path, rec, mp)
    finally:
        mp.undo()


def test_subpaths_match_jax(jax_render, port_from_jax_camera):
    """Both subpaths from the same keys and camera rays: vtype, light_id,
    mat_id, delta and the endpoint flags equal; p, beta, pdf_fwd and
    pdf_rev within rtol 1e-5 (atol 1e-6)."""
    _, _, rec = jax_render
    tr, out = port_from_jax_camera
    np.testing.assert_array_equal(out["keys"],
                                  rec["keys"].astype(np.int64))
    for which in ("pt", "qs"):
        pj, pt = rec[which], out[which]
        for k in ("vtype", "light_id", "mat_id", "delta", "light_delta",
                  "infinite"):
            np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                          np.asarray(getattr(pj, k)),
                                          err_msg=f"{which}.{k}")
        for k in ("p", "ng", "ns", "beta", "pdf_fwd", "pdf_rev", "wo", "uv"):
            _close(getattr(pt, k), getattr(pj, k), err_msg=f"{which}.{k}")
    vt = out["pt"].vtype.numpy()
    assert (vt[:, 3] == TBD.VT_SURFACE).mean() > 0.5  # deep camera paths
    assert (out["qs"].vtype.numpy()[:, 2] == TBD.VT_SURFACE).mean() > 0.5


def test_strategies_match_jax(jax_render, port_from_jax_camera):
    """Each (s, t) strategy's contribution and MIS weight, and each t = 1
    strategy's splat pixel, on every lane: within rtol 1e-4 (atol 1e-6),
    pixels equal where the strategy is valid."""
    _, _, rec = jax_render
    tr, out = port_from_jax_camera
    assert set(out["connect"]) == set(rec["connect"]) == set(tr.strategies())
    live = 0
    for st, (cj, wj) in rec["connect"].items():
        ct, wt = out["connect"][st]
        _close(ct, cj, rtol=1e-4, err_msg=f"c {st}")
        _close(wt, wj, rtol=1e-4, err_msg=f"w {st}")
        live += int((wj > 0).sum())
    assert live > 64
    assert set(out["t1"]) == set(rec["t1"]) == {2, 3, 4}
    for s_n, (cj, ij, wj) in rec["t1"].items():
        ct, it, wt, valid = out["t1"][s_n]
        v = valid.numpy()
        np.testing.assert_array_equal(v, wj > 0)
        np.testing.assert_array_equal(it.numpy()[v], ij[v])
        _close(ct, cj, rtol=1e-4, err_msg=f"t1 c {s_n}")
        _close(wt, wj, rtol=1e-4, err_msg=f"t1 w {s_n}")


def _share(a, b):
    return float(np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1).mean())


def test_film_and_splat_match_jax(jax_render, port_from_jax_camera):
    """Film and splat from the JAX camera rays within rtol 1e-4 on >=
    98.5% of pixels; the ray total equal."""
    _, _, rec = jax_render
    tr, _ = port_from_jax_camera
    assert tr.n_samples == rec["n_samples"] == 1
    assert float(tr.ray_total) == rec["ray_total"]
    assert rec["splat_sum"].sum() > 0 and rec["film_sum"].sum() > 0
    for k in ("film_sum", "splat_sum", "film_mean"):
        share = _share(getattr(tr, k).numpy(), rec[k])
        assert share >= 0.985, (k, share)


def test_film_from_own_camera(jax_render, capsys):
    """The port's own camera rays: ulps of a ray can send a path elsewhere
    (ROADMAP.md section C), so the share is reported; the film is finite
    and its mean within 5% of the JAX package's."""
    path, _, rec = jax_render
    tr, _ = _port_render(path)
    f = tr.film_mean.numpy()
    assert np.isfinite(f).all()
    assert abs(f.mean() - rec["film_mean"].mean()) \
        <= 0.05 * rec["film_mean"].mean()
    with capsys.disabled():
        print(f"\nbdpt 8x8 box, port's camera: "
              f"{_share(f, rec['film_mean']):.4f} of pixels within rtol 1e-4")


def test_state_carries_across(jax_render):
    """convert.alt_renderer_state moves the JAX renderer's film_sum,
    splat_sum and n_samples into the port unchanged; iteration 2 then adds
    the port's own sample to them."""
    path, jr, rec = jax_render
    tr = TD.load(path, base_seed=SEED, device="cpu")
    convert.alt_renderer_state(jr, tr)
    np.testing.assert_array_equal(tr.film_sum.numpy(), rec["film_sum"])
    np.testing.assert_array_equal(tr.splat_sum.numpy(), rec["splat_sum"])
    assert tr.n_samples == 1
    twin = TD.load(path, base_seed=SEED, device="cpu")
    tr.run_iteration(2)
    assert tr.n_samples == 2
    key = TBD.crng.fold_in(TBD.crng.base_key(SEED), 2)
    f2, s2 = twin.one_sample(key, 2)
    assert torch.equal(tr.film_sum, torch.tensor(rec["film_sum"]) + f2)
    assert torch.equal(tr.splat_sum, torch.tensor(rec["splat_sum"]) + s2)


def test_constant_environment_renders_one(tmp_path):
    """tests/test_bdpt.py::test_bdpt_infinite_light_direct on the port:
    every camera ray escapes into L = 1, and the (0, 2) strategy alone
    gives 1 within 1e-3 (weight 1)."""
    path = tmp_path / "env.pbrt"
    path.write_text(_env_scene(4))
    r = TD.load(str(path), device="cpu")
    r.render(verbose=False)
    f = r.buffers()["film"]
    assert np.isfinite(f).all()
    np.testing.assert_allclose(f, 1.0, atol=1e-3)


def test_every_strategy_finite_and_nonnegative(tmp_path):
    """tests/test_bdpt.py::test_bdpt_strategies_all_finite on the port
    (the 8x8 box, maxdepth 5): each (s, t) strategy's weighted
    contribution, and the film, finite and >= 0."""
    path = tmp_path / "box.pbrt"
    path.write_text(TS.box_scene_text("bdpt", 2, maxdepth=5, size=8))
    r = TD.load(str(path), device="cpu")
    seen = {}
    connect = r.connect

    def check(qs, pt, keys, sts):
        outs = connect(qs, pt, keys, sts)
        for st, o in zip(sts, outs):
            w = o[2] if st[1] == 1 else o[1]
            seen[st] = (o[0] * w[:, None]).numpy()
        return outs

    r.connect = check
    r.render(verbose=False)
    assert len(seen) == len(r.strategies()) + 5
    for st, v in seen.items():
        assert np.isfinite(v).all() and (v >= 0).all(), st
    f = r.buffers()["film"]
    assert np.isfinite(f).all() and (f >= 0).all() and f.mean() > 0


def test_serial_scatter_add_is_a_serial_scatter():
    """serial_scatter_add equals a serial scatter-add of its lanes in lane
    order, bit for bit, with up to 40 lanes an index."""
    rng = np.random.default_rng(13)
    idx = rng.integers(0, 50, 2000)
    val = rng.standard_normal((2000, 3)).astype(np.float32)
    out = np.zeros((50, 3), np.float32)
    for i, v in zip(idx, val):
        out[i] = out[i] + v
    got = TBD.serial_scatter_add(torch.zeros((50, 3)), torch.tensor(idx),
                                 torch.tensor(val))
    np.testing.assert_array_equal(got.numpy(), out)
    ref = np.asarray(jnp.zeros((50, 3)).at[jnp.asarray(idx)].add(
        jnp.asarray(val)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cli_renders_bdpt(tmp_path, capsys):
    """python -m statmc_tpu_torch --device cpu renders a bdpt scene, writes
    its film (equal to load(...).render()'s) and prints the ray total."""
    import statmc_tpu_torch.__main__ as TMAIN
    from statmc_tpu_torch.io.pfm import read_pfm

    path = tmp_path / "s.pbrt"
    path.write_text(TS.bdpt_scene_text(width=8, height=6, spp=1,
                                       maxdepth=3, iterations=2))
    out = tmp_path / "out"
    assert TMAIN.main([str(path), "--writeimages", "--outdir", str(out),
                       "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "Iteration: 2" in text and "Rays traced" in text
    r = TD.load(str(path), device="cpu")
    r.render(verbose=False)
    np.testing.assert_array_equal(
        read_pfm(str(out / "staircase-proxy-2-film.pfm")),
        r.buffers()["film"])


@pytest.mark.parametrize("camera", ["orthographic", "realistic"])
def test_pinhole_importance_mirrored(camera, tmp_path):
    """Under bdpt the JAX package computes the perspective pinhole's
    importance whatever the camera, and the port does too (ROADMAP.md
    section C): for an orthographic camera the screen window lies on the
    z = 0 camera plane, so the film area is inf and We and Pdf_We are 0
    (t = 1 never splats); for a realistic camera raster_to_camera is the
    identity, the area NaN, and We NaN where a point projects (no t = 1
    splat passes `we > 0`).  The JAX package's realistic camera rays come
    from the pupil rectangle's centre, as the port's camera_rays.  The
    port's film stays finite."""
    import os

    from statmc_tpu.render import camera as JC

    lens = os.path.join(os.path.dirname(__file__), "fixtures",
                        "biconvex.dat")
    cam = ('Camera "orthographic"' if camera == "orthographic" else
           f'Camera "realistic" "string lensfile" ["{lens}"] '
           '"float focusdistance" [2] "float aperturediameter" [4]')
    path = tmp_path / "cam.pbrt"
    path.write_text(TS.box_scene_text("bdpt", 1, maxdepth=2, size=8).replace(
        'Camera "perspective" "float fov" [70]', cam))
    jr = JD.load(str(path))
    tr = TD.load(str(path), device="cpu")
    area = tr._film_area()
    assert (np.isinf(area) if camera == "orthographic" else np.isnan(area))
    np.testing.assert_array_equal(area, jr._film_area())
    p = _u(14, 256, 3) * 2 - np.array([1, 0, -0.5], np.float32)
    w = p / np.linalg.norm(p, axis=-1, keepdims=True)
    outj = jax.jit(jr._sample_wi_camera)(jnp.asarray(p))
    outt = tr._sample_wi_camera(torch.tensor(p))
    np.testing.assert_array_equal(outt[4].numpy(), np.asarray(outj[4]))
    np.testing.assert_array_equal(outt[2].numpy(), np.asarray(outj[2]))
    we = outt[2].numpy()[outt[4].numpy()]
    assert we.size and ((we == 0).all() if camera == "orthographic"
                        else np.isnan(we).all())
    np.testing.assert_array_equal(
        tr._pdf_we(torch.tensor(p), torch.tensor(w))[1].numpy(),
        np.asarray(jax.jit(jr._pdf_we)(jnp.asarray(p), jnp.asarray(w))[1]))
    film = _u(15, 256, 2) * 8
    oj, dj = jax.jit(lambda x: JC.generate_rays(jr.s.cam, x))(film)
    ot, dt = TBD.camera_rays(tr.s.cam, torch.tensor(film))
    _close(ot, oj, atol=1e-5)
    _close(dt, dj, atol=1e-5)
    tr.render(verbose=False)
    f = tr.film_mean.numpy()
    assert np.isfinite(f).all() and f.mean() > 0


def test_glass_caustic_reaches_the_floor(tmp_path):
    """tests/test_bdpt.py's glass caustic (a small bright light above a
    glass sphere over a diffuse floor) on the port: NEE cannot see the
    light through the glass, but light paths through it do, and their
    t = 1 splats land on the floor (finite, >= 0)."""
    path = tmp_path / "caustic.pbrt"
    path.write_text(TS.glass_caustic_scene_text("bdpt", 1, size=8))
    r = TD.load(str(path), device="cpu")
    r.render(verbose=False)
    splat = r.splat_sum.numpy()
    assert np.isfinite(splat).all() and (splat >= 0).all()
    assert (splat.sum(-1) > 0).mean() > 0.1
    f = r.buffers()["film"]
    assert np.isfinite(f).all() and f.mean() > 0


def test_debug_hooks(tmp_path):
    """strategy_filter splits a sample between strategy subsets whose
    films and splats sum to the whole (rtol 1e-5); debug_no_mis sets
    every valid weight to 1, so the (0, 2) strategy alone gives the
    light's L = 12 where the camera sees the light, and 0 elsewhere."""
    path = tmp_path / "box.pbrt"
    path.write_text(TS.box_scene_text("bdpt", 1, maxdepth=3, size=16))
    r = TD.load(str(path), device="cpu")
    key = TBD.crng.fold_in(TBD.crng.base_key(0), 1)
    film, splat = r.one_sample(key, 0)
    sts = r.strategies() + [(s_n, 1) for s_n in range(2, 5)]
    parts = []
    for half in (sts[0::2], sts[1::2]):
        r.strategy_filter = set(half)
        parts.append(r.one_sample(key, 0))
    _close(parts[0][0] + parts[1][0], film.numpy(), atol=1e-6)
    _close(parts[0][1] + parts[1][1], splat.numpy(), atol=1e-6)
    r.strategy_filter, r.debug_no_mis = {(0, 2)}, True
    f02, s02 = r.one_sample(key, 0)
    lum = f02.numpy()[:, 0]
    assert set(np.unique(lum)) <= {0.0, 12.0} and (lum == 12.0).any()
    assert not s02.any()
