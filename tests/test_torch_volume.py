"""The port's participating media (statmc_tpu_torch/render/volume.py and
the media tables of scene/build.py) against the JAX package's
(statmc_tpu/render/volume.py), function by function, on a few thousand
lanes through small jitted JAX calls; and the port's early exits, lane
gathering and key hoisting against the loops run to their caps over
every lane, masked, as the JAX package runs them.

The tables are built from one small volpath scene (a homogeneous haze,
an 8^3 grid smoke behind a null box, Fourier spheres) by both packages
and are equal.  Draws and keys are bit-equal; the tracking loops'
decisions (scatter, escape, killed) agree on >= 99.9% of lanes, and
their floats within rtol 1e-5 / atol 1e-6 on those lanes: XLA rounds
log1p, exp and the density's lerps its own way (measured below, in the
assertion messages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statmc_tpu.render import intersect as JX
from statmc_tpu.render import volume as JV
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch.core import rng as TR
from statmc_tpu_torch.render import volume as TV
from test_torch_volpath import volpath_staircase  # noqa: F401 (fixture)

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6
P = 4096
STEP = 3


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


@pytest.fixture(scope="module")
def scenes(volpath_staircase):
    """(JAX setup, port setup) of the small volpath staircase (8^3
    smoke), shared with tests/test_torch_volpath.py."""
    path, js = volpath_staircase
    return js, TD.load(path, device="cpu").s


def _rays(seed, scene_np, toward_box=True):
    """P rays in the room: origins anywhere in it, directions toward the
    smoke box's centre (jittered) or uniform; keys, media ids."""
    rng = np.random.default_rng(seed)
    o = (rng.random((P, 3)) * np.array([10, 6, 10])
         - np.array([5, 0, 6])).astype(np.float32)
    if toward_box:
        tgt = np.array([1.5, 1.5, -2.0]) + rng.normal(0, 1.2, (P, 3))
        d = tgt - o
    else:
        d = rng.normal(size=(P, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    keys = rng.integers(0, 2 ** 32, (P, 2), dtype=np.uint64)
    med = rng.integers(-1, 2, P).astype(np.int32)
    t_hit = np.where(rng.random(P) < 0.2, 1e8,
                     rng.random(P) * 12).astype(np.float32)
    return o, d, keys, med, t_hit


def _keys_j(keys):
    return jnp.asarray(keys.astype(np.uint32))


def _keys_t(keys):
    return torch.tensor(keys.astype(np.int64))


def _share(a, b):
    return float(np.mean(a == b))


def test_scene_tables_equal(scenes):
    """The media and Fourier tables, the shapes' media and the camera's
    medium are the JAX package's."""
    js, ts = scenes
    ct = convert.scene_tables(js.scene)
    for f in ("med_sigma_a", "med_sigma_s", "med_g", "med_kind", "med_w2m",
              "med_grid", "med_nxyz", "med_inv_maxd", "med_sigt0",
              "tri_med_in", "tri_med_out", "sph_med_in", "sph_med_out",
              "mat_fourier_id"):
        np.testing.assert_array_equal(_n(getattr(ts.scene, f)),
                                      _n(getattr(ct, f)), err_msg=f)
    assert ts.scene.cam_medium == ct.cam_medium == 0
    assert ts.icfg.volumetric and ts.icfg.has_grid_media
    assert js.icfg.volumetric and js.icfg.has_grid_media
    assert ts.icfg.null_extra == js.icfg.null_extra == 8
    for a, b in zip(ts.scene.fourier, ct.fourier):
        np.testing.assert_array_equal(_n(a), _n(b))


def test_phase_function():
    """hg_phase and sample_hg on 4,096 lanes, g from -0.9 to 0.9 (and
    0, the isotropic branch).  sample_hg's cos(theta) is 1 + g^2 - sq^2
    over 2g, which cancels, and its sin(theta) = sqrt(1 - cos^2) near
    the poles; the port fuses the products as XLA does here, but XLA
    fuses differently inside other programs, so sample_hg is held on
    >= 99.9% of lanes at rtol 1e-5 and on all within 1e-5 absolute
    (measured: 2 of 12,288 components off, by at most 4.7e-6)."""
    rng = np.random.default_rng(1)
    g = rng.uniform(-0.9, 0.9, P).astype(np.float32)
    g[::7] = 0.0
    c = rng.uniform(-1, 1, P).astype(np.float32)
    wo = rng.normal(size=(P, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u = rng.random((P, 2)).astype(np.float32)
    pj = jax.jit(JV.hg_phase)(g, c)
    np.testing.assert_allclose(_n(TV.hg_phase(_t(g), _t(c))), pj,
                               rtol=RTOL, atol=ATOL)
    wj = np.asarray(jax.jit(JV.sample_hg)(g, wo, u))
    wt = _n(TV.sample_hg(_t(g), _t(wo), _t(u)))
    close = np.isclose(wt, wj, rtol=RTOL, atol=ATOL).all(-1)
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-5)


def test_grid_density_and_cube_range(scenes):
    """_grid_density at points in and around [0,1]^3 (both media), and
    _unit_cube_range of rays against the unit cube."""
    js, ts = scenes
    rng = np.random.default_rng(2)
    p = rng.uniform(-0.2, 1.2, (P, 3)).astype(np.float32)
    midx = rng.integers(0, 2, P).astype(np.int32)
    dj = jax.jit(lambda m, x: JV._grid_density(js.scene, m, x))(midx, p)
    dt = TV._grid_density(ts.scene, _t(midx), _t(p))
    np.testing.assert_allclose(_n(dt), dj, rtol=RTOL, atol=ATOL)
    om = rng.uniform(-1, 2, (P, 3)).astype(np.float32)
    dm = rng.normal(size=(P, 3)).astype(np.float32)
    dm[::5, 1] = 0.0
    tm = rng.uniform(0, 3, P).astype(np.float32)
    rj = jax.jit(JV._unit_cube_range)(om, dm, tm)
    rt = TV._unit_cube_range(_t(om), _t(dm), _t(tm))
    for a, b in zip(rj, rt):
        np.testing.assert_allclose(_n(b), a, rtol=RTOL, atol=ATOL)


def test_tracking_keys_bit_equal():
    """_tr_key: the (step, slot, iteration) keys, and the hoisted form
    (the step's SLOT_TR keys folded once, then the iteration)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2 ** 32, (P, 2), dtype=np.uint64)
    for it in (0, 17, 255, 256 + 128 * 37):
        kj = jax.jit(lambda k: JV._tr_key(k, STEP, 11, it))(_keys_j(keys))
        kt = TV._tr_key(_keys_t(keys), STEP, TR.SLOT_TR, it)
        kh = TR.fold_in(TV._tr_site(_keys_t(keys), STEP), it)
        np.testing.assert_array_equal(_n(kt), np.asarray(kj).astype(np.int64))
        np.testing.assert_array_equal(_n(kh), _n(kt))


def _cfg_pair(js, ts):
    return js.icfg, ts.icfg


@pytest.mark.parametrize("toward_box", [True, False])
def test_sample_medium(scenes, toward_box):
    """sample_medium on every lane (homogeneous, grid and vacuum lanes):
    scatter decisions on >= 99.9% of lanes; t and the weight within
    tolerance where they agree."""
    js, ts = scenes
    o, d, keys, med, t_hit = _rays(4 + toward_box, None, toward_box)
    fj = jax.jit(lambda m, a, b, th, k: JV.sample_medium(
        js.scene, js.icfg, m, a, b, th, k, STEP))
    tj, sj, wj = fj(med, o, d, t_hit, _keys_j(keys))
    tt, st, wt = TV.sample_medium(ts.scene, ts.icfg, _t(med), _t(o), _t(d),
                                  _t(t_hit), _keys_t(keys), STEP)
    live = med >= 0
    same = (np.asarray(sj) == _n(st)) | ~live
    assert same.mean() >= 0.999, same.mean()
    ok = same & live
    grid = live & (med == 1)
    assert np.asarray(sj)[grid].any() and not np.asarray(sj)[grid].all()
    np.testing.assert_allclose(_n(tt)[ok], np.asarray(tj)[ok], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_n(wt)[ok], np.asarray(wj)[ok], rtol=RTOL,
                               atol=ATOL)


def test_segment_tr(scenes):
    """_segment_tr (ratio tracking on grid lanes, closed form on the
    haze, 1 in vacuum), at a segment's key base."""
    js, ts = scenes
    o, d, keys, med, seg = _rays(6, None)
    base = JV.GRID_SAMPLE_STEPS + JV._SEG_KEY_STRIDE * (16 * 2 + 3)
    fj = jax.jit(lambda m, a, b, s, k: JV._segment_tr(
        js.scene, js.icfg, m, a, b, s, k, STEP, base))
    rj = np.asarray(fj(med, o, d, seg, _keys_j(keys)))
    rt = _n(TV._segment_tr(ts.scene, ts.icfg, _t(med), _t(o), _t(d),
                           _t(seg), _keys_t(keys), STEP, base))
    close = np.isclose(rt, rj, rtol=RTOL, atol=ATOL).all(-1)
    assert close.mean() >= 0.999, close.mean()
    grid = med == 1
    assert (rj[grid, 0] == 0).any() and ((rj[grid, 0] > 0)
                                         & (rj[grid, 0] < 1)).any()


def test_crossing_medium_and_walk(scenes):
    """_crossing_medium at the camera rays' first hits, and
    transmittance_walk with K = 9 null crossings: tr, the first real hit
    (p, ng, light id) and `real` on >= 99.9% of lanes."""
    js, ts = scenes
    o, d, keys, med, t_max = _rays(7, None)
    t_max = np.where(np.arange(P) % 3 == 0, 1e30, t_max).astype(np.float32)
    t_max[::11] = 0.0
    hj = jax.jit(lambda a, b: JX.intersect_scene(
        js.scene, a, b, t_max=jnp.full((P,), 1e30), bvh=js.bvh))(o, d)
    cj = jax.jit(lambda h, b, m: JV._crossing_medium(js.scene, h, b, m))(
        hj, d, med)
    from statmc_tpu_torch.render.intersect import intersect_scene
    ht = intersect_scene(ts.scene, _t(o), _t(d), torch.full((P,), 1e30),
                         ts.bvh)
    ct = TV._crossing_medium(ts.scene, ht, _t(d), _t(med))
    assert _share(_n(ct), np.asarray(cj)) >= 0.999
    assert (np.asarray(cj) == 1).any()  # some rays enter the smoke box

    fj = jax.jit(lambda m, a, b, tm, k: JV.transmittance_walk(
        js.scene, js.bvh, js.icfg, m, a, b, tm, k, STEP, 3))
    trj, hitj, realj = fj(med, o, d, t_max, _keys_j(keys))
    trt, hitt, realt = TV.transmittance_walk(
        ts.scene, ts.bvh, ts.icfg, _t(med), _t(o), _t(d), _t(t_max),
        _keys_t(keys), STEP, 3)
    realj = np.asarray(realj)
    same = realj == _n(realt)
    assert same.mean() >= 0.999, same.mean()
    close = np.isclose(_n(trt), np.asarray(trj), rtol=RTOL,
                       atol=ATOL).all(-1) & same
    assert close.mean() >= 0.999, close.mean()
    r = same & realj
    np.testing.assert_array_equal(_n(hitt.light_id)[r],
                                  np.asarray(hitj.light_id)[r])
    np.testing.assert_allclose(_n(hitt.p)[r], np.asarray(hitj.p)[r],
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The early exits, lane gathering and key hoisting change no bit.


def _all_draws(keys, step, it_base, n):
    """[P, n, 2]: every lane's uniforms of tracking iterations it_base ..
    it_base + n - 1, each from its own (step, slot, iteration) key folded
    from the per-sample keys, as the JAX package folds them (no hoisting;
    test_tracking_keys_bit_equal holds the hoisted keys equal)."""
    its = torch.arange(it_base, it_base + n)
    k = TR.fold_in(TR.fold_in(TR.fold_in(keys, step)[:, None, :].expand(
        -1, n, -1), TR.SLOT_TR), its[None, :])
    return TR.uniform(k, (2,))


def _masked_delta(keys, step):
    """_delta_tracking as the JAX package runs it: every lane in the grid
    box, masked, to the loop's cap."""
    draws = _all_draws(keys, step, 0, TV.GRID_SAMPLE_STEPS)

    def run(scene, midx, om, dm, t0, t1, st0, imd, lanes, site):
        done = ~(t0 <= t1)
        t = t0.clone()
        scat = torch.zeros_like(done)
        for i in range(TV.GRID_SAMPLE_STEPS):
            uu = draws[:, i]
            t_new = t - TV._log1p(-uu[:, 0]) * imd / st0
            esc = t_new >= t1
            dens = TV._grid_density(scene, midx, om + dm * t_new[:, None])
            real = dens * imd > uu[:, 1]
            scat = scat | (~done & ~esc & real)
            t = torch.where(done, t, t_new)
            done = done | esc | real
        return t, scat
    return run


def _masked_ratio(keys, step):
    def run(scene, midx, om, dm, t0, t1, st0, imd, lanes, site, it_base):
        done = ~(t0 <= t1)
        tr = torch.ones_like(t0)
        t = t0.clone()
        draws = _all_draws(keys, step, it_base, TV.GRID_TR_STEPS)
        for i in range(TV.GRID_TR_STEPS):
            uu = draws[:, i]
            t_new = t - TV._log1p(-uu[:, 0]) * imd / st0
            esc = t_new >= t1
            dens = TV._grid_density(scene, midx, om + dm * t_new[:, None])
            tr_new = tr * (1.0 - torch.clamp(dens * imd, min=0.0))
            q = torch.clamp(1.0 - tr_new, min=0.05)
            rr = tr_new < 0.1
            killed = rr & (uu[:, 1] < q)
            tr_new = torch.where(killed, 0.0, torch.where(
                rr, tr_new / (1.0 - q), tr_new))
            tr = torch.where(~done & ~esc, tr_new, tr)
            t = torch.where(done, t, t_new)
            done = done | esc | killed
        return tr
    return run


def _camera_carry(ts, w, h):
    """Step-0 keys and carry of every pixel's sample 0."""
    from statmc_tpu_torch.render import camera as TC

    P_ = w * h
    ids = torch.arange(P_, dtype=torch.int32)
    keys = TR.pixel_keys(TR.base_key(0), ids, 0)
    u = TR.uniform_2d(keys, 0, TR.SLOT_CAMERA)
    pxy = torch.stack([(ids % w).float(), (ids // w).float()], -1)
    o, d = TC.generate_rays(ts.cam, pxy + u)
    return keys, TV._zero_carry(o, d, ts.scene.cam_medium)


def test_step_loops_to_caps_bit_identical(scenes, monkeypatch):
    """Step 0 of the small scene's camera paths, a third of them started
    in the smoke (its box is in view): the step as the renderer runs it (tracking loops on the gathered lanes until none is
    left, hoisted keys, walks stopping once no lane walks) against the
    same step with both tracking loops over all lanes to their caps,
    masked, keys folded per iteration, and every walk running its K = 9
    segments: every carry tensor equal bit for bit, with delta and ratio
    tracking having run on some lanes.  (The capped form runs 256 delta
    and 4 x 9 x 128 ratio-tracking iterations, its draws made up front.)"""
    js, ts = scenes
    keys, carry = _camera_carry(ts, 16, 12)
    carry["med"][::3] = 1
    stats = []
    monkeypatch.setattr(TV, "track_stats", stats)
    for step in range(1):
        real = TV._volpath_step(ts.scene, ts.bvh, ts.dist, ts.icfg, carry,
                                step, keys, ts.albedo_luts)
        with monkeypatch.context() as m:
            m.setattr(TV, "_delta_tracking", _masked_delta(keys, step))
            m.setattr(TV, "_ratio_tracking", _masked_ratio(keys, step))
            m.setattr(TV, "_live_lanes",
                      lambda mask: torch.arange(mask.shape[0]))
            m.setattr(TV, "_any_lane", lambda mask: True)
            capped = TV._volpath_step(ts.scene, ts.bvh, ts.dist, ts.icfg,
                                      carry, step, keys, ts.albedo_luts)
        assert real.keys() == capped.keys()
        for k in real:
            assert torch.equal(real[k], capped[k]), (step, k)
        carry = real
    kinds = {k for k, n, _ in stats if n > 0}
    assert {"delta", "ratio", "walk"} <= kinds, kinds


def test_step_gathering_bit_identical(scenes, monkeypatch):
    """trace_volpath with each step on the active lanes, gathered, and
    ending once none is active, against every step over every lane:
    every output equal bit for bit."""
    js, ts = scenes
    keys, carry = _camera_carry(ts, 16, 12)
    args = (ts.scene, ts.bvh, ts.dist, ts.icfg, carry["o"], carry["d"], keys,
            None, None, None, False, ts.albedo_luts)
    calls = []
    real_step = TV._volpath_step

    def counted(*a, **k):
        calls.append(a[4]["o"].shape[0])
        return real_step(*a, **k)

    monkeypatch.setattr(TV, "_volpath_step", counted)
    out = TV.trace_volpath(*args)
    gathered = list(calls)
    monkeypatch.setattr(TV, "_step_lanes",
                        lambda active: torch.arange(active.shape[0]))
    out_all = TV.trace_volpath(*args)
    assert min(gathered) < 16 * 12  # some steps ran on fewer lanes
    for a, b in zip(out, out_all):
        assert torch.equal(a, b)
