"""Hair and subsurface scattering end to end: load(...).render() of the
hair + SSS staircase (fused path) in both packages, at a small size: 128
hair curves instead of the full-width 768
(tests/test_torch_hair_sss_twolevel.py holds the hair + SSS terrain on
the two-level path).

Ray totals (the probe chain's, exit shadow and exit BSDF-MIS rays
included) and sample counts are equal; every other buffer agrees within
rtol 1e-4 on a share of the pixels.  The hair and SSS functions are held
lane by lane in tests/test_torch_hair.py and tests/test_torch_sss.py;
end to end, ulps grow along paths, and a hair ribbon 0.01-0.03 wide,
across which the Marschner offset h runs from -1 to 1, turns a ray's
drift into a change of h 67-200 times larger, so the hair scenes agree
on fewer pixels than the untextured proxy.  Measured
worst shares (all buffers): the staircase 95.31% from the port's camera,
96.35% from the JAX camera (its m3; every other buffer >= 98.4%); the
terrain 98.44% and 98.96%.  The staircase from the JAX camera falls short
of the 98.5% that the other scenes meet, and so does the JAX package
against itself: compiled at -O0 it agrees with its default build on
90.89% of this scene's pixels, and the port's shortfall lies on the
pixels whose paths touch hair or a subsurface material; on the others it
meets 98.5% (tests/test_torch_hair_sss_witness.py).  ROADMAP.md section
C records this.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.render import camera as JC
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.render import camera as TC
from statmc_tpu_torch.render import hair as TH
from statmc_tpu_torch.render import sss as TSS

torch.set_num_threads(2)
CURVES = 128


def _t(x):
    return torch.tensor(np.asarray(x))


def _render_jax(path):
    rj = JD.load(str(path))
    totals = [x["rays_total"] for x in rj.render(verbose=False)]
    return rj.s, (totals, {k: np.asarray(v) for k, v in rj.buffers().items()})


@pytest.fixture(scope="module")
def staircase(tmp_path_factory):
    """The hair + SSS staircase at 24x16, 2 spp, 2 iterations, maxdepth
    3, denoised: (path, JAX setup, JAX render)."""
    path = tmp_path_factory.mktemp("stair") / "scene.pbrt"
    path.write_text(TS.hair_sss_scene_text(
        width=24, height=16, spp=2, iterations=2, maxdepth=3,
        filterradius=2, curves=CURVES))
    return (str(path), *_render_jax(path))


def hold_to_jax(jax_render, rt, share):
    """rt.render() against the JAX package's: equal ray totals per
    iteration and sample counts, every other buffer within rtol 1e-4 on
    >= share of its pixels, the film finite with mean > 0."""
    totals, bj = jax_render
    assert [x["rays_total"] for x in rt.render(verbose=False)] == totals
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


def jax_camera(monkeypatch, js):
    """Replace the port's camera by the JAX package's compiled
    generate_rays on the same film points."""
    gen_j = jax.jit(lambda p: JC.generate_rays(js.cam, p))

    def generate_rays(cam, p_film):
        return tuple(_t(x) for x in gen_j(jnp.asarray(p_film.numpy())))

    monkeypatch.setattr(TC, "generate_rays", generate_rays)


def test_staircase_end_to_end(staircase):
    """From the port's own camera: >= 95% of pixels (measured 95.31%)."""
    path, js, jax_render = staircase
    rt = TD.load(path, device="cpu")
    assert rt.s.icfg.enable_sss and rt.s.scene.has_hair
    assert rt.s.bvh.n_tris == js.bvh.n_tris <= 16384
    hold_to_jax(jax_render, rt, 0.95)


def test_staircase_end_to_end_jax_camera(staircase, monkeypatch):
    """From the JAX package's camera rays: >= 96% (measured 96.35%, its
    m3; module docstring)."""
    path, js, jax_render = staircase
    jax_camera(monkeypatch, js)
    hold_to_jax(jax_render, TD.load(path, device="cpu"), 0.96)


def test_plain_render_runs_no_hair_or_sss_code(tmp_path, monkeypatch):
    """A scene without hair or subsurface materials never enters the
    Marschner model, Sample_Sp or the exit-vertex NEE."""
    def refuse(*a, **k):
        raise AssertionError("hair or SSS code ran on a plain scene")

    for mod, names in ((TH, ("eval_f_pdf", "eval_f", "pdf", "sample_wi")),
                       (TSS, ("sample_sp", "estimate_direct_sw"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    path = tmp_path / "scene.pbrt"
    path.write_text(TS.scene_text(width=8, height=6, spp=1, iterations=1,
                                  maxdepth=3, denoise=False))
    r = TD.load(str(path), device="cpu")
    assert not (r.s.scene.has_hair or r.s.scene.has_sss or
                r.s.icfg.enable_sss)
    r.render(verbose=False)
    assert np.isfinite(r.film_mean.numpy()).all()


def _all_lanes(fire):
    """The SSS block over every lane, the lanes that do not fire masked,
    as the JAX package runs it: integrator._firing_lanes' take and put
    as identities."""
    return (lambda x: x), (lambda x, fill: x)


def hold_gathered_to_masked(path, monkeypatch):
    """load(path).render() with the SSS block on the gathered firing
    lanes (the renderer's form) against the same render with it over
    every lane (_all_lanes): the ray total and every buffer bit for
    bit, the block having fired on some lanes."""
    from statmc_tpu_torch.render import integrator as TI

    gather, fired = TI._firing_lanes, []

    def firing_lanes(fire):
        fired.append(int(fire.sum()))
        return gather(fire)

    out = []
    for firing in (firing_lanes, _all_lanes):
        monkeypatch.setattr(TI, "_firing_lanes", firing)
        r = TD.load(path, device="cpu")
        out.append((r.render(verbose=False)[-1]["rays_total"], r.buffers()))
    (rays, bufs), (rays_m, bufs_m) = out
    assert sum(fired) > 0
    assert rays == rays_m
    assert bufs.keys() == bufs_m.keys()
    for k, v in bufs_m.items():
        np.testing.assert_array_equal(bufs[k], v, err_msg=k)


def test_sss_compaction_bit_identical(tmp_path, monkeypatch):
    """The SSS block on the gathered firing lanes gives every buffer and
    the ray total bit for bit as the block over all lanes does, on the
    fused path (tests/test_torch_hair_sss_twolevel.py holds the
    two-level path)."""
    path = tmp_path / "scene.pbrt"
    path.write_text(TS.hair_sss_scene_text(
        width=16, height=12, spp=2, iterations=1, maxdepth=3,
        filterradius=2, curves=32))
    hold_gathered_to_masked(str(path), monkeypatch)
