"""The small volpath staircase with its smoke box standing on the floor
(testscenes.volpath_scene_text(box_lift=0)).  The box's null bottom face
and the floor then lie in one plane, y = 0, so which of the two a ray
meets first turns on the last ulp of its origin.  A transmittance walk
starts each segment at the hit point of the last, and the JAX package's
compiled code contracts that hit point, o + t d, into an FMA; the port
rounds it the same way in scenes with media
(render/intersect.py:_assemble_hit).

Measured here: of 4,096 walks down through the box, none differs from
the JAX package's with the FMA, and 31 hit the other face (tr off on
0.56% of lanes) with the plain sum.  End to end, 98.96% of pixels agree
within rtol 1e-4 on every buffer, from either camera.  The other test
files and chip_smoke.py keep the box 0.05 off the floor, where no tie
arises: the card and the CPU, whose float32 transcendentals differ by an
ulp on a few lanes, disagree at the tie too (ROADMAP.md section C gives
the shares).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import statmc_tpu.driver as JD
from statmc_tpu.render import volume as JV
from statmc_tpu.scene.api import parse_scene as j_parse
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.render import intersect as TX
from statmc_tpu_torch.render import volume as TV
from test_torch_hair_sss import jax_camera
from test_torch_volpath import hold_to_jax

torch.set_num_threads(2)
P = 4096
STEP = 3


@pytest.fixture(scope="module")
def floor_staircase(tmp_path_factory):
    """(path, JAX setup, JAX render) of the volpath staircase at 16x12,
    1 spp, maxdepth 4, an 8^3 smoke in a null box on the floor."""
    d = tmp_path_factory.mktemp("floor")
    path = d / "scene.pbrt"
    path.write_text(TS.volpath_scene_text(
        str(d), width=16, height=12, spp=1, iterations=1, maxdepth=4,
        grid=8, filterradius=2, box_lift=0.0))
    js = JD.prepare(j_parse(str(path)))
    rj = JD.Renderer(js)
    totals = [x["rays_total"] for x in rj.render(verbose=False)]
    return str(path), js, (totals, {k: np.asarray(v)
                                    for k, v in rj.buffers().items()})


def _walks_down_through_the_box(seed):
    """Walks from the haze above the box, down through its null top and
    bottom faces to the floor beneath it."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(0.3, 2.7, P), rng.uniform(3.2, 4.5, P),
                  rng.uniform(-3.2, -0.8, P)], 1).astype(np.float32)
    d = np.stack([rng.normal(0, 0.25, P), -np.ones(P),
                  rng.normal(0, 0.25, P)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    keys = rng.integers(0, 2 ** 32, (P, 2), dtype=np.uint64)
    return o, d, keys


def test_walk_ties_on_the_floor(floor_staircase, monkeypatch):
    """transmittance_walk against the JAX package's, lane by lane: the
    first real surface hit and tr agree on every lane with the hit point
    rounded as an FMA; with the plain sum o + t d, some walks take the
    other face at the tie."""
    path, js, _ = floor_staircase
    ts = TD.load(path, device="cpu").s
    assert ts.scene.has_media and int(ts.scene.cam_medium) == 0
    o, d, keys = _walks_down_through_the_box(11)
    med = np.zeros(P, np.int32)  # the haze
    t_max = np.full(P, 1e30, np.float32)
    trj, hitj, realj = jax.jit(lambda m, a, b, tm, k: JV.transmittance_walk(
        js.scene, js.bvh, js.icfg, m, a, b, tm, k, STEP, 3))(
            med, o, d, t_max, jnp.asarray(keys.astype(np.uint32)))
    realj, idj, trj = (np.asarray(realj), np.asarray(hitj.prim_idx),
                       np.asarray(trj))
    assert realj.all()

    def walk():
        """(lanes whose first real hit differs, lanes with tr off)."""
        tr, hit, real = TV.transmittance_walk(
            ts.scene, ts.bvh, ts.icfg, torch.tensor(med), torch.tensor(o),
            torch.tensor(d), torch.tensor(t_max),
            torch.tensor(keys.astype(np.int64)), STEP, 3)
        real = real.numpy()
        differ = (real != realj) | (realj & (hit.prim_idx.numpy() != idj))
        off = ~np.isclose(tr.numpy(), trj, rtol=1e-5, atol=1e-6).all(-1)
        return int(differ.sum()), int(off.sum())

    assert walk() == (0, 0)
    assemble = TX._assemble_hit

    def plain_sum(scene, o_, d_, t_best, *a, **k):
        return assemble(scene, o_, d_, t_best, *a, **k)._replace(
            p=o_ + t_best[:, None] * d_)

    monkeypatch.setattr(TX, "_assemble_hit", plain_sum)
    differ, off = walk()
    assert differ > 0 and off > 0, (differ, off)


@pytest.mark.parametrize("camera", ["port", "jax"])
def test_volpath_end_to_end_box_on_floor(floor_staircase, monkeypatch,
                                         camera):
    """load(...).render() against the JAX package's, from the port's
    camera and from the JAX package's camera rays: every buffer within
    rtol 1e-4 on >= 98.5% of its pixels."""
    path, js, jax_render = floor_staircase
    if camera == "jax":
        jax_camera(monkeypatch, js)
    hold_to_jax(jax_render, TD.load(path, device="cpu"))
