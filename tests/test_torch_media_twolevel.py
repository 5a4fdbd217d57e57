"""volpath with participating media end to end on the two-level path:
load(...).render() of the terrain proxy at n = 88 (16,654 triangles
with the smoke box's 12, past FUSED_MAX_TRIS, so kernels B3 and B4's
plain versions serve every closest-hit call, the walks' included) with
the homogeneous haze and an 8^3 grid smoke in a glass tank in the middle
of the hall, in both packages, from the port's camera and from the JAX
package's camera rays:
ray totals within 0.1%, equal sample counts, every other buffer within
rtol 1e-4 on >= 98.5% of its pixels (tests/test_torch_volpath.py holds
the fused path with null boundaries and says why paths diverge at all).
The tank's glass faces keep the scene free of null materials, so the
walks have K = 1 segment: with a null box (K = 9, 37 two-level
closest-hit calls in a step) the JAX package took 70-150 s here to
compile the bounce loop.  chip_smoke.py's `volpath two-level` phase
walks null boundaries on the two-level path on the card.
"""
import pytest
import torch

import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.accel.twolevel import TwoLevelTris
from test_torch_hair_sss import jax_camera
from test_torch_volpath import _render_jax, hold_to_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    """The volpath terrain at 16x12, 1 spp, maxdepth 4, n = 88, an 8^3
    smoke in a glass tank, not denoised: (path, JAX setup, JAX
    render)."""
    path = tmp_path_factory.mktemp("volterrain") / "scene.pbrt"
    path.write_text(TS.volpath_terrain_text(
        width=16, height=12, spp=1, iterations=1, maxdepth=4, n=88, grid=8,
        denoise=False, boundary="glass"))
    return (str(path), *_render_jax(path))


def test_volpath_twolevel_end_to_end(terrain):
    """From the port's own camera."""
    path, js, jax_render = terrain
    rt = TD.load(path, device="cpu")
    assert isinstance(rt.s.bvh, TwoLevelTris)
    assert rt.s.bvh.n_tris == js.bvh.n_tris > 16384
    assert rt.s.icfg.volumetric and rt.s.icfg.has_grid_media
    assert rt.s.icfg.null_extra == js.icfg.null_extra == 0
    hold_to_jax(jax_render, rt)


def test_volpath_twolevel_end_to_end_jax_camera(terrain, monkeypatch):
    """From the JAX package's camera rays."""
    path, js, jax_render = terrain
    jax_camera(monkeypatch, js)
    hold_to_jax(jax_render, TD.load(path, device="cpu"))
