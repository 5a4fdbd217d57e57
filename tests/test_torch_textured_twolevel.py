"""A textured two-level scene with an environment map, end to end in both
packages: the terrain proxy at n = 88 (16,642 triangles, just past the
fused intersector's 16,384, so kernels B3 and B4's plain versions carry
every ray) with an imagemap floor, checkerboard boxes, textured spheres,
an environment-mapped infinite light and a projection light, 16x12."""
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.accel import fused as TF
from statmc_tpu_torch.accel import twolevel as TT
from test_torch_textures import hold_to_jax, jax_camera

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """(path, JAX setup, (ray totals per iteration, buffers)) of the JAX
    package's render."""
    d = tmp_path_factory.mktemp("terrain")
    path = d / "scene.pbrt"
    path.write_text(TS.textured_terrain_text(
        str(d), width=16, height=12, spp=2, iterations=2, maxdepth=3, n=88,
        denoise=True, floor=64, sky=(64, 32), light=16,
        spheres=("uv", "scale", "mix")))
    rj = JD.load(str(path))
    totals = [x["rays_total"] for x in rj.render(verbose=False)]
    return str(path), rj.s, (totals, {k: np.asarray(v)
                                      for k, v in rj.buffers().items()})


def test_textured_terrain_end_to_end(rendered):
    """From the port's own camera rays: equal ray totals and sample
    counts, every buffer within rtol 1e-4 on >= 96% of the pixels, as
    tests/test_torch_twolevel.py holds the untextured terrain (measured:
    96.88% at worst)."""
    path, js, jax_render = rendered
    rt = TD.load(path, device="cpu")
    assert isinstance(rt.s.bvh, TT.TwoLevelTris)
    assert rt.s.bvh.n_tris > TF.FUSED_MAX_TRIS
    assert rt.s.scene.env_light_id >= 0 and rt.s.scene.has_image_lights
    hold_to_jax(jax_render, rt, 0.96)


def test_textured_terrain_end_to_end_jax_camera(rendered, monkeypatch):
    """The same render from the JAX package's camera rays: >= 98.5%
    (measured: 99.48% at worst)."""
    path, js, jax_render = rendered
    jax_camera(monkeypatch, js)
    hold_to_jax(jax_render, TD.load(path, device="cpu"), 0.985)
