"""Hair and subsurface scattering end to end on the two-level path: the
hair + SSS terrain at n = 88 (past 16,384 triangles, so the plain
versions of B3 and B4 carry it), 128 hair curves, in both packages.
Equal ray totals and sample counts; every other buffer within rtol 1e-4
on a share of the pixels (tests/test_torch_hair_sss.py explains the
shares).  The SSS block's lane gathering, which changes which rays share
a 512-ray block and so B3's votes and B4's walk order, is held bit for
bit against the masked block on the same terrain.
"""
import numpy as np
import pytest
import torch

import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.accel.twolevel import TwoLevelTris
from test_torch_hair_sss import (CURVES, _render_jax, hold_gathered_to_masked,
                                 hold_to_jax, jax_camera)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    """The hair + SSS terrain at n = 88, 16x12, 2 spp, maxdepth 3,
    denoised: (path, JAX setup, JAX render)."""
    path = tmp_path_factory.mktemp("terrain") / "scene.pbrt"
    path.write_text(TS.hair_sss_terrain_text(
        width=16, height=12, spp=2, iterations=1, maxdepth=3, n=88,
        curves=CURVES))
    return (str(path), *_render_jax(path))


def test_terrain_end_to_end(terrain):
    """The two-level path from the port's own camera: >= 98% (measured
    98.44%)."""
    path, _, jax_render = terrain
    rt = TD.load(path, device="cpu")
    assert isinstance(rt.s.bvh, TwoLevelTris) and rt.s.icfg.enable_sss
    hold_to_jax(jax_render, rt, 0.98)


def test_terrain_end_to_end_jax_camera(terrain, monkeypatch):
    """From the JAX package's camera rays: >= 98.5% (measured 98.96%)."""
    path, js, jax_render = terrain
    jax_camera(monkeypatch, js)
    hold_to_jax(jax_render, TD.load(path, device="cpu"), 0.985)


def test_terrain_sss_compaction_bit_identical(terrain, monkeypatch):
    """The SSS block on the gathered firing lanes against the block over
    every lane, on the two-level path: the ray total and every buffer
    bit for bit."""
    hold_gathered_to_masked(terrain[0], monkeypatch)
