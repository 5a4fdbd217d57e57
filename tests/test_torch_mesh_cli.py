"""``python -m statmc_tpu_torch --mesh`` on the CPU (--device cpu: the
command starts its ranks itself, over gloo): a 1x2 render writes the
single-device command's PFM names with values within rtol 1e-4 / atol
1e-5, and --denoise on them matches the single-device --denoise; an
integrator with its own driver ignores the mesh and says so; inside a
torchrun world, WORLD_SIZE must match the mesh."""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import statmc_tpu_torch.__main__ as TM
from statmc_tpu_torch.io.pfm import read_pfm
from statmc_tpu_torch.testscenes import ao_scene_text, scene_text

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _in_process(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert TM.main(argv) == 0
    return out.getvalue()


def _mesh_cli(argv):
    proc = subprocess.run([sys.executable, "-m", "statmc_tpu_torch", *argv],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        np.testing.assert_allclose(read_pfm(os.path.join(b, f)),
                                   read_pfm(os.path.join(a, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    return names


def test_mesh_1x2_cli_writes_the_single_device_files(tmp_path):
    path = tmp_path / "staircase.pbrt"
    path.write_text(scene_text(
        width=16, height=12, spp=2, iterations=2, maxdepth=3, denoise=True,
        filterradius=2, extra_integrator='"string outputregex" [".*"]'))
    one, mesh = tmp_path / "one", tmp_path / "mesh"
    _in_process([str(path), "--device", "cpu", "--writeimages", "--outdir",
                 str(one)])
    text = _mesh_cli([str(path), "--device", "cpu", "--writeimages",
                      "--outdir", str(mesh), "--mesh", "1x2"])
    assert "denoise: sharded over px=2" in text
    assert text.count("Collectives time [ns]: ") == 2
    assert "Camera rays traced 768" in text
    names = _same_files(one, mesh)
    assert {"staircase-proxy-2-film.pfm", "staircase-proxy-4-film-f.pfm",
            "staircase-proxy-4-t0-b0-m3.pfm"} <= set(names)
    # --denoise on the mesh's files, on the mesh and on one device.
    for d in (one, mesh):
        for f in os.listdir(d):
            if f.endswith("-f.pfm"):
                os.remove(os.path.join(d, f))
    _in_process([str(path), "--device", "cpu", "--denoise", "--outdir",
                 str(one)])
    _mesh_cli([str(path), "--device", "cpu", "--denoise", "--outdir",
               str(mesh), "--mesh", "1x2"])
    _same_files(one, mesh)


def test_mesh_cli_ignored_by_ao(tmp_path):
    path = tmp_path / "ao.pbrt"
    path.write_text(ao_scene_text(nsamples=4, width=8, height=6, spp=1,
                                  maxdepth=2))
    text = _mesh_cli([str(path), "--device", "cpu", "--writeimages",
                      "--outdir", str(tmp_path / "out"), "--mesh", "1x2"])
    assert 'Integrator "ao" renders on one device; the mesh is ignored' in text
    assert text.count("Iteration: 1") == 1
    assert os.listdir(tmp_path / "out")


def test_torchrun_world_must_match_the_mesh(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        TM.main([str(tmp_path / "none.pbrt"), "--device", "cpu", "--mesh",
                 "1x2"])
