"""The port's tools against the JAX package's (statmc_tpu_torch/tools):

* imgtool's info, convert, diff, assemble, cat and makesky on the same
  input files: output files equal byte for byte, exit codes and printed
  lines equal;
* obj2pbrt and cyhair2pbrt write byte-equal files, and the converted
  .pbrt renders through the port's load(..., device="cpu");
* bsdftest.estimate_rho on matte, plastic, substrate, metal and uber
  within rtol 1e-5 of the JAX package's (the same numpy draws), and
  main's exit code equal; without a card and without --device cpu both
  CPU-capable tools exit 1 with a message.
"""
import struct

import numpy as np
import pytest
import torch

from statmc_tpu.tools import bsdftest as JB
from statmc_tpu.tools import cyhair2pbrt as JC
from statmc_tpu.tools import imgtool as JI
from statmc_tpu.tools import obj2pbrt as JO
from statmc_tpu_torch import driver as TD
from statmc_tpu_torch.io.pfm import write_pfm
from statmc_tpu_torch.tools import bsdftest as TB
from statmc_tpu_torch.tools import cyhair2pbrt as TC
from statmc_tpu_torch.tools import imgtool as TI
from statmc_tpu_torch.tools import obj2pbrt as TO

torch.set_num_threads(2)

IMGTOOL_CASES = {
    "info": (["info", "{a}", "{c}"], []),
    "convert": (["convert", "--scale", "2", "--tonemap", "{a}", "{out}.exr"],
                ["out.exr"]),
    "convert_png": (["convert", "{a}", "{out}.png"], ["out.png"]),
    "diff": (["diff", "--outfile", "{out}.pfm", "--difftol", "1", "{a}",
              "{b}"], ["out.pfm"]),
    "diff_same": (["diff", "{a}", "{a}"], []),
    "assemble": (["assemble", "--outfile", "{out}.pfm", "{a}", "{b}"],
                 ["out.pfm"]),
    "cat": (["cat", "{c}"], []),
    "makesky": (["makesky", "--resolution", "24", "--elevation", "30",
                 "--turbidity", "4", "--outfile", "{out}.pfm"], ["out.pfm"]),
    "unknown": (["resize", "{a}"], []),
}


def _inputs(d):
    rng = np.random.default_rng(4)
    a = rng.gamma(2.0, 0.5, (12, 10, 3)).astype(np.float32)
    b = np.where(rng.random((12, 10, 1)) < 0.5, 0.0, a * 1.3).astype(
        np.float32)
    paths = {k: str(d / f"{k}.pfm") for k in "abc"}
    write_pfm(paths["a"], a)
    write_pfm(paths["b"], b)
    write_pfm(paths["c"], a[:3, :2])
    return paths


@pytest.mark.parametrize("case", sorted(IMGTOOL_CASES))
def test_imgtool_matches_jax(case, tmp_path, capsys):
    args, outs = IMGTOOL_CASES[case]
    paths = _inputs(tmp_path)
    res = {}
    for tag, mod in (("jax", JI), ("torch", TI)):
        (tmp_path / tag).mkdir()
        argv = [a.format(out=tmp_path / tag / "out", **paths) for a in args]
        rc = mod.main(argv)
        cap = capsys.readouterr()
        res[tag] = (rc, cap.out.replace(str(tmp_path / tag), "OUT"),
                    cap.err, [(tmp_path / tag / o).read_bytes() for o in outs])
    assert res["torch"] == res["jax"]
    assert res["jax"][0] == (1 if case in ("diff", "unknown") else 0)


def test_obj2pbrt_matches_jax_and_renders(tmp_path):
    (tmp_path / "m.mtl").write_text("newmtl red\nKd 0.8 0.1 0.1\n"
                                    "newmtl shiny\nKd 0.2 0.2 0.6\n"
                                    "Ks 0.5 0.5 0.5\nNs 40\n")
    obj = tmp_path / "s.obj"
    obj.write_text(
        "mtllib m.mtl\n"
        "v -1 -1 3\nv 1 -1 3\nv 1 1 3\nv -1 1 3\nv 0 0 3.5\n"
        "vn 0 0 -1\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl red\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "usemtl shiny\nf 1 2 5\n")
    n_j = JO.convert(str(obj), str(tmp_path / "j.pbrt"))
    n_t = TO.convert(str(obj), str(tmp_path / "t.pbrt"))
    assert n_t == n_j == 2
    assert (tmp_path / "t.pbrt").read_bytes() == \
        (tmp_path / "j.pbrt").read_bytes()
    scene = tmp_path / "scene.pbrt"
    scene.write_text(
        'Integrator "path" "integer maxdepth" [2]\n'
        'Sampler "random" "integer pixelsamples" [4]\n'
        'Film "image" "integer xresolution" [6] '
        '"integer yresolution" [6]\n'
        'Camera "perspective" "float fov" [60]\n'
        "WorldBegin\n"
        'LightSource "point" "rgb I" [10 10 10]\n'
        f'Include "{tmp_path / "t.pbrt"}"\n'
        "WorldEnd\n")
    r = TD.load(str(scene), device="cpu")
    r.render(iterations=1, verbose=False)
    f = r.film_mean.numpy().reshape(6, 6, 3)
    assert np.isfinite(f).all()
    assert f[..., 0].mean() > 3 * f[..., 2].mean()  # the red wall in front


def test_cyhair2pbrt_matches_jax_and_renders(tmp_path):
    n_strands, pts_per = 3, 5
    n_points = n_strands * pts_per
    header = (b"HAIR"
              + struct.pack("<IIII", n_strands, n_points, 2 | 4,
                            pts_per - 1)
              + struct.pack("<ff", 0.1, 0.0)
              + struct.pack("<fff", 0.5, 0.5, 0.5))
    header = header + b"\0" * (128 - len(header))
    rng = np.random.default_rng(6)
    pts = (np.repeat(np.linspace(-0.5, 0.5, n_strands), pts_per)[:, None]
           * [1, 0, 0] + np.tile(np.linspace(-0.8, 0.8, pts_per),
                                 n_strands)[:, None] * [0, 1, 0]
           + rng.normal(0, 0.02, (n_points, 3)) + [0, 0, 3]).astype("<f4")
    thick = np.full(n_points, 0.05, "<f4")
    hair = tmp_path / "t.hair"
    hair.write_bytes(header + pts.tobytes() + thick.tobytes())
    n_j = JC.convert(str(hair), str(tmp_path / "j.pbrt"))
    n_t = TC.convert(str(hair), str(tmp_path / "t.pbrt"))
    assert n_t == n_j == n_strands * (pts_per - 1)
    assert (tmp_path / "t.pbrt").read_bytes() == \
        (tmp_path / "j.pbrt").read_bytes()
    scene = tmp_path / "scene.pbrt"
    scene.write_text(
        'Integrator "path" "integer maxdepth" [2]\n'
        'Sampler "random" "integer pixelsamples" [2]\n'
        'Film "image" "integer xresolution" [8] '
        '"integer yresolution" [8]\n'
        'Camera "perspective" "float fov" [60]\n'
        "WorldBegin\n"
        'LightSource "distant" "point from" [0 0 0] "point to" [0 0 1] '
        '"rgb L" [3 3 3]\n'
        'Material "hair" "float eumelanin" [0.3]\n'
        f'Include "{tmp_path / "t.pbrt"}"\n'
        "WorldEnd\n")
    r = TD.load(str(scene), device="cpu")
    r.render(iterations=1, verbose=False)
    f = r.film_mean.numpy()
    assert np.isfinite(f).all() and f.max() > 0  # the strands are seen


@pytest.mark.parametrize("name", ["matte", "plastic", "substrate", "metal",
                                  "uber"])
def test_bsdftest_matches_jax(name, capsys):
    from statmc_tpu.scene import build as sb

    mt = TB.MATERIALS[name]
    assert mt == getattr(sb, f"MAT_{name.upper()}")
    j = JB.estimate_rho(mt, (0.5, 0.5, 0.5), (0.3, 0.3, 0.3), 0.35)
    t = TB.estimate_rho(mt, (0.5, 0.5, 0.5), (0.3, 0.3, 0.3), 0.35,
                        device="cpu")
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    rc_j = JB.main([name])
    out_j = capsys.readouterr().out
    rc_t = TB.main([name, "--device", "cpu"])
    out_t = capsys.readouterr().out
    assert rc_t == rc_j == 0
    assert out_t.splitlines()[0] == out_j.splitlines()[0]
    assert out_t.splitlines()[-1] == out_j.splitlines()[-1]


def test_bsdftest_exit_codes(monkeypatch, capsys):
    assert TB.main(["disney", "--device", "cpu"]) == JB.main(["disney"]) == 1
    assert TB.main(["matte", "--device"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    assert TB.main(["matte"]) == 1
    captured = capsys.readouterr()
    assert "--device cpu" in captured.err and not captured.out
