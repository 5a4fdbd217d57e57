"""How far the hair + SSS staircase's pixels can agree at all: the
24x16 staircase of tests/test_torch_hair_sss.py rendered by the JAX
package as compiled by default and again with XLA's backend
optimisations off (--xla_backend_optimization_level=0, in a subprocess:
same program, no fusion, so other roundings), and by the port from the
JAX package's camera rays, whose paths are traced pixel by pixel to see
which of them touch hair or a subsurface material.

Measured worst shares of pixels within rtol 1e-4 (every buffer but the
sample counts, against the default-compiled JAX package): the JAX
package at -O0 0.9089 (its m3; the hair-touching pixels 0.7857), the
port 0.9635 (its m3; the hair-touching pixels 0.9184).  So the 98.5%
that tests/test_torch_hair_sss.py cannot hold is beyond what the JAX
package holds against itself on this scene: a ribbon a few hundredths
wide turns an ulp of a ray into another hair offset h, and a subsurface
probe into another exit point.  On the pixels whose paths touch neither
hair nor a subsurface material, the port meets 98.5% (measured 0.9905;
the denoiser's feedback carries a difference into a neighbour).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.render import integrator as TI
from statmc_tpu_torch.render import intersect as TX
from statmc_tpu_torch.scene import build as sb
from test_torch_hair_sss import CURVES, _render_jax, jax_camera

torch.set_num_threads(2)
W, H = 24, 16

_JAX_O0 = """
import sys
import numpy as np
import statmc_tpu.driver as JD
rj = JD.load(sys.argv[1])
totals = [x["rays_total"] for x in rj.render(verbose=False)]
np.savez(sys.argv[2], rays_total=np.asarray(totals, np.float64),
         **{k: np.asarray(v) for k, v in rj.buffers().items()})
"""


def _shares(ref, other, pick=None):
    """Per buffer (sample counts left out, as they are held equal), the
    share of pixels (of `pick`, a flat pixel mask) within rtol 1e-4 /
    atol 1e-6 of ref."""
    out = {}
    for k, a in ref.items():
        if k.endswith("-n"):
            continue
        close = np.isclose(np.asarray(other[k]), a, rtol=1e-4, atol=1e-6)
        close = (close.all(-1) if close.ndim == 3 else close).reshape(-1)
        out[k] = close[pick].mean() if pick is not None else close.mean()
    return out


def _worst(shares):
    k = min(shares, key=shares.get)
    return k, shares[k]


@pytest.fixture(scope="module")
def witnesses(tmp_path_factory):
    """The scene rendered by the JAX package (default and at -O0) and by
    the port from the JAX camera, with the pixels whose paths touched
    hair and those whose paths fired the SSS block: (JAX render, its
    -O0 render, the port's, hair pixels, SSS pixels)."""
    tmp = tmp_path_factory.mktemp("witness")
    path = tmp / "scene.pbrt"
    path.write_text(TS.hair_sss_scene_text(
        width=W, height=H, spp=2, iterations=2, maxdepth=3,
        filterradius=2, curves=CURVES))
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_backend_optimization_level=0").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         env.get("PYTHONPATH", "")])
    o0 = subprocess.Popen([sys.executable, "-c", _JAX_O0, str(path),
                           str(tmp / "o0.npz")], env=env)
    try:
        js, (totals, bj) = _render_jax(path)
        hair, sss = np.zeros(W * H, bool), np.zeros(W * H, bool)
        port = _render_port_traced(str(path), js, hair, sss)
    finally:
        assert o0.wait(timeout=300) == 0
    with np.load(tmp / "o0.npz") as z:
        b0 = {k: z[k] for k in z.files}
    return (totals, bj), (list(b0.pop("rays_total")), b0), port, hair, sss


def _render_port_traced(path, js, hair, sss):
    """The port's render from the JAX camera; hair[i] set where a ray of
    pixel i's paths (camera, shadow, BSDF-MIS or probe) found a hair
    triangle closest, sss[i] where pixel i's paths fired the SSS block.
    Every lane of the render is one pixel (one block of W * H)."""
    mp = pytest.MonkeyPatch()
    try:
        jax_camera(mp, js)
        rt = TD.load(path, device="cpu")
        sc, fired = rt.s.scene, [None]
        gather, tris = TI._firing_lanes, TX._intersect_tris

        def firing_lanes(fire):
            assert fire.shape[0] == W * H
            sss[:] |= fire.numpy()
            fired[0] = torch.nonzero(fire)[:, 0].numpy()
            return gather(fire)

        def intersect_tris(bvh, o, d, t_max):
            t, tid, found = tris(bvh, o, d, t_max)
            mt = sc.mat_type[sc.tri_mat[torch.clamp(tid.long(), min=0)]]
            on_hair = (found & (mt == sb.MAT_HAIR)).numpy()
            if o.shape[0] == W * H:
                hair[:] |= on_hair
            else:  # the SSS block's calls, on its gathered lanes
                assert o.shape[0] == fired[0].shape[0]
                hair[fired[0][on_hair]] = True
            return t, tid, found

        mp.setattr(TI, "_firing_lanes", firing_lanes)
        mp.setattr(TX, "_intersect_tris", intersect_tris)
        totals = [x["rays_total"] for x in rt.render(verbose=False)]
        return totals, {k: np.asarray(v) for k, v in rt.buffers().items()}
    finally:
        mp.undo()


def test_port_agrees_with_jax_no_worse_than_jax_with_itself(witnesses):
    """Equal ray totals in all three renders; the port's worst share
    against the default-compiled JAX package at least the -O0 JAX
    package's (measured 0.9635 and 0.9089), on every pixel and on the
    pixels whose paths touch hair (0.9184 and 0.7857)."""
    (totals, bj), (totals0, b0), (totals_t, bt), hair, _ = witnesses
    assert totals0 == totals and totals_t == totals
    assert 0 < hair.sum() < hair.size
    for pick, name in ((None, "every pixel"), (hair, "hair pixels")):
        k0, s0 = _worst(_shares(bj, b0, pick))
        kt, st = _worst(_shares(bj, bt, pick))
        print(f"{name}: JAX at -O0 {s0:.4f} ({k0}), port {st:.4f} ({kt})")
        assert s0 <= st, (name, k0, s0, kt, st)


def test_paths_without_hair_or_sss_meet_the_share(witnesses):
    """On the pixels whose paths touch neither hair nor a subsurface
    material, every buffer of the port within rtol 1e-4 of the JAX
    package's on >= 98.5% of them (measured 0.9905)."""
    (_, bj), _, (_, bt), hair, sss = witnesses
    plain = ~(hair | sss)
    assert 0.3 < plain.mean() < 0.9
    k, s = _worst(_shares(bj, bt, plain))
    print(f"{int(plain.sum())} pixels without hair or SSS: worst {k} {s:.4f}")
    assert s >= 0.985, (k, s)
