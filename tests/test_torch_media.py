"""The JAX package's participating-media invariants (tests/test_media.py:
Beer-Lambert, the scattering fog, a constant grid equal to homogeneous,
a fog behind a null boundary, volpath without media equal to path), run
on the port's volpath (statmc_tpu_torch/render/volume.py) on the CPU.

The port's per-sample driver traces one sample per lane at a time, so
the 8x8 films of tests/test_media.py at 160-256 spp become 64x64 (or
64x48) films at 4 spp: the same samples per 8x8 block of pixels, in a
few calls instead of hundreds.  Per-pixel checks compare 8x8-pixel block
means with the same blocks of the analytic image.
"""
import tempfile

import numpy as np
import torch

import statmc_tpu_torch.driver as TD

torch.set_num_threads(2)

HEAD = (
    'Integrator "volpath" "integer maxdepth" [{depth}] '
    '"integer iterations" [1] "bool calcstats" ["true"] '
    '"float rrthreshold" [{rr}]\n'
    'Sampler "random" "integer pixelsamples" [{spp}]\n'
    'Film "image" "integer xresolution" [{w}] "integer yresolution" [{h}] '
    '"string filename" ["t.pfm"]\n'
    'Camera "perspective" "float fov" [40]\n'
)
QUAD = (
    'AttributeBegin\n'
    'AreaLightSource "diffuse" "rgb L" [2 2 2]\n'
    'Material "matte" "rgb Kd" [0 0 0]\n'
    'Shape "trianglemesh" "integer indices" [0 2 1 0 3 2] '
    '"point P" [-5 -5 2  5 -5 2  5 5 2  -5 5 2]\n'
    'AttributeEnd\n'
)
NULL_FOG = ('MakeNamedMedium "fog" "string type" ["homogeneous"] '
            '"rgb sigma_a" [{s} {s} {s}] "rgb sigma_s" [0 0 0]\n'
            'WorldBegin\n'
            'AttributeBegin\n'
            'MediumInterface "fog" ""\n'
            'Material "none"\n'
            'TransformBegin\nTranslate 0 0 1\n'
            'Shape "sphere" "float radius" [0.5]\nTransformEnd\n'
            'AttributeEnd\n')


def head(depth, rr, spp=4, w=64, h=64):
    return HEAD.format(depth=depth, rr=rr, spp=spp, w=w, h=h)


def _render(text, seed=0):
    """The film [H, W, 3] of load(text, device="cpu").render()."""
    with tempfile.TemporaryDirectory() as tmp:
        p = tmp + "/scene.pbrt"
        with open(p, "w") as f:
            f.write(text)
        r = TD.load(p, base_seed=seed, device="cpu")
    r.progress = False
    r.render(iterations=1, verbose=False)
    return r.film_mean.numpy().reshape(r.s.height, r.s.width, 3)


def _blocks(img, n=8):
    """Means of n x n blocks of pixels: [H/n, W/n]."""
    H, W = img.shape[:2]
    return img.reshape(H // n, n, W // n, n, -1).mean(axis=(1, 3, 4))


def test_port_camera_fog_beer_lambert():
    """The camera in a purely absorbing homogeneous medium, facing an
    emissive quad at depth 2: film = L exp(-sigma_a dist) per 8x8 block
    within 20%, and over the image within 2%."""
    sigma = 0.25
    film = _render(
        head(4, 1)
        + f'MakeNamedMedium "fog" "string type" ["homogeneous" ] '
          f'"rgb sigma_a" [{sigma} {sigma} {sigma}] '
          f'"rgb sigma_s" [0 0 0]\n'
        + 'MediumInterface "" "fog"\n'
        + 'WorldBegin\n' + QUAD + 'WorldEnd\n')
    xs = (np.arange(64) + 0.5) / 64 * 2 - 1
    t = np.tan(np.radians(20.0))
    gx, gy = np.meshgrid(xs * t, xs * t, indexing="xy")
    dirs = np.stack([gx, gy, np.ones((64, 64))], axis=-1)
    dist = 2.0 * np.linalg.norm(dirs, axis=-1) / dirs[..., 2]
    expect = 2.0 * np.exp(-sigma * dist)
    np.testing.assert_allclose(_blocks(film), _blocks(expect[..., None]),
                               rtol=0.2)
    np.testing.assert_allclose(film.mean(), expect.mean(), rtol=0.02)


def test_scattering_fog_estimates_agree():
    """A scattering fog lit by the quad.  tests/test_media.py's
    test_scattering_fog_nee_matches_phase_only passes enable_nee=False,
    which the JAX package's trace_volpath does not read, so it holds the
    NEE estimator against itself; here the NEE estimate under two seeds
    agrees within that test's bound, and the fog changes the image
    (against the vacuum scene), as there."""
    fog = (head(6, 0, w=64, h=40)
           + 'MakeNamedMedium "fog" "string type" ["homogeneous"] '
             '"rgb sigma_a" [0.02 0.02 0.02] '
             '"rgb sigma_s" [0.25 0.25 0.25] "float g" [0.0]\n'
           + 'MediumInterface "" "fog"\n'
           + 'WorldBegin\n' + QUAD + 'WorldEnd\n')
    a, b = (float(_render(fog, seed).mean()) for seed in (0, 1))
    assert abs(a - b) < 0.10 * max(b, 1e-3) + 0.01, (a, b)
    vac = float(_render(head(6, 0, spp=1, w=64, h=32) + 'WorldBegin\n'
                        + QUAD + 'WorldEnd\n').mean())
    assert abs(a - vac) > 0.02


def test_port_constant_grid_equals_homogeneous():
    """A constant-density grid equals the homogeneous medium with the
    same coefficients (delta tracking accepts the first candidate)."""
    common = ('"rgb sigma_a" [0.1 0.1 0.1] "rgb sigma_s" [0.2 0.2 0.2] '
              '"float g" [0.0]\n')
    body = 'MediumInterface "" "fog"\nWorldBegin\n' + QUAD + 'WorldEnd\n'
    mh = _render(head(5, 0, w=64, h=48)
                 + 'MakeNamedMedium "fog" "string type" ["homogeneous"] '
                 + common + body).mean()
    mg = _render(head(5, 0, w=64, h=48)
                 + 'MakeNamedMedium "fog" "string type" ["heterogeneous"] '
                   '"integer nx" [2] "integer ny" [2] "integer nz" [2] '
                   '"float density" [1 1 1 1 1 1 1 1] '
                   '"point p0" [-8 -8 -1] "point p1" [8 8 3] ' + common
                 + body).mean()
    np.testing.assert_allclose(mg, mh, rtol=0.08)


def test_port_null_boundary_fog():
    """Fog inside a null-material sphere between the camera and the quad,
    absorbing only: the central 2x2 blocks ~ L exp(-sigma_a chord)
    within 8%, the corner block brighter."""
    sigma = 0.4
    film = _blocks(_render(head(6, 1) + NULL_FOG.format(s=sigma) + QUAD
                           + 'WorldEnd\n'))
    center = film[3:5, 3:5].mean()
    np.testing.assert_allclose(center, 2.0 * np.exp(-sigma * 1.0), rtol=0.08)
    assert film[0, 0] > center


def test_volpath_without_media_matches_path():
    """volpath on a scene without media is the surface path tracer: the
    same film bit for bit."""
    body = ('Sampler "random" "integer pixelsamples" [8]\n'
            'Film "image" "integer xresolution" [8] '
            '"integer yresolution" [8] "string filename" ["t.pfm"]\n'
            'Camera "perspective" "float fov" [60]\n'
            'WorldBegin\n'
            'Material "matte" "rgb Kd" [0.5 0.5 0.5]\n'
            'Shape "sphere" "float radius" [1.0]\n'
            'LightSource "point" "rgb I" [3.14159265 3.14159265 3.14159265]\n'
            'WorldEnd\n')
    rv = _render('Integrator "volpath" "integer maxdepth" [3] '
                 '"integer iterations" [1]\n' + body)
    rp = _render('Integrator "path" "integer maxdepth" [3] '
                 '"integer iterations" [1]\n' + body)
    np.testing.assert_array_equal(rv, rp)
