# Frozen copy of statmc_tpu_torch/testscenes.py: terrain_proxy (the
# terrain proxy of bench.py:68-94: a 256 x 256 heightfield of 130,050
# triangles, a hall of 5 boxes, 120 clutter boxes, 48 spheres and two
# area light panels; 131,554 triangles), with every default as it stands
# there.  Changes:
# - the heightfield's Translate is "-8 0 8" where the original has
#   "-8 0 -8".  The original lays the heightfield over z in [-24, -8],
#   behind the hall's front wall, where no camera ray sees it; here it is
#   the hall's floor, z in [-8, 8], under the clutter and the spheres.
# - besides the pbrt text, build() returns the world-space triangles and
#   spheres that the text describes, for the benchmark's reference.
# The camera is testscenes.terrain_scene_text's.
"""The terrain proxy: a closed hall whose floor is a bumpy heightfield,
with metal, glass, matte and plastic spheres and a clutter field under
two area light panels.  Past 16,384 triangles the port takes its
two-level traversal (kernels B3 and B4)."""
from __future__ import annotations

import numpy as np

from staircase import Geometry, _box_tris

CAMERA = ('LookAt 6.5 5.5 -7  0 0.8 0  0 1 0\n'
          'Camera "perspective" "float fov" [52]\n')


def _heightfield_world(n: int, z_text: list):
    """The heightfield's triangles in world space: the grid of
    scene/tessellate.py's heightfield (cells (a, a+1, b+1), (a, b+1, b))
    under Translate -8 0 8, Scale 16 1 16, Rotate -90 1 0 0, which maps
    (u, v, h) to (16 u - 8, h, 8 - 16 v)."""
    us = np.linspace(0.0, 1.0, n, dtype=np.float32).astype(np.float64)
    uu, vv = np.meshgrid(us, us, indexing="xy")
    h = np.array([float(t) for t in z_text]).reshape(n, n)
    P = np.stack([16.0 * uu - 8.0, h, 8.0 - 16.0 * vv], -1).reshape(-1, 3)
    j, i = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (j * n + i).reshape(-1)
    b = a + n
    faces = np.stack([np.stack([a, a + 1, b + 1], -1),
                      np.stack([a, b + 1, b], -1)], 1).reshape(-1, 3)
    return P[faces]


def build(n: int = 256, seed: int = 11):
    """(world body text, Geometry) of the terrain proxy."""
    geo = Geometry()
    rng = np.random.default_rng(seed)
    out = []
    out.append('Material "matte" "rgb Kd" [0.62 0.60 0.57]\n')
    shell = [
        ((-8.2, -0.5, -8.2), (-8.0, 8.2, 8.2)),   # left wall
        ((8.0, -0.5, -8.2), (8.2, 8.2, 8.2)),     # right wall
        ((-8.2, -0.5, -8.2), (8.2, 8.2, -8.0)),   # front wall
        ((-8.2, -0.5, 8.0), (8.2, 8.2, 8.2)),     # back wall
        ((-8.2, 8.0, -8.2), (8.2, 8.2, 8.2)),     # ceiling
    ]
    for lo, hi in shell:
        out.append(geo.mesh(*_box_tris(lo, hi)))
    us = np.linspace(0.0, 1.0, n)
    uu, vv = np.meshgrid(us, us, indexing="xy")
    z = np.zeros_like(uu)
    for octv in range(5):
        f = 2.0 ** octv
        amp = 0.5 ** octv
        pu, pv = rng.random(2) * 6.28
        z += amp * np.sin(6.28 * f * uu + pu) * np.cos(6.28 * f * vv + pv)
    z = (z - z.min()) / max(float(np.ptp(z)), 1e-9) * 0.15
    z_text = [f"{v:.4f}" for v in z.reshape(-1)]
    out.append(
        'Material "substrate" "rgb Kd" [0.35 0.3 0.25] '
        '"rgb Ks" [0.05 0.05 0.05] "float uroughness" [0.15] '
        '"float vroughness" [0.15] "bool remaproughness" ["false"]\n')
    out.append("AttributeBegin\n")
    out.append("Translate -8 0 8\nScale 16 1 16\nRotate -90 1 0 0\n")
    out.append(f'Shape "heightfield" "integer nu" [{n}] "integer nv" [{n}] '
               f'"float Pz" [ {" ".join(z_text)} ]\n')
    out.append("AttributeEnd\n")
    geo.tris.extend(_heightfield_world(n, z_text))

    mats = [
        'Material "metal" "rgb eta" [0.2 0.92 1.1] "rgb k" '
        '[3.9 2.45 2.14] "float roughness" [0.05] '
        '"bool remaproughness" ["false"]\n',
        'Material "glass" "float index" [1.5]\n',
        'Material "matte" "rgb Kd" [0.6 0.3 0.2]\n',
        'Material "plastic" "rgb Kd" [0.2 0.35 0.6] '
        '"rgb Ks" [0.3 0.3 0.3] "float roughness" [0.08]\n',
    ]
    for i in range(48):
        p = rng.random(2) * 12 - 6
        r = rng.random() * 0.35 + 0.15
        centre = f"{p[0]:.3f} {0.6 + r:.3f} {p[1]:.3f}"
        out.append("AttributeBegin\n")
        out.append(mats[i % len(mats)])
        out.append(f"Translate {centre}\n")
        out.append(f'Shape "sphere" "float radius" [{r:.3f}]\n')
        out.append("AttributeEnd\n")
        geo.sphere(centre, f"{r:.3f}")

    for i in range(120):
        c = rng.random(3) * 0.7 + 0.1
        p = rng.random(3) * np.array([14, 1.2, 14]) - np.array([7, -0.3, 7])
        s = rng.random(3) * 0.5 + 0.1
        out.append(f'Material "matte" "rgb Kd" [{c[0]:.3f} {c[1]:.3f} '
                   f'{c[2]:.3f}]\n')
        out.append(geo.mesh(*_box_tris(tuple(p), tuple(p + s))))

    for cx in (-4.0, 4.0):
        out.append(
            "AttributeBegin\n"
            'AreaLightSource "diffuse" "rgb L" [16 15 14]\n'
            'Material "matte" "rgb Kd" [0 0 0]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            f'"point P" [{cx-2:.1f} 7.9 -2  {cx+2:.1f} 7.9 -2  '
            f'{cx+2:.1f} 7.9 2  {cx-2:.1f} 7.9 2]\n'
            "AttributeEnd\n"
        )
        quad = np.array([(cx - 2, 7.9, -2), (cx + 2, 7.9, -2),
                         (cx + 2, 7.9, 2), (cx - 2, 7.9, 2)])
        geo.tris.extend(quad[list(f)] for f in ((0, 1, 2), (0, 2, 3)))
    return "".join(out), geo
