# Frozen copy of statmc_tpu_torch/testscenes.py: _box_tris, _mesh_stmt and
# staircase_proxy (the staircase proxy, 1,070 triangles and 9 spheres),
# with every default as it stands there.  Changes: none to the geometry or
# the materials; besides the pbrt text, build() returns the world-space
# triangles and spheres that the text describes, for the benchmark's
# reference.  The camera is testscenes.scene_text's.
"""The staircase proxy: a room with a staircase of glossy boxes, a glass
sphere, metal rail spheres, 60 matte clutter boxes and one area light
panel, the material mix of the paper's staircase scene (Bitterli's
pbrt-v3 "staircase"), whose assets the repository does not hold."""
from __future__ import annotations

import numpy as np

CAMERA = ('LookAt 6.5 4.5 -7.5  -1 2.5 0  0 1 0\n'
          'Camera "perspective" "float fov" [55]\n')


def _box_tris(lo, hi):
    """12 triangles of an axis-aligned box; outward normals."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = [
        (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
        (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
    ]
    f = [
        (0, 2, 1), (0, 3, 2),
        (4, 5, 6), (4, 6, 7),
        (0, 1, 5), (0, 5, 4),
        (3, 6, 2), (3, 7, 6),
        (0, 4, 7), (0, 7, 3),
        (1, 2, 6), (1, 6, 5),
    ]
    return v, f


class Geometry:
    """World-space triangles [T,3,3] and spheres (centres [S,3], radii
    [S]) as the pbrt text writes them (its rounding included)."""

    def __init__(self):
        self.tris, self.centres, self.radii = [], [], []

    def mesh(self, verts, faces, indent="  "):
        """The trianglemesh statement; records its triangles as written."""
        idx = " ".join(str(i) for fc in faces for i in fc)
        pts = " ".join(f"{c:.4f}" for v in verts for c in v)
        vw = np.array([[float(f"{c:.4f}") for c in v] for v in verts])
        self.tris.extend(vw[list(fc)] for fc in faces)
        return (f'{indent}Shape "trianglemesh" "integer indices" [ {idx} ] '
                f'"point P" [ {pts} ]\n')

    def sphere(self, centre_text, radius_text):
        self.centres.append([float(c) for c in centre_text.split()])
        self.radii.append(float(radius_text))

    def arrays(self):
        return (np.asarray(self.tris, np.float64).reshape(-1, 3, 3),
                np.asarray(self.centres, np.float64).reshape(-1, 3),
                np.asarray(self.radii, np.float64))


def build(n_steps: int = 24, clutter: int = 60, seed: int = 7):
    """(world body text, Geometry) of the staircase proxy."""
    geo = Geometry()
    rng = np.random.default_rng(seed)
    out = []
    room = [
        ((-8, -0.2, -8), (8, 0.0, 8)),  # floor
        ((-8, 0.0, 7.8), (8, 10.0, 8.0)),  # back wall
        ((-8.2, 0.0, -8), (-8.0, 10.0, 8)),  # left wall
        ((8.0, 0.0, -8), (8.2, 10.0, 8)),  # right wall
        ((-8, 9.8, -8), (8, 10.0, 8)),  # ceiling
    ]
    out.append('Material "matte" "rgb Kd" [0.58 0.57 0.55]\n')
    for lo, hi in room:
        out.append(geo.mesh(*_box_tris(lo, hi)))

    out.append(
        'Material "substrate" "rgb Kd" [0.45 0.30 0.18] '
        '"rgb Ks" [0.04 0.04 0.04] "float uroughness" [0.1] '
        '"float vroughness" [0.1] "bool remaproughness" ["false"]\n')
    for i in range(n_steps):
        y = 0.35 * i
        z = -6.0 + 0.5 * i
        out.append(geo.mesh(*_box_tris((-3.0, y, z), (0.5, y + 0.35, z + 0.5))))

    out.append(
        'Material "metal" "rgb eta" [0.2 0.92 1.1] "rgb k" [3.9 2.45 2.14] '
        '"float roughness" [0.05] "bool remaproughness" ["false"]\n'
    )
    for i in range(0, n_steps, 3):
        y = 0.35 * i + 1.2
        z = -6.0 + 0.5 * i
        centre = f"0.8 {y:.3f} {z:.3f}"
        out.append("AttributeBegin\n")
        out.append(f"Translate {centre}\n")
        out.append('Shape "sphere" "float radius" [0.18]\n')
        out.append("AttributeEnd\n")
        geo.sphere(centre, "0.18")

    for i in range(clutter):
        c = rng.random(3) * 0.7 + 0.1
        p = rng.random(3) * np.array([12, 3, 12]) - np.array([6, 0, 6])
        s = rng.random(3) * 0.8 + 0.2
        out.append(f'Material "matte" "rgb Kd" '
                   f'[{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}]\n')
        out.append(geo.mesh(*_box_tris(tuple(p), tuple(p + s))))

    out.append('Material "glass" "float index" [1.5]\n')
    out.append("AttributeBegin\nTranslate -1.5 1.0 -3.0\n")
    out.append('Shape "sphere" "float radius" [1.0]\nAttributeEnd\n')
    geo.sphere("-1.5 1.0 -3.0", "1.0")

    # The area light panel, wound so that its normal points down.
    light = [(-2, 9.7, -2), (2, 9.7, -2), (2, 9.7, 2), (-2, 9.7, 2)]
    out.append(
        "AttributeBegin\n"
        'AreaLightSource "diffuse" "rgb L" [18 17 15]\n'
        'Material "matte" "rgb Kd" [0 0 0]\n'
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
        '"point P" [-2 9.7 -2  2 9.7 -2  2 9.7 2  -2 9.7 2]\n'
        "AttributeEnd\n"
    )
    geo.tris.extend(np.array(light, np.float64)[list(f)]
                    for f in ((0, 1, 2), (0, 2, 3)))
    return "".join(out), geo
