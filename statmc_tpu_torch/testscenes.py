# Copied from statmc_tpu/testscenes.py (numpy host code; imports rewritten, behaviour unchanged).
"""Procedural test scenes.

The reference's scene assets (PLY meshes, textures) are downloaded
separately (scripts/_download-scenes.sh) and are not part of the mounted
tree, so benchmarks and the graft entry use procedurally generated
pbrt-format scenes of comparable structure: the staircase proxy mimics
the paper's Fig.-1 scene shape (a room with a staircase of glossy boxes,
a glass sphere, metal rails and one bright area light panel).
"""
from __future__ import annotations

import numpy as np


def _box_tris(lo, hi):
    """12 triangles of an axis-aligned box; outward normals."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = [
        (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
        (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
    ]
    f = [
        (0, 2, 1), (0, 3, 2),  # z0 face (normal -z)
        (4, 5, 6), (4, 6, 7),  # z1 face (+z)
        (0, 1, 5), (0, 5, 4),  # y0 (-y)
        (3, 6, 2), (3, 7, 6),  # y1 (+y)
        (0, 4, 7), (0, 7, 3),  # x0 (-x)
        (1, 2, 6), (1, 6, 5),  # x1 (+x)
    ]
    return v, f


def _mesh_stmt(verts, faces, indent="  "):
    idx = " ".join(str(i) for fc in faces for i in fc)
    pts = " ".join(f"{c:.4f}" for v in verts for c in v)
    return (
        f'{indent}Shape "trianglemesh" "integer indices" [ {idx} ] '
        f'"point P" [ {pts} ]\n'
    )


def staircase_proxy(n_steps: int = 24, clutter: int = 60,
                    seed: int = 7) -> str:
    """A staircase-like room scene, fully self-contained pbrt text.

    ~(12 * (n_steps + clutter + 6)) triangles + a few spheres; glossy
    substrate steps, matte walls, metal rail, glass sphere, one area
    light -- the material mix of the paper's staircase scene.
    """
    rng = np.random.default_rng(seed)
    out = []
    # Room shell: floor, back wall, side walls (inward-facing normals not
    # required; materials are two-sided for intersection purposes).
    room = [
        ((-8, -0.2, -8), (8, 0.0, 8)),  # floor
        ((-8, 0.0, 7.8), (8, 10.0, 8.0)),  # back wall
        ((-8.2, 0.0, -8), (-8.0, 10.0, 8)),  # left wall
        ((8.0, 0.0, -8), (8.2, 10.0, 8)),  # right wall
        ((-8, 9.8, -8), (8, 10.0, 8)),  # ceiling
    ]
    out.append('Material "matte" "rgb Kd" [0.58 0.57 0.55]\n')
    for lo, hi in room:
        v, f = _box_tris(lo, hi)
        out.append(_mesh_stmt(v, f))

    # Stairs: substrate (glossy wood-like).
    out.append(
        'Material "substrate" "rgb Kd" [0.45 0.30 0.18] '
        '"rgb Ks" [0.04 0.04 0.04] "float uroughness" [0.1] '
        '"float vroughness" [0.1] "bool remaproughness" ["false"]\n'
    )
    for i in range(n_steps):
        y = 0.35 * i
        z = -6.0 + 0.5 * i
        v, f = _box_tris((-3.0, y, z), (0.5, y + 0.35, z + 0.5))
        out.append(_mesh_stmt(v, f))

    # Metal rail spheres.
    out.append(
        'Material "metal" "rgb eta" [0.2 0.92 1.1] "rgb k" [3.9 2.45 2.14] '
        '"float roughness" [0.05] "bool remaproughness" ["false"]\n'
    )
    for i in range(0, n_steps, 3):
        y = 0.35 * i + 1.2
        z = -6.0 + 0.5 * i
        out.append("AttributeBegin\n")
        out.append(f"Translate 0.8 {y:.3f} {z:.3f}\n")
        out.append('Shape "sphere" "float radius" [0.18]\n')
        out.append("AttributeEnd\n")

    # Clutter boxes: matte random colors.
    for _ in range(clutter):
        c = rng.random(3) * 0.7 + 0.1
        p = rng.random(3) * np.array([12, 3, 12]) - np.array([6, 0, 6])
        s = rng.random(3) * 0.8 + 0.2
        out.append(
            f'Material "matte" "rgb Kd" [{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}]\n'
        )
        v, f = _box_tris(tuple(p), tuple(p + s))
        out.append(_mesh_stmt(v, f))

    # Glass sphere.
    out.append('Material "glass" "float index" [1.5]\n')
    out.append("AttributeBegin\nTranslate -1.5 1.0 -3.0\n")
    out.append('Shape "sphere" "float radius" [1.0]\nAttributeEnd\n')

    # Area light panel on the ceiling (wound so the geometric normal
    # points DOWN into the room -- pbrt area lights emit one-sided).
    out.append(
        "AttributeBegin\n"
        'AreaLightSource "diffuse" "rgb L" [18 17 15]\n'
        'Material "matte" "rgb Kd" [0 0 0]\n'
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
        '"point P" [-2 9.7 -2  2 9.7 -2  2 9.7 2  -2 9.7 2]\n'
        "AttributeEnd\n"
    )
    body = "".join(out)
    return body


def terrain_proxy(n: int = 256, seed: int = 11) -> str:
    """A >=100k-triangle ENCLOSED scene for large-scene benchmarking.

    One heightfield floor of 2*(n-1)^2 triangles (n=256 -> 130050)
    inside a closed hall (walls + ceiling) with metal/glass spheres and
    a clutter field under two area light panels -- the two-level
    worklist traversal path (accel/twolevel.py; scenes past
    FUSED_MAX_TRIS).  Enclosure matters: the reference's perf scenes
    (staircase, bathroom, classroom) are interiors where every bounce
    shades and runs NEE; an open scene leaks most paths to the sky
    after one bounce and measures mostly dead lanes.  The reference
    scenes' PLY assets are not mounted, so scale comes from procedural
    geometry.
    """
    rng = np.random.default_rng(seed)
    out = []
    # Hall shell: four walls + ceiling enclose the terrain floor.
    out.append('Material "matte" "rgb Kd" [0.62 0.60 0.57]\n')
    shell = [
        ((-8.2, -0.5, -8.2), (-8.0, 8.2, 8.2)),   # left wall
        ((8.0, -0.5, -8.2), (8.2, 8.2, 8.2)),     # right wall
        ((-8.2, -0.5, -8.2), (8.2, 8.2, -8.0)),   # front wall
        ((-8.2, -0.5, 8.0), (8.2, 8.2, 8.2)),     # back wall
        ((-8.2, 8.0, -8.2), (8.2, 8.2, 8.2)),     # ceiling
    ]
    for lo, hi in shell:
        v, f = _box_tris(lo, hi)
        out.append(_mesh_stmt(v, f))
    # Multi-octave bumpy terrain over [0,1]^2 (z up in heightfield
    # space; the CTM below lays it flat in world y).
    us = np.linspace(0.0, 1.0, n)
    uu, vv = np.meshgrid(us, us, indexing="xy")
    z = np.zeros_like(uu)
    for octv in range(5):
        f = 2.0 ** octv
        amp = 0.5 ** octv
        pu, pv = rng.random(2) * 6.28
        z += amp * np.sin(6.28 * f * uu + pu) * np.cos(6.28 * f * vv + pv)
    z = (z - z.min()) / max(float(np.ptp(z)), 1e-9) * 0.15
    pz = " ".join(f"{v:.4f}" for v in z.reshape(-1))
    out.append('Material "substrate" "rgb Kd" [0.35 0.3 0.25] '
               '"rgb Ks" [0.05 0.05 0.05] "float uroughness" [0.15] '
               '"float vroughness" [0.15] "bool remaproughness" ["false"]\n')
    out.append("AttributeBegin\n")
    out.append("Translate -8 0 -8\nScale 16 1 16\nRotate -90 1 0 0\n")
    out.append(f'Shape "heightfield" "integer nu" [{n}] "integer nv" [{n}] '
               f'"float Pz" [ {pz} ]\n')
    out.append("AttributeEnd\n")

    # Sphere field: mixed metal/glass/matte.
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
        out.append("AttributeBegin\n")
        out.append(mats[i % len(mats)])
        out.append(f"Translate {p[0]:.3f} {0.6 + r:.3f} {p[1]:.3f}\n")
        out.append(f'Shape "sphere" "float radius" [{r:.3f}]\n')
        out.append("AttributeEnd\n")

    # Clutter boxes.
    for _ in range(120):
        c = rng.random(3) * 0.7 + 0.1
        p = rng.random(3) * np.array([14, 1.2, 14]) - np.array([7, -0.3, 7])
        s = rng.random(3) * 0.5 + 0.1
        out.append(
            f'Material "matte" "rgb Kd" [{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}]\n'
        )
        v, f = _box_tris(tuple(p), tuple(p + s))
        out.append(_mesh_stmt(v, f))

    # Two ceiling light panels (wound so normals point down).
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
    return "".join(out)


def terrain_scene_text(width=1280, height=720, spp=4, iterations=1,
                       maxdepth=8, n: int = 256, denoise=False) -> str:
    body = terrain_proxy(n=n)
    return (
        f'Integrator "statpath" "integer maxdepth" [{maxdepth}] '
        f'"integer iterations" [{iterations}] '
        f'"bool expiterations" ["true"] '
        f'"bool denoiseimage" ["{"true" if denoise else "false"}"] '
        f'"bool calcstats" ["true"]\n'
        f'Sampler "random" "integer pixelsamples" [{spp}]\n'
        f'Film "image" "integer xresolution" [{width}] '
        f'"integer yresolution" [{height}] '
        f'"string filename" ["terrain-proxy.pfm"]\n'
        'LookAt 6.5 5.5 -7  0 0.8 0  0 1 0\n'
        'Camera "perspective" "float fov" [52]\n'
        "WorldBegin\n" + body + "WorldEnd\n"
    )


def scene_text(width=512, height=512, spp=4, iterations=5, maxdepth=16,
               denoise=True, filtersd=10.0, filterradius=20,
               body: str | None = None, extra_integrator: str = "") -> str:
    body = body if body is not None else staircase_proxy()
    return (
        f'Integrator "statpath" "integer maxdepth" [{maxdepth}] '
        f'"integer iterations" [{iterations}] '
        f'"bool expiterations" ["true"] '
        f'"bool denoiseimage" ["{"true" if denoise else "false"}"] '
        f'"bool calcstats" ["true"] '
        f'"float filtersd" [{filtersd}] '
        f'"integer filterradius" [{filterradius}] '
        f'"string filterbuffers" ["albedo" "normal"] '
        f'"float filterbuffersds" [0.02 0.1] '
        f'{extra_integrator}\n'
        f'Sampler "random" "integer pixelsamples" [{spp}]\n'
        f'Film "image" "integer xresolution" [{width}] '
        f'"integer yresolution" [{height}] '
        f'"string filename" ["staircase-proxy.pfm"]\n'
        'LookAt 6.5 4.5 -7.5  -1 2.5 0  0 1 0\n'
        'Camera "perspective" "float fov" [55]\n'
        "WorldBegin\n" + body + "WorldEnd\n"
    )
