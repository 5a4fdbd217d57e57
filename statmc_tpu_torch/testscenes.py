# Copied from statmc_tpu/testscenes.py (numpy host code; imports rewritten,
# behaviour unchanged); the material overrides of staircase_proxy and
# terrain_proxy and the textured and hair + subsurface scenes at the end
# are the port's own.
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
                    seed: int = 7, shell_mat: str | None = None,
                    stair_mat: str | None = None,
                    clutter_mats: list | None = None) -> str:
    """A staircase-like room scene, fully self-contained pbrt text.

    ~(12 * (n_steps + clutter + 6)) triangles + a few spheres; glossy
    substrate steps, matte walls, metal rail, glass sphere, one area
    light -- the material mix of the paper's staircase scene.  The
    *_mat arguments replace the room shell's, the steps' and (cycling,
    None entries keeping the default) the clutter boxes' Material lines;
    the geometry stays the same.
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
    out.append(shell_mat or 'Material "matte" "rgb Kd" [0.58 0.57 0.55]\n')
    for lo, hi in room:
        v, f = _box_tris(lo, hi)
        out.append(_mesh_stmt(v, f))

    # Stairs: substrate (glossy wood-like).
    out.append(stair_mat or (
        'Material "substrate" "rgb Kd" [0.45 0.30 0.18] '
        '"rgb Ks" [0.04 0.04 0.04] "float uroughness" [0.1] '
        '"float vroughness" [0.1] "bool remaproughness" ["false"]\n'))
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
    for i in range(clutter):
        c = rng.random(3) * 0.7 + 0.1
        p = rng.random(3) * np.array([12, 3, 12]) - np.array([6, 0, 6])
        s = rng.random(3) * 0.8 + 0.2
        alt = clutter_mats[i % len(clutter_mats)] if clutter_mats else None
        out.append(alt or f'Material "matte" "rgb Kd" '
                   f'[{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}]\n')
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


def terrain_proxy(n: int = 256, seed: int = 11, floor_mat: str | None = None,
                  sphere_mats: list | None = None,
                  clutter_mat: str | None = None,
                  clutter_mats: list | None = None) -> str:
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
    geometry.  floor_mat, sphere_mats (indexed like the default four,
    None entries keeping the default) and clutter_mat replace Material
    lines; clutter_mats, cycling with None entries keeping the default,
    replaces the boxes' lines one by one; the geometry stays the same.
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
    out.append(floor_mat or (
        'Material "substrate" "rgb Kd" [0.35 0.3 0.25] '
        '"rgb Ks" [0.05 0.05 0.05] "float uroughness" [0.15] '
        '"float vroughness" [0.15] "bool remaproughness" ["false"]\n'))
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
        alt = sphere_mats[i % len(sphere_mats)] if sphere_mats else None
        out.append(alt or mats[i % len(mats)])
        out.append(f"Translate {p[0]:.3f} {0.6 + r:.3f} {p[1]:.3f}\n")
        out.append(f'Shape "sphere" "float radius" [{r:.3f}]\n')
        out.append("AttributeEnd\n")

    # Clutter boxes.
    for i in range(120):
        c = rng.random(3) * 0.7 + 0.1
        p = rng.random(3) * np.array([14, 1.2, 14]) - np.array([7, -0.3, 7])
        s = rng.random(3) * 0.5 + 0.1
        alt = clutter_mats[i % len(clutter_mats)] if clutter_mats else None
        out.append(alt or clutter_mat or (
            f'Material "matte" "rgb Kd" [{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}]\n'
        ))
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


# ---------------------------------------------------------------------------
# Textured scenes: every texture kind, an HDR environment map and an
# image-modulated light, with their images written by the port's own
# writers (io/image.py, io/exr.py).


def texture_assets(directory: str, seed: int = 0, floor: int = 2048,
                   sky: tuple = (2048, 1024), light: int = 512) -> None:
    """Write the textured scenes' images into `directory`, made from
    `seed`: floor.png (floor x floor, 8-bit sRGB: tiles of 8 texels
    with noise on top, so every MIP level differs), sky.exr (sky[0] x
    sky[1] HDR: a sun-like hot spot over a sky gradient) and light.png
    (light x light, the goniometric/projection light's image)."""
    import os

    from .io.exr import write_exr
    from .io.image import write_png

    rng = np.random.default_rng(seed)
    tiles = rng.random((floor // 8, floor // 8, 3)).repeat(8, 0).repeat(8, 1)
    img = 0.05 + 0.6 * tiles + 0.3 * rng.random((floor, floor, 3))
    write_png(os.path.join(directory, "floor.png"), img.astype(np.float32))
    W, H = sky
    v = (np.arange(H) + 0.5) / H  # theta / pi
    u = (np.arange(W) + 0.5) / W  # phi / 2 pi
    grad = np.stack([0.3 + 0.4 * v, 0.45 + 0.35 * v, 0.9 - 0.3 * v], -1)
    sky_img = np.broadcast_to(grad[:, None, :], (H, W, 3)).copy()
    du = np.minimum(np.abs(u - 0.3), 1.0 - np.abs(u - 0.3))[None, :]
    r2 = (du * 2.0) ** 2 + (v[:, None] - 0.25) ** 2
    sky_img += (400.0 * np.exp(-r2 / 2e-4))[..., None] * np.array(
        [1.0, 0.9, 0.75])
    write_exr(os.path.join(directory, "sky.exr"), sky_img.astype(np.float32))
    yy, xx = np.mgrid[0:light, 0:light] / max(light - 1, 1)
    ring = 0.5 + 0.5 * np.cos(12.0 * np.hypot(xx - 0.5, yy - 0.5))
    lt = np.stack([ring, 0.3 + 0.7 * xx, 0.3 + 0.7 * yy], -1)
    write_png(os.path.join(directory, "light.png"), lt.astype(np.float32))


# Texture statements for every kind; the floor image is the one
# texture_assets writes.
_TEXTURES = (
    'Texture "floor" "spectrum" "imagemap" "string filename" ["floor.png"] '
    '"float uscale" [8] "float vscale" [8]\n'
    'Texture "checks" "spectrum" "checkerboard" "rgb tex1" [0.7 0.6 0.5] '
    '"rgb tex2" [0.15 0.2 0.3] "float uscale" [4] "float vscale" [4]\n'
    'Texture "fbm" "spectrum" "fbm" "integer octaves" [6] '
    '"float roughness" [0.6]\n'
    'Texture "wrinkled" "spectrum" "wrinkled" "integer octaves" [5] '
    '"float roughness" [0.5]\n'
    'Texture "windy" "spectrum" "windy"\n'
    'Texture "marble" "spectrum" "marble" "integer octaves" [8] '
    '"float roughness" [0.5] "float scale" [3] "float variation" [0.4]\n'
    'Texture "dots" "spectrum" "dots" "rgb inside" [0.8 0.2 0.1] '
    '"rgb outside" [0.2 0.5 0.7] "float uscale" [6] "float vscale" [6]\n'
    'Texture "uv" "spectrum" "uv" "float uscale" [2] "float vscale" [2]\n'
    'Texture "bilerp" "spectrum" "bilerp" "rgb v00" [0.8 0.1 0.1] '
    '"rgb v01" [0.1 0.8 0.1] "rgb v10" [0.1 0.1 0.8] "rgb v11" [0.7 0.7 0.2]\n'
    'Texture "mix" "spectrum" "mix" "texture tex1" "checks" '
    '"texture tex2" "dots" "float amount" [0.35]\n'
    'Texture "scale" "spectrum" "scale" "texture tex1" "floor" '
    '"rgb tex2" [0.9 0.7 0.5]\n'
)
_SPHERE_TEXTURES = ("fbm", "wrinkled", "windy", "marble", "dots", "uv",
                    "bilerp", "mix", "scale")


def _textured(name: str, family: str = "matte") -> str:
    if family == "plastic":
        return (f'Material "plastic" "texture Kd" "{name}" "rgb Ks" '
                '[0.2 0.2 0.2] "float roughness" [0.1]\n')
    return f'Material "matte" "texture Kd" "{name}"\n'


def textured_scene_text(directory: str, width=32, height=24, spp=2,
                        iterations=2, maxdepth=4, denoise=True,
                        filterradius=2, seed: int = 0, floor: int = 64,
                        sky: tuple = (64, 32), light: int = 16,
                        env: bool = True, clutter=_SPHERE_TEXTURES,
                        extra_integrator: str = "") -> str:
    """The staircase proxy with textures (the room shell's Kd an
    imagemap, the steps a checkerboard, the clutter boxes cycling through
    `clutter`, by default every other kind), an environment-mapped
    infinite light (env) and a goniometric light above the steps; the
    images are written into `directory` (texture_assets)."""
    texture_assets(directory, seed, floor, sky, light)
    body = staircase_proxy(
        shell_mat=_textured("floor"),
        stair_mat=('Material "substrate" "texture Kd" "checks" '
                   '"rgb Ks" [0.04 0.04 0.04] "float uroughness" [0.1] '
                   '"float vroughness" [0.1] "bool remaproughness" '
                   '["false"]\n'),
        clutter_mats=[_textured(t) for t in clutter])
    return scene_text(width=width, height=height, spp=spp,
                      iterations=iterations, maxdepth=maxdepth,
                      denoise=denoise, filterradius=filterradius,
                      extra_integrator=extra_integrator,
                      body=_TEXTURES + body + _image_lights(env,
                                                            "goniometric"))


def _image_lights(env: bool, light_kind: str) -> str:
    """An environment-mapped infinite light (env) and a goniometric or
    projection light pointing down from near the ceiling."""
    fov = ' "float fov" [50]' if light_kind == "projection" else ""
    return (('LightSource "infinite" "string mapname" ["sky.exr"]\n'
             if env else "")
            + "AttributeBegin\nTranslate -1 7.5 -2\nRotate 90 1 0 0\n"
            f'LightSource "{light_kind}" "rgb I" [40 38 36] '
            f'"string mapname" ["light.png"]{fov}\nAttributeEnd\n')


def textured_terrain_text(directory: str, width=1280, height=720, spp=4,
                          iterations=1, maxdepth=8, n: int = 256,
                          denoise=False, seed: int = 0, floor: int = 2048,
                          sky: tuple = (2048, 1024), light: int = 512,
                          spheres=_SPHERE_TEXTURES) -> str:
    """The terrain proxy with its floor's Kd an imagemap (floor x floor,
    uscale = vscale = 8), checkerboard clutter boxes, the matte and
    plastic spheres textured cycling through `spheres` (by default fbm,
    wrinkled, windy, marble, dots, uv, bilerp, mix and scale), an
    environment-mapped infinite light and a projection light; the images
    are written into `directory`."""
    texture_assets(directory, seed, floor, sky, light)
    names = iter(tuple(spheres) * 24)
    sphere_mats = []
    for i in range(48):  # metal and glass stay, matte and plastic textured
        fam = ("metal", "glass", "matte", "plastic")[i % 4]
        sphere_mats.append(_textured(next(names), fam)
                           if fam in ("matte", "plastic") else None)
    body = terrain_proxy(
        n=n, floor_mat=('Material "substrate" "texture Kd" "floor" '
                        '"rgb Ks" [0.05 0.05 0.05] "float uroughness" '
                        '[0.15] "float vroughness" [0.15] '
                        '"bool remaproughness" ["false"]\n'),
        sphere_mats=sphere_mats, clutter_mat=_textured("checks"))
    text = terrain_scene_text(width=width, height=height, spp=spp,
                              iterations=iterations, maxdepth=maxdepth, n=n,
                              denoise=denoise)
    head, tail = text.split("WorldBegin\n")
    return (head + "WorldBegin\n" + _TEXTURES + body
            + _image_lights(True, "projection") + "WorldEnd\n")


# ---------------------------------------------------------------------------
# Hair + subsurface scenes: a tuft of Bezier curves under two hair
# material routes (melanin concentration, and an rgb colour through
# SigmaAFromReflectance) and kdsubsurface / subsurface objects, added to
# the staircase and terrain proxies.

_KDSSS = ('Material "kdsubsurface" "rgb Kd" [{:.2f} {:.2f} {:.2f}] '
          '"float mfp" [{:.3f}]\n')
_SSS = 'Material "subsurface" "float scale" [{:.0f}]\n'


def _hair_mats(k: int) -> str:
    """Hair material k: even k by eumelanin (0.3-1.3), odd k by an rgb
    colour; beta_m, beta_n and alpha vary a little with k."""
    bm, bn = 0.2 + 0.05 * (k % 4), 0.3 + 0.05 * (k % 3)
    tail = (f'"float beta_m" [{bm:.2f}] "float beta_n" [{bn:.2f}] '
            f'"float alpha" [{1.0 + k % 3:.1f}]\n')
    if k % 2 == 0:
        return (f'Material "hair" "float eumelanin" '
                f'[{0.3 + 0.25 * (k // 2 % 5):.2f}] ' + tail)
    cols = ((0.75, 0.55, 0.35), (0.55, 0.3, 0.15), (0.85, 0.8, 0.7))
    c = cols[k // 2 % 3]
    return (f'Material "hair" "rgb color" [{c[0]:.2f} {c[1]:.2f} '
            f'{c[2]:.2f}] ' + tail)


def hair_tuft(curves: int, center, radius: float, top: float, bottom: float,
              seed: int = 0, groups: int = 8) -> str:
    """`curves` single-segment cubic Bezier curves hanging from a disc of
    `radius` around `center` (x, z) at height `top` down to about
    `bottom`, width 0.01-0.03, in `groups` runs of one hair material
    each (_hair_mats), made from `seed`."""
    rng = np.random.default_rng(seed)
    out = []
    per = -(-curves // groups)
    for i in range(curves):
        if i % per == 0:
            out.append(_hair_mats(i // per))
        a, r = rng.random() * 2 * np.pi, radius * np.sqrt(rng.random())
        x0, z0 = center[0] + r * np.cos(a), center[1] + r * np.sin(a)
        drop = (top - bottom) * (0.8 + 0.2 * rng.random())
        sway = rng.normal(0.0, 0.25, (3, 2)).cumsum(0)
        pts = [(x0, top, z0)] + [
            (x0 + sway[k, 0], top - drop * (k + 1) / 3, z0 + sway[k, 1])
            for k in range(3)]
        w = 0.01 + 0.02 * rng.random()
        p = " ".join(f"{c:.4f}" for pt in pts for c in pt)
        out.append(f'Shape "curve" "point P" [ {p} ] "float width" '
                   f'[{w:.4f}]\n')
    return "".join(out)


def _sss_spheres(spheres) -> str:
    out = []
    for mat, (x, y, z, r) in spheres:
        out.append(f"AttributeBegin\n{mat}Translate {x} {y} {z}\n"
                   f'Shape "sphere" "float radius" [{r}]\nAttributeEnd\n')
    return "".join(out)


def hair_sss_scene_text(width=1280, height=720, spp=4, iterations=2,
                        maxdepth=8, curves: int = 768, denoise=True,
                        filterradius=20, seed: int = 0) -> str:
    """The staircase proxy with a hair tuft of `curves` curves (16
    triangles each; 768 keep the scene within the fused intersector's
    16,384 triangles), three kdsubsurface and two subsurface spheres,
    and a quarter of the clutter boxes kdsubsurface."""
    body = staircase_proxy(clutter_mats=[
        _KDSSS.format(0.8, 0.55, 0.45, 0.05), None, None, None])
    body += _sss_spheres([
        (_KDSSS.format(0.85, 0.6, 0.5, 0.08), (1.6, 1.0, -1.2, 1.0)),
        (_KDSSS.format(0.5, 0.7, 0.85, 0.05), (4.0, 0.7, -2.8, 0.9)),
        (_KDSSS.format(0.9, 0.85, 0.6, 0.12), (0.2, 0.6, -4.6, 0.75)),
        (_SSS.format(20), (3.4, 0.6, 0.6, 0.75)),
        (_SSS.format(40), (-1.0, 3.6, -0.8, 0.7)),
    ])
    body += hair_tuft(curves, (2.6, -3.4), 0.7, 4.4, 1.4, seed=seed)
    return scene_text(width=width, height=height, spp=spp,
                      iterations=iterations, maxdepth=maxdepth,
                      denoise=denoise, filterradius=filterradius, body=body)


def hair_sss_terrain_text(width=1280, height=720, spp=4, iterations=1,
                          maxdepth=8, n: int = 256, curves: int = 2048,
                          denoise=True, seed: int = 0) -> str:
    """The terrain proxy with a hair tuft of `curves` curves inside the
    hall, in the camera's view, 40 of the 120 clutter boxes kdsubsurface
    and 16 of the 48 spheres subsurface."""
    body = terrain_proxy(
        n=n, sphere_mats=[_SSS.format(30), None, None],
        clutter_mats=[None, _KDSSS.format(0.8, 0.6, 0.5, 0.04), None])
    body += hair_tuft(curves, (3.5, -2.0), 0.8, 4.5, 2.0, seed=seed)
    text = terrain_scene_text(width=width, height=height, spp=spp,
                              iterations=iterations, maxdepth=maxdepth, n=n,
                              denoise=denoise)
    head, _ = text.split("WorldBegin\n")
    return head + "WorldBegin\n" + body + "WorldEnd\n"


# ---------------------------------------------------------------------------
# Volpath scenes: a homogeneous haze that the camera starts in, a
# heterogeneous smoke behind a null-material box, and FourierBSDF
# materials whose .bsdf tables the port's own writer makes.

_FOURIER = 'Material "fourier" "string bsdffile" ["{}"]\n'
FOURIER_FILES = ("lambert.bsdf", "glossy.bsdf", "transmit.bsdf")


def _bessel_i(k: int, x: float) -> float:
    """Modified Bessel function I_k(x) by the trapezoid rule on
    (1/pi) int_0^pi exp(x cos t) cos(k t) dt."""
    t = np.linspace(0.0, np.pi, 2049)
    f = np.exp(x * np.cos(t)) * np.cos(k * t)
    return float(np.sum((f[1:] + f[:-1]) * 0.5) * (t[1] - t[0]) / np.pi)


def fourier_assets(directory: str, seed: int = 0) -> None:
    """Write the volpath scenes' three SCATFUN tables into `directory`,
    made from `seed` by render/fourier.py's write_bsdf: a Lambertian
    table (3 channels), a glossy reflector (1 channel, 16 azimuthal
    orders over 32 mu nodes: a diffuse base plus a von Mises lobe around
    the mirror direction) and a dielectric (eta 1.5, 1 channel) with a
    weak diffuse reflection and a transmission lobe."""
    import os

    from .render.fourier import lambertian_file, write_bsdf

    rng = np.random.default_rng(seed)
    alb = 0.3 + 0.5 * rng.random(3)
    mu, ak = lambertian_file(alb.astype(np.float32), n_mu=16)
    write_bsdf(os.path.join(directory, FOURIER_FILES[0]), mu, ak, eta=1.0,
               n_channels=3)

    n_mu, orders = 32, 16
    mu = np.linspace(-1.0, 1.0, n_mu, dtype=np.float32)
    kappa = 6.0 + 4.0 * rng.random()
    vm = np.array([_bessel_i(k, kappa) for k in range(orders)]) \
        * np.exp(-kappa)
    vm[1:] *= 2.0  # cosine-series coefficients of exp(kappa (cos - 1))
    base, spec, width = 0.15 + 0.1 * rng.random(), 0.6, 0.25
    gl = [[np.zeros((1, 0), np.float32) for _ in range(n_mu)]
          for _ in range(n_mu)]
    for o, mo in enumerate(mu):
        for i, mi in enumerate(mu):
            if mi * mo < 0:  # reflection side
                lobe = spec * np.exp(-((abs(mi) - abs(mo)) / width) ** 2)
                a = lobe * vm
                a[0] += base / np.pi
                gl[o][i] = (a * abs(mi)).astype(np.float32)[None, :]
    write_bsdf(os.path.join(directory, FOURIER_FILES[1]), mu, gl, eta=1.0,
               n_channels=1)

    tr = [[np.zeros((1, 0), np.float32) for _ in range(n_mu)]
          for _ in range(n_mu)]
    vt = vm[:8] * 0.5
    for o, mo in enumerate(mu):
        for i, mi in enumerate(mu):
            if mi * mo < 0:
                a = np.zeros(8)
                a[0] = 0.1 / np.pi
            else:  # transmission side
                a = 0.5 * np.exp(-((abs(mi) - abs(mo)) / 0.35) ** 2) * vt
                a[0] += 0.05 / np.pi
            tr[o][i] = (a * abs(mi)).astype(np.float32)[None, :]
    write_bsdf(os.path.join(directory, FOURIER_FILES[2]), mu, tr, eta=1.5,
               n_channels=1)


def smoke_density(n: int, seed: int = 0) -> np.ndarray:
    """[n, n, n] (z, y, x) smooth noise blob with maximum 1, made from
    `seed`: a Gaussian envelope times a few random low-frequency waves."""
    rng = np.random.default_rng(seed)
    c = (np.arange(n) + 0.5) / n - 0.5
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    env = np.exp(-(x * x + y * y + z * z) / (2 * 0.22 ** 2))
    wave = np.zeros_like(env)
    for _ in range(6):
        k = rng.normal(0.0, 6.0, 3)
        wave += np.cos(k[0] * x + k[1] * y + k[2] * z
                       + rng.random() * 6.28)
    dens = env * np.clip(0.55 + 0.12 * wave, 0.0, None)
    return (dens / dens.max()).astype(np.float32)


def media_text(text: str, box, grid: int, seed: int,
               haze=(0.02, 0.04, 0.3), smoke=(0.5, 1.5, 0.0),
               boundary: str | None = "null") -> str:
    """`text` (a statpath scene) as volpath with a homogeneous haze the
    camera starts in (every shape without its own interface has it
    outside, vacuum inside) and a grid x grid x grid smoke (`seed`)
    filling the box (lo, hi), whose faces are a null material (boundary
    "null": shadow rays walk through them, K = 9 segments) or glass
    ("glass": a smoke tank; no null material, so K = 1), smoke inside,
    haze outside; boundary None leaves the smoke out.  haze/smoke:
    (sigma_a, sigma_s, g), equal across channels (grid tracking reads
    channel 0 of sigma_t)."""
    import io

    med = (
        'MakeNamedMedium "haze" "string type" ["homogeneous"] '
        f'"rgb sigma_a" [{haze[0]} {haze[0]} {haze[0]}] '
        f'"rgb sigma_s" [{haze[1]} {haze[1]} {haze[1]}] '
        f'"float g" [{haze[2]}]\n'
        'MediumInterface "" "haze"\n')
    text = text.replace('Integrator "statpath"', 'Integrator "volpath"', 1)
    head, world = text.split("LookAt", 1)
    if boundary is None:
        return head + med + "LookAt" + world
    lo, hi = box
    dens = io.StringIO()
    np.savetxt(dens, smoke_density(grid, seed).reshape(1, -1), fmt="%.3g")
    smoke_text = (
        'MakeNamedMedium "smoke" "string type" ["heterogeneous"] '
        f'"rgb sigma_a" [{smoke[0]} {smoke[0]} {smoke[0]}] '
        f'"rgb sigma_s" [{smoke[1]} {smoke[1]} {smoke[1]}] '
        f'"float g" [{smoke[2]}] '
        f'"integer nx" [{grid}] "integer ny" [{grid}] "integer nz" [{grid}] '
        f'"point p0" [{lo[0]} {lo[1]} {lo[2]}] '
        f'"point p1" [{hi[0]} {hi[1]} {hi[2]}] '
        f'"float density" [ {dens.getvalue().strip()} ]\n')
    faces = ('Material "none"\n' if boundary == "null"
             else 'Material "glass" "float index" [1.5]\n')
    smoke_text += ('AttributeBegin\nMediumInterface "smoke" "haze"\n' + faces
                   + _mesh_stmt(*_box_tris(lo, hi)) + 'AttributeEnd\n')
    world = world.replace("WorldBegin\n", "WorldBegin\n" + smoke_text, 1)
    return head + med + "LookAt" + world


def volpath_scene_text(directory: str, width=1280, height=720, spp=4,
                       iterations=1, maxdepth=8, grid: int = 128,
                       denoise=True, filterradius=20, seed: int = 0,
                       box_lift: float = 0.05) -> str:
    """The staircase proxy under volpath: the haze, a grid^3 smoke in a
    null box in the middle of the room, `box_lift` above the floor, three
    Fourier spheres (the three tables of fourier_assets, written into
    `directory`) and a quarter of the clutter boxes with the Lambertian
    table.  box_lift=0 stands the box on the floor: its null bottom face
    and the floor then lie in one plane, and which of the two a walk hits
    turns on the last ulp of the segment's origin
    (tests/test_torch_volpath_floor.py)."""
    import os

    fourier_assets(directory, seed)
    mats = [_FOURIER.format(os.path.join(directory, n))
            for n in FOURIER_FILES]
    body = staircase_proxy(clutter_mats=[mats[0], None, None, None])
    body += _sss_spheres([(mats[1], (4.0, 0.9, -2.8, 0.9)),
                          (mats[2], (0.2, 0.8, -4.6, 0.75)),
                          (mats[0], (-2.2, 1.2, -0.6, 0.9))])
    text = scene_text(width=width, height=height, spp=spp,
                      iterations=iterations, maxdepth=maxdepth,
                      denoise=denoise, filterradius=filterradius, body=body)
    return media_text(text, ((0.0, box_lift, -3.5),
                             (3.0, 3.0 + box_lift, -0.5)), grid, seed)


def volpath_terrain_text(width=1280, height=720, spp=4, iterations=1,
                         maxdepth=8, n: int = 256, grid: int = 128,
                         denoise=True, seed: int = 0,
                         boundary: str = "null") -> str:
    """The terrain proxy under volpath: the haze and a grid^3 smoke in a
    box in the middle of the hall, its faces a null material or glass
    (media_text's boundary); two-level from n = 88."""
    text = terrain_scene_text(width=width, height=height, spp=spp,
                              iterations=iterations, maxdepth=maxdepth, n=n,
                              denoise=denoise)
    return media_text(text, ((-1.5, 0.3, -1.5), (1.5, 3.3, 1.5)), grid,
                      seed, boundary=boundary)


# ---------------------------------------------------------------------------
# The realistic camera, the kd-tree and the ao / sppm integrators on the
# staircase and terrain proxies (the port's own helpers: each edits one
# directive of scene_text / terrain_scene_text).

# The staircase proxy's camera: its distance to the look-at point, on the
# stairs (LookAt 6.5 4.5 -7.5  -1 2.5 0).
STAIRCASE_FOCUS = 10.79
# The lens prescription of tests/fixtures/biconvex.dat: a symmetric
# biconvex singlet, f ~ 35 mm, with its aperture stop behind it (rows:
# curvature radius, thickness, eta, aperture diameter; millimetres).
BICONVEX = "35 4 1.5 20\n-35 1 1 20\n0 39 0 15\n"


def _with_integrator(text: str, line: str) -> str:
    """`text` with its first line (the Integrator directive) replaced."""
    return line + "\n" + text.split("\n", 1)[1]


def realistic_scene_text(lensfile: str, focus: float = STAIRCASE_FOCUS,
                         aperture: float = 4.0, **kw) -> str:
    """scene_text(**kw) seen through Camera "realistic" with the lens
    prescription `lensfile`, focused at `focus` metres."""
    text = scene_text(**kw)
    cam = 'Camera "perspective" "float fov" [55]'
    assert cam in text
    return text.replace(cam, (
        f'Camera "realistic" "string lensfile" ["{lensfile}"] '
        f'"float focusdistance" [{focus}] '
        f'"float aperturediameter" [{aperture}]'))


def kdtree_scene_text(**kw) -> str:
    """scene_text(**kw) under `Accelerator "kdtree"`."""
    return scene_text(**kw).replace("WorldBegin",
                                    'Accelerator "kdtree"\nWorldBegin', 1)


def ao_scene_text(nsamples: int = 64, cossample: bool = True,
                  terrain: bool = False, iterations: int = 1, **kw) -> str:
    """The staircase (or the terrain) under Integrator "ao"."""
    text = (terrain_scene_text(iterations=iterations, **kw) if terrain
            else scene_text(iterations=iterations, **kw))
    return _with_integrator(text, (
        f'Integrator "ao" "integer nsamples" [{nsamples}] '
        f'"bool cossample" ["{"true" if cossample else "false"}"] '
        f'"integer iterations" [{iterations}]'))


def sppm_scene_text(maxdepth: int = 5, radius: float = 0.05,
                    photons: int | None = None, iterations: int = 2,
                    **kw) -> str:
    """The staircase under Integrator "sppm"; `photons` None keeps
    photonsperiteration at its default (one per pixel, at least 4,096)."""
    line = (f'Integrator "sppm" "integer maxdepth" [{maxdepth}] '
            f'"float radius" [{radius}] "integer iterations" [{iterations}]')
    if photons is not None:
        line += f' "integer photonsperiteration" [{photons}]'
    return _with_integrator(scene_text(iterations=iterations,
                                       maxdepth=maxdepth, **kw), line)


def bdpt_scene_text(maxdepth: int = 5, iterations: int = 2,
                    terrain: bool = False, **kw) -> str:
    """The staircase (its glass sphere under the area-light panel), or the
    terrain, under Integrator "bdpt"."""
    text = (terrain_scene_text(iterations=iterations, maxdepth=maxdepth, **kw)
            if terrain else scene_text(iterations=iterations,
                                       maxdepth=maxdepth, **kw))
    return _with_integrator(text, (
        f'Integrator "bdpt" "integer maxdepth" [{maxdepth}] '
        f'"integer iterations" [{iterations}] '
        '"bool expiterations" ["false"]'))


def mlt_scene_text(bidirectional: bool = True, maxdepth: int = 5,
                   iterations: int = 1, **kw) -> str:
    """The staircase under Integrator "mlt"; bidirectional False mutates
    the unidirectional path tracer."""
    flag = "true" if bidirectional else "false"
    return _with_integrator(scene_text(iterations=iterations,
                                       maxdepth=maxdepth, **kw), (
        f'Integrator "mlt" "integer maxdepth" [{maxdepth}] '
        f'"integer iterations" [{iterations}] '
        f'"bool expiterations" ["false"] "bool bidirectional" ["{flag}"]'))


# The small closed box and the glass caustic of tests/test_bdpt.py:15-88,
# copied so that the port's tests need not import the JAX package's.

def box_scene_text(integrator: str, spp: int, maxdepth: int = 4,
                   size: int = 12) -> str:
    """A closed diffuse box with one ceiling area light."""
    out = ['Material "matte" "rgb Kd" [0.6 0.55 0.5]\n']
    walls = [
        ((-2, -0.2, -2), (2, 0.0, 2)),      # floor
        ((-2, 2.0, -2), (2, 2.2, 2)),       # ceiling
        ((-2.2, 0, -2), (-2.0, 2, 2)),      # left
        ((2.0, 0, -2), (2.2, 2, 2)),        # right
        ((-2, 0, 1.8), (2, 2, 2.0)),        # back
    ]
    for lo, hi in walls:
        v, f = _box_tris(lo, hi)
        out.append(_mesh_stmt(v, f))
    out.append(
        "AttributeBegin\n"
        'AreaLightSource "diffuse" "rgb L" [12 12 12]\n'
        'Material "matte" "rgb Kd" [0 0 0]\n'
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
        '"point P" [-0.6 1.95 -0.6  0.6 1.95 -0.6  0.6 1.95 0.6  '
        "-0.6 1.95 0.6]\n"
        "AttributeEnd\n"
    )
    return (
        f'Integrator "{integrator}" "integer maxdepth" [{maxdepth}] '
        '"integer iterations" [1] "bool expiterations" ["false"] '
        '"bool calcstats" ["false"] "bool denoiseimage" ["false"]\n'
        f'Sampler "random" "integer pixelsamples" [{spp}]\n'
        f'Film "image" "integer xresolution" [{size}] '
        f'"integer yresolution" [{size}]\n'
        "LookAt 0 1 -1.9  0 0.9 0  0 1 0\n"
        'Camera "perspective" "float fov" [70]\n'
        "WorldBegin\n" + "".join(out) + "WorldEnd\n"
    )


def glass_caustic_scene_text(integrator: str, spp: int,
                             size: int = 12) -> str:
    """A glass sphere between a small bright light and a diffuse floor:
    the caustic that NEE cannot reach through the glass."""
    out = ['Material "matte" "rgb Kd" [0.7 0.7 0.7]\n']
    v, f = _box_tris((-3, -0.2, -3), (3, 0.0, 3))  # floor
    out.append(_mesh_stmt(v, f))
    out.append(
        "AttributeBegin\n"
        'Material "glass" "float index" [1.5]\n'
        "Translate 0 1.0 0\n"
        'Shape "sphere" "float radius" [0.45]\n'
        "AttributeEnd\n"
    )
    out.append(
        "AttributeBegin\n"
        'AreaLightSource "diffuse" "rgb L" [400 400 400]\n'
        'Material "matte" "rgb Kd" [0 0 0]\n'
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
        '"point P" [-0.1 2.2 -0.1  0.1 2.2 -0.1  0.1 2.2 0.1  '
        "-0.1 2.2 0.1]\n"
        "AttributeEnd\n"
    )
    return (
        f'Integrator "{integrator}" "integer maxdepth" [5] '
        '"integer iterations" [1] "bool expiterations" ["false"] '
        '"bool calcstats" ["false"] "bool denoiseimage" ["false"]\n'
        f'Sampler "random" "integer pixelsamples" [{spp}]\n'
        f'Film "image" "integer xresolution" [{size}] '
        f'"integer yresolution" [{size}]\n'
        "LookAt 0 2.4 -2.6  0 0.2 0  0 1 0\n"
        'Camera "perspective" "float fov" [50]\n'
        "WorldBegin\n" + "".join(out) + "WorldEnd\n"
    )
