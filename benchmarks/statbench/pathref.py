"""The plain reference of the integrator: one bounce of the statistics
path tracer, in float64, from the scene text the benchmark wrote.

It reads the scene as pbrt states it (the camera's LookAt and fov, each
shape's material and area light, the triangles and spheres that
scenes/<name>.py recorded) and works out again everything that the
program derives from it: the camera's rays, the threefry draws of every
draw site, the spatial light distribution, the lights' samples, the
materials' BSDFs (Lambert, substrate's Fresnel blend, plastic, metal's
microfacet conductor, smooth glass), the closest hits, next-event
estimation with both halves of multiple importance sampling, the
continuation and Russian roulette.  It imports nothing of the program.

``replay`` takes the lanes' states before a bounce (as the program held
them: the path so far) and returns each lane's state after it; the
check (judge.py) compares that with the program's state after the same
bounce.  So the reference follows the program from one bounce to the
next; the first bounce of every sample starts from the reference's own
camera ray, which is compared with the program's.

The semantics are the port's (statmc_tpu_torch/render/integrator.py,
the JAX package's): a random sampler whose draws are addressed by
(pixel, sample, step in the sample, slot), a uniform-area triangle light
sample, the non-visible Trowbridge-Reitz sample, the conductor's Fresnel
term at the incident direction's cosine, and Russian roulette from the
fifth bounce.  Every function takes `dtype`: float64 is the reference;
the control puts the same arithmetic in bfloat16 in the program's place.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from . import reference as ref

F64 = torch.float64
INV_PI = 1.0 / math.pi
LUM = (0.212671, 0.715160, 0.072169)

# Draw-site slots of the random sampler.
SLOT_CAMERA, SLOT_LIGHT_SELECT, SLOT_LIGHT_SAMPLE = 0, 1, 2
SLOT_BSDF_NEE, SLOT_BSDF, SLOT_RR = 3, 4, 5
SLOT_BSDF_COMPONENT, SLOT_BSDF_COMPONENT_PC = 6, 7

MATTE, PLASTIC, METAL, GLASS, SUBSTRATE = "matte", "plastic", "metal", \
    "glass", "substrate"

# The spatial light distribution: voxels along the longest axis, and the
# Halton points a voxel (pbrt's SpatialLightDistribution).
SPATIAL_VOXELS, SPATIAL_POINTS = 16, 128


# -- threefry-2x32 and the random sampler's draws ----------------------

_MASK = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) on uint32 values
    held in numpy uint64 arrays."""
    k0, k1, x0, x1 = (np.asarray(v, np.uint64) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(0x1BD11BDA))
    a = (x0 + ks[0]) & _MASK
    b = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _MASK
            b = (((b << np.uint64(r)) | (b >> np.uint64(32 - r))) & _MASK) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + np.uint64(i + 1)) & _MASK
    return a, b


def fold_in(key, data):
    """(k0, k1) of key folded with `data` (jax.random.fold_in)."""
    return threefry2x32(key[0], key[1], 0, data)


def _unit(a, b):
    """The top 23 bits of a ^ b as a uniform in [0, 1)."""
    return ((a ^ b) >> np.uint64(9)).astype(np.float64) * 2.0 ** -23


class Draws:
    """The draws of lanes: key (0, base_seed) folded with each lane's
    sample index, then its pixel; a draw site folds in the step in the
    sample and the slot."""

    def __init__(self, base_seed, sample, pixel, step):
        base = (np.uint64(0), np.uint64(int(base_seed) & 0xFFFFFFFF))
        k = fold_in(base, np.asarray(sample, np.uint64))
        self.key = fold_in(k, np.asarray(pixel, np.uint64))
        self.step = np.asarray(step, np.uint64)

    def _site(self, slot):
        return fold_in(fold_in(self.key, self.step), np.uint64(slot))

    def take(self, idx):
        """The draws of lanes idx."""
        out = object.__new__(Draws)
        out.key = (self.key[0][idx], self.key[1][idx])
        out.step = self.step[idx]
        return out

    def u1(self, slot):
        s = self._site(slot)
        return _unit(*threefry2x32(s[0], s[1], 0, 0))

    def u2(self, slot):
        s = self._site(slot)
        return np.stack([_unit(*threefry2x32(s[0], s[1], 0, c))
                         for c in (0, 1)], -1)


# -- the scene as its text states it ------------------------------------

_STMT = re.compile(r"\b(AttributeBegin|AttributeEnd|Material|AreaLightSource|"
                   r"Shape|Translate|Scale|Rotate|LookAt|Camera|Integrator|"
                   r"Sampler|Film|WorldBegin|WorldEnd)\b")
_PARAM = re.compile(r'"(\w+) (\w+)"\s*\[([^\]]*)\]')


def _params(body: str) -> dict:
    out = {}
    for _, name, vals in _PARAM.findall(body):
        out[name] = [v.strip('"') for v in vals.split()]
    return out


def _remap(rough: float) -> float:
    """pbrt's RoughnessToAlpha."""
    x = math.log(max(rough, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def _material(kind: str, p: dict) -> dict:
    """One material's parameters, with pbrt's defaults."""
    def rgb(name, default):
        return [float(v) for v in p.get(name, default)]

    def num(name, default):
        return float(p[name][0]) if name in p else float(default)

    remap = p.get("remaproughness", ["true"])[0] == "true"
    m = {"kind": kind, "kd": [0.0] * 3, "ks": [0.0] * 3, "kr": [0.0] * 3,
         "kt": [0.0] * 3, "eta": [1.5] * 3, "k": [0.0] * 3, "alpha": 0.0}
    if kind == MATTE:
        m["kd"] = rgb("Kd", [0.5] * 3)
        if num("sigma", 0.0) != 0.0:
            raise ValueError("the reference has no Oren-Nayar lobe")
    elif kind == PLASTIC:
        m["kd"], m["ks"] = rgb("Kd", [0.25] * 3), rgb("Ks", [0.25] * 3)
        r = num("roughness", 0.1)
        m["alpha"] = _remap(r) if remap else r
    elif kind == METAL:
        m["eta"], m["k"] = rgb("eta", None), rgb("k", None)
        r = num("roughness", 0.01)
        if num("uroughness", r) != num("vroughness", r):
            raise ValueError("the reference has no anisotropic metal")
        r = num("uroughness", r)
        m["alpha"] = _remap(r) if remap else r
    elif kind == GLASS:
        m["kr"], m["kt"] = rgb("Kr", [1.0] * 3), rgb("Kt", [1.0] * 3)
        m["eta"] = [num("index", num("eta", 1.5))] * 3
        if num("roughness", 0.0) or num("uroughness", 0.0):
            raise ValueError("the reference has no rough glass")
    elif kind == SUBSTRATE:
        m["kd"], m["ks"] = rgb("Kd", [0.5] * 3), rgb("Ks", [0.5] * 3)
        u, v = num("uroughness", 0.1), num("vroughness", 0.1)
        if u != v:
            raise ValueError("the reference has no anisotropic substrate")
        m["alpha"] = _remap(u) if remap else u
    else:
        raise ValueError(f"the reference has no {kind!r} material")
    return m


def _rotate(deg: float, axis) -> np.ndarray:
    """pbrt's Rotate(theta, axis), 3x3."""
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    return np.array([
        [a[0] * a[0] + (1 - a[0] * a[0]) * c,
         a[0] * a[1] * (1 - c) - a[2] * s, a[0] * a[2] * (1 - c) + a[1] * s],
        [a[0] * a[1] * (1 - c) + a[2] * s,
         a[1] * a[1] + (1 - a[1] * a[1]) * c,
         a[1] * a[2] * (1 - c) - a[0] * s],
        [a[0] * a[2] * (1 - c) - a[1] * s,
         a[1] * a[2] * (1 - c) + a[0] * s,
         a[2] * a[2] + (1 - a[2] * a[2]) * c]])


def _heightfield_normals(nu: int, nv: int, z, linear) -> np.ndarray:
    """[2 (nu-1)(nv-1), 3, 3] world-space vertex normals of a heightfield's
    triangles: the area-weighted normals of the object-space grid (u, v,
    z) that the port's tessellation gives a heightfield, carried to world
    space by the inverse transpose of the shape's linear transform."""
    us, vs = np.linspace(0.0, 1.0, nu), np.linspace(0.0, 1.0, nv)
    uu, vv = np.meshgrid(us, vs, indexing="xy")
    P = np.stack([uu, vv, np.asarray(z, np.float64).reshape(nv, nu)],
                 -1).reshape(-1, 3)
    j, i = np.meshgrid(np.arange(nv - 1), np.arange(nu - 1), indexing="ij")
    a = (j * nu + i).reshape(-1)
    b = a + nu
    idx = np.stack([np.stack([a, a + 1, b + 1], -1),
                    np.stack([a, b + 1, b], -1)], 1).reshape(-1, 3)
    fn = np.cross(P[idx[:, 1]] - P[idx[:, 0]], P[idx[:, 2]] - P[idx[:, 0]])
    n = np.zeros_like(P)
    for k in range(3):
        np.add.at(n, idx[:, k], fn)
    n = n @ np.linalg.inv(linear)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-300)
    return n[idx]


class Scene:
    """Triangles [T,3,3] and spheres as Geometry recorded them, each with
    its material, area light and (a heightfield's) vertex normals, read
    from the scene text in the order of its shapes; the camera; the
    lights."""

    def __init__(self, text: str, geo, device, width: int, height: int):
        tris, centres, radii = geo.arrays()
        mats, keyed = [], {}
        tri_mat, sph_mat, tri_L, tri_n = [], [], [], []
        cur_mat, cur_L, stack = None, None, []
        ctm = np.eye(3)
        eye = look = up = None
        fov = 90.0
        parts = _STMT.split(text)
        for kw, body in zip(parts[1::2], parts[2::2]):
            if kw == "AttributeBegin":
                stack.append((cur_mat, cur_L, ctm))
            elif kw == "AttributeEnd":
                cur_mat, cur_L, ctm = stack.pop()
            elif kw in ("Scale", "Rotate"):
                v = [float(x) for x in body.split()]
                ctm = ctm @ (np.diag(v) if kw == "Scale"
                             else _rotate(v[0], v[1:4]))
            elif kw == "Material":
                kind = re.match(r'\s*"(\w+)"', body).group(1)
                key = body.strip()
                if key not in keyed:
                    keyed[key] = len(mats)
                    mats.append(_material(kind, _params(body)))
                cur_mat = keyed[key]
            elif kw == "AreaLightSource":
                p = _params(body)
                if "twosided" in p:
                    raise ValueError("the reference has no two-sided light")
                cur_L = [float(v) for v in p["L"]]
            elif kw == "Shape":
                kind = re.match(r'\s*"(\w+)"', body).group(1)
                p = _params(body)
                if kind == "trianglemesh":
                    if "N" in p:
                        raise ValueError("the reference has no shading "
                                         "normals")
                    n = len(p["indices"]) // 3
                    tri_n += [None] * n
                elif kind == "heightfield":
                    if np.linalg.det(ctm) <= 0:
                        raise ValueError("the reference has no transform "
                                         "that swaps handedness")
                    nu, nv = int(p["nu"][0]), int(p["nv"][0])
                    n = 2 * (nu - 1) * (nv - 1)
                    tri_n += list(_heightfield_normals(
                        nu, nv, [float(x) for x in p["Pz"]], ctm))
                elif kind == "sphere":
                    if cur_L is not None:
                        raise ValueError("the reference has no sphere "
                                         "lights")
                    sph_mat.append(cur_mat)
                    continue
                else:
                    raise ValueError(f"the reference has no {kind!r}")
                tri_mat += [cur_mat] * n
                tri_L += [cur_L] * n
            elif kw == "LookAt":
                v = [float(x) for x in body.split()]
                eye, look, up = v[0:3], v[3:6], v[6:9]
            elif kw == "Camera":
                fov = float(_params(body).get("fov", [90.0])[0])
        if len(tri_mat) != len(tris) or len(sph_mat) != len(radii):
            raise ValueError(
                f"the text has {len(tri_mat)} triangles and {len(sph_mat)} "
                f"spheres, the geometry {len(tris)} and {len(radii)}")
        t = lambda a, dt=F64: torch.as_tensor(np.asarray(a), dtype=dt,
                                              device=device)
        self.device = device
        self.tris = t(tris)
        self.centres, self.radii = t(centres), t(radii)
        self.tri_mat = t(tri_mat, torch.long)
        self.sph_mat = t(sph_mat, torch.long)
        light_tris = [i for i, L in enumerate(tri_L) if L is not None]
        self.light_tri = t(light_tris, torch.long)
        self.light_L = t([tri_L[i] for i in light_tris]).reshape(-1, 3)
        lid = np.full(len(tris), -1)
        lid[light_tris] = np.arange(len(light_tris))
        self.tri_light = t(lid, torch.long)
        self.tri_has_n = t([x is not None for x in tri_n], torch.bool)
        self.tri_n = t([np.zeros((3, 3)) if x is None else x
                        for x in tri_n]).reshape(-1, 3, 3)
        self.mats = mats
        self.mat = {k: t([m[k] for m in mats]).reshape(len(mats), -1)
                    for k in ("kd", "ks", "kr", "kt", "eta", "k")}
        self.mat["alpha"] = t([m["alpha"] for m in mats])
        self.mat_kind = [m["kind"] for m in mats]
        self.width, self.height = width, height
        self.camera = _camera(eye, look, up, fov, width, height)
        self._dist = None

    def to(self, dtype):
        """The scene's tables in `dtype` (the control's copy)."""
        out = object.__new__(Scene)
        out.__dict__.update(self.__dict__)
        for k in ("tris", "centres", "radii", "light_L", "tri_n"):
            setattr(out, k, getattr(self, k).to(dtype))
        out.mat = {k: v.to(dtype) for k, v in self.mat.items()}
        out._dist = None
        return out

    def light_tris(self):
        """(p0, e1, e2, normal, area) of the light triangles."""
        tl = self.tris[self.light_tri]
        e1, e2 = tl[:, 1] - tl[:, 0], tl[:, 2] - tl[:, 0]
        c = ref._cross(e1, e2)
        n = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
        return tl[:, 0], e1, e2, n, 0.5 * torch.linalg.vector_norm(c, dim=-1)


def _camera(eye, look, up, fov, W, H):
    """pbrt's perspective camera: camera-to-world (LookAt) and
    raster-to-camera, in float64."""
    eye, look, up = (np.asarray(v, np.float64) for v in (eye, look, up))
    d = (look - eye) / np.linalg.norm(look - eye)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, new_up, d, eye
    frame = W / H
    sw = ([-frame, frame, -1.0, 1.0] if frame > 1.0
          else [-1.0, 1.0, -1.0 / frame, 1.0 / frame])
    n_, f_ = 1e-2, 1000.0
    persp = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                      [0, 0, f_ / (f_ - n_), -f_ * n_ / (f_ - n_)],
                      [0, 0, 1, 0]], np.float64)
    inv_tan = 1.0 / math.tan(math.radians(fov) / 2.0)
    c2s = np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp
    s2r = (np.diag([W, H, 1.0, 1.0])
           @ np.diag([1.0 / (sw[1] - sw[0]), 1.0 / (sw[2] - sw[3]), 1.0, 1.0])
           @ np.array([[1, 0, 0, -sw[0]], [0, 1, 0, -sw[3]], [0, 0, 1, 0],
                       [0, 0, 0, 1]], np.float64))
    return c2w, np.linalg.inv(c2s) @ np.linalg.inv(s2r)


def camera_rays(sc: Scene, pixel, u):
    """(o, d) [R,3] in float64 of the camera rays through raster points
    (x + u0, y + u1) of pixels `pixel` (row-major)."""
    c2w, r2c = sc.camera
    x = (pixel % sc.width).astype(np.float64) + u[:, 0]
    y = (pixel // sc.width).astype(np.float64) + u[:, 1]
    pr = np.stack([x, y, np.zeros_like(x), np.ones_like(x)], -1)
    pc = pr @ r2c.T
    pc = pc[:, :3] / pc[:, 3:4]
    dc = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    dw = dc @ c2w[:3, :3].T
    dw /= np.linalg.norm(dw, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], dw.shape)
    return o, dw


# -- geometry --------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


class Hit:
    def __init__(self, sc: Scene, o, d, t_max):
        t, kind, idx = ref.closest_hits(o, d, t_max, sc.tris, sc.centres,
                                        sc.radii, o.dtype)
        self.found = kind > 0
        tri = kind == 1
        ti = torch.where(tri, idx, 0)
        si = torch.where(kind == 2, idx, 0)
        t0 = torch.where(self.found, t, torch.zeros_like(t))
        self.p = o + t0[:, None] * d
        tr = sc.tris[ti]
        e1, e2 = tr[:, 1] - tr[:, 0], tr[:, 2] - tr[:, 0]
        ng_t = _norm(ref._cross(e1, e2))
        # Vertex normals: interpolated at the hit's barycentrics, and the
        # geometric normal turned to their side (pbrt's triangle).
        pvec = ref._cross(d, e2)
        inv = 1.0 / torch.where(_dot(e1, pvec) != 0, _dot(e1, pvec), 1.0)
        tvec = o - tr[:, 0]
        bu = _dot(tvec, pvec) * inv
        bv = _dot(d, ref._cross(tvec, e1)) * inv
        nv = sc.tri_n[ti]
        ns_t = _norm((1 - bu - bv)[:, None] * nv[:, 0] + bu[:, None] * nv[:, 1]
                     + bv[:, None] * nv[:, 2])
        has_n = sc.tri_has_n[ti]
        ng_t = torch.where((has_n & (_dot(ng_t, ns_t) < 0))[:, None], -ng_t,
                           ng_t)
        ns_t = torch.where(has_n[:, None], ns_t, ng_t)
        if sc.radii.shape[0]:
            ng_s = _norm(self.p - sc.centres[si])
            self.ng = torch.where(tri[:, None], ng_t, ng_s)
            self.ns = torch.where(tri[:, None], ns_t, ng_s)
            mat_s = sc.sph_mat[si]
        else:
            self.ng, self.ns = ng_t, ns_t
            mat_s = torch.zeros_like(ti)
        self.mat = torch.where(tri, sc.tri_mat[ti], mat_s)
        self.light = torch.where(tri, sc.tri_light[ti], -1)
        self.light = torch.where(self.found, self.light, -1)


def _occluded(sc: Scene, o, d, t_max):
    _, kind, _ = ref.closest_hits(o, d, t_max, sc.tris, sc.centres,
                                  sc.radii, o.dtype)
    return kind > 0


def _offset(p, ng, w):
    n = torch.where((_dot(ng, w) < 0)[:, None], -ng, ng)
    scale = torch.clamp(torch.linalg.vector_norm(p, dim=-1), min=1.0)
    return p + n * (1e-4 * scale)[:, None]


def frame_of(n):
    """pbrt's CoordinateSystem around n: (t, b, n)."""
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    cond = x.abs() > y.abs()
    zero = torch.zeros_like(x)
    a = torch.sqrt(torch.where(cond, x * x + z * z, y * y + z * z))
    t = torch.where(cond[:, None], torch.stack([-z / a, zero, x / a], -1),
                    torch.stack([zero, z / a, -y / a], -1))
    return t, ref._cross(n, t), n


def _local(fr, w):
    return torch.stack([_dot(w, fr[0]), _dot(w, fr[1]), _dot(w, fr[2])], -1)


def _world(fr, w):
    return (w[:, 0:1] * fr[0] + w[:, 1:2] * fr[1] + w[:, 2:3] * fr[2])


# -- lights ------------------------------------------------------------

def _sample_tri_light(sc: Scene, lid, p, u):
    """(wi, dist, pdf, Li) of a uniform-area sample of light triangle
    `lid` seen from p."""
    p0, e1, e2, n, area = (x[lid] for x in sc.light_tris())
    su0 = torch.sqrt(torch.clamp(u[:, 0], min=0))
    b0, b1 = 1.0 - su0, u[:, 1] * su0
    pl = p0 + b1[:, None] * e1 + (1.0 - b0 - b1)[:, None] * e2
    wi = pl - p
    d2 = _dot(wi, wi)
    dist = torch.sqrt(torch.clamp(d2, min=1e-20))
    wi = wi / dist[:, None]
    cos_l = _dot(n, wi).abs()
    pdf = torch.where(cos_l > 1e-7,
                      d2 / torch.clamp(cos_l * area, min=1e-12), 0.0)
    li = torch.where((_dot(n, -wi) > 0)[:, None], sc.light_L[lid], 0.0)
    return wi, dist, pdf, li


def _radical_inverse(base: int, n: int) -> np.ndarray:
    out = np.zeros(n)
    for i in range(n):
        f, k, inv = 0.0, i, 1.0 / base
        while k:
            f += (k % base) * inv
            k //= base
            inv /= base
        out[i] = f
    return out


class LightDistribution:
    """pbrt's spatial light distribution: a grid over the scene's bounds,
    and in each voxel the lights' luminance over pdf summed over Halton
    points of the voxel, floored at a thousandth of the mean."""

    def __init__(self, sc: Scene):
        dev, dt = sc.device, sc.tris.dtype
        pts = [sc.tris.reshape(-1, 3)]
        if sc.radii.shape[0]:
            pts += [sc.centres - sc.radii[:, None],
                    sc.centres + sc.radii[:, None]]
        allp = torch.cat(pts).to(F64).cpu().numpy()
        lo, hi = allp.min(0), allp.max(0)
        diag = np.maximum(hi - lo, 1e-6)
        nv = np.maximum(1, np.round(diag / diag.max() * SPATIAL_VOXELS)
                        ).astype(int)
        S, nl = SPATIAL_POINTS, int(sc.light_tri.shape[0])
        u3 = np.stack([_radical_inverse(b, S) for b in (2, 3, 5)], -1)
        u2 = np.stack([_radical_inverse(b, S) for b in (7, 11)], -1)
        ix, iy, iz = np.meshgrid(*(np.arange(k) for k in nv), indexing="ij")
        corner = np.stack([ix, iy, iz], -1).reshape(-1, 3) / nv
        po = ((corner[:, None] + u3[None] / nv) * diag + lo).reshape(-1, 3)
        V = corner.shape[0]
        contrib = torch.zeros((V, nl), dtype=dt, device=dev)
        y = torch.tensor(LUM, dtype=dt, device=dev)
        pt = torch.as_tensor(po, dtype=dt, device=dev)
        uu = torch.as_tensor(np.tile(u2, (V, 1)), dtype=dt, device=dev)
        for li in range(nl):
            lid = torch.full((pt.shape[0],), li, dtype=torch.long,
                             device=dev)
            _, _, pdf, L = _sample_tri_light(sc, lid, pt, uu)
            c = torch.where(pdf > 0, (L @ y) / torch.clamp(pdf, min=1e-30),
                            0.0)
            contrib[:, li] = c.reshape(V, S).sum(1)
        avg = contrib.sum(-1, keepdim=True) / (S * nl)
        floor = torch.where(avg > 0, 1e-3 * avg, torch.ones_like(avg))
        contrib = torch.maximum(contrib, floor)
        self.pmf = contrib / contrib.sum(-1, keepdim=True)
        self.cdf = torch.cumsum(self.pmf, -1)
        self.cdf[:, -1] = 1.0
        self.lo = torch.as_tensor(lo, dtype=dt, device=dev)
        self.inv = torch.as_tensor(1.0 / diag, dtype=dt, device=dev)
        self.nv = torch.as_tensor(nv, device=dev)

    def _grid(self, p):
        return (p - self.lo) * self.inv * self.nv.to(p.dtype)

    def ambiguous(self, p, eps: float = 1e-4):
        """[R,3] in {-1, 0, 1}: the step to the neighbouring voxel along
        each axis where p lies within eps (in voxels) of a voxel's face,
        where float32 and float64 may pick either voxel."""
        f = self._grid(p.to(F64))
        near = (f - torch.round(f)).abs() < eps
        side = torch.where(f - torch.round(f) >= 0, -1, 1)
        return torch.where(near, side, 0)

    def sample(self, u, p, shift=None):
        g = self._grid(p).long()
        if shift is not None:
            g = g + shift
        g = torch.minimum(torch.clamp(g, min=0), self.nv - 1)
        v = (g[:, 0] * self.nv[1] + g[:, 1]) * self.nv[2] + g[:, 2]
        cdf = self.cdf[v]
        i = torch.searchsorted(cdf, u[:, None].to(cdf.dtype).contiguous(),
                               right=True)[:, 0]
        i = torch.clamp(i, max=cdf.shape[1] - 1)
        return i, self.pmf[v, i]


# -- BSDFs (local frame: z along the shading normal) ------------------

def _fr_dielectric(cos_i, eta_i, eta_t):
    entering = cos_i > 0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.clamp(cos_i, -1.0, 1.0).abs()
    sin_t = ei / et * torch.sqrt(torch.clamp(1 - ci * ci, min=0))
    ct = torch.sqrt(torch.clamp(1 - sin_t * sin_t, min=0))
    rpar = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-12)
    rper = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-12)
    return torch.where(sin_t >= 1, 1.0, 0.5 * (rpar * rpar + rper * rper))


def _fr_conductor(cos_i, eta, k):
    ci = torch.clamp(cos_i.abs(), 0, 1)[:, None]
    c2 = ci * ci
    s2 = 1 - c2
    e2, k2 = eta * eta, k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4 * e2 * k2, min=0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0))
    t2 = 2 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)


def _tr_d(wh, a):
    e = (wh[:, 0] ** 2 + wh[:, 1] ** 2) / (a * a)
    den = wh[:, 2] ** 2 + e
    return torch.where(den > 1e-16, 1.0 / (math.pi * a * a * den * den), 0.0)


def _tr_lambda(w, a):
    c2 = torch.clamp(w[:, 2] ** 2, min=1e-12)
    return 0.5 * (-1 + torch.sqrt(1 + a * a * (w[:, 0] ** 2 + w[:, 1] ** 2)
                                  / c2))


def _mf_refl_f(wo, wi, a, F):
    co, ci = wo[:, 2].abs(), wi[:, 2].abs()
    wh = wo + wi
    bad = (ci < 1e-7) | (co < 1e-7) | (_dot(wh, wh) < 1e-14)
    wh = _norm(wh)
    g = 1 / (1 + _tr_lambda(wo, a) + _tr_lambda(wi, a))
    f = F * (_tr_d(wh, a) * g / torch.clamp(4 * ci * co, min=1e-7))[:, None]
    return torch.where(bad[:, None], 0.0, f)


def _mf_pdf(wo, wi, a):
    wh = _norm(wo + wi)
    pdf = (_tr_d(wh, a) * wh[:, 2].abs()
           / torch.clamp(4 * _dot(wo, wh).abs(), min=1e-7))
    ok = (wo[:, 2] * wi[:, 2] > 0) & (_dot(wo + wi, wo + wi) > 1e-14)
    return torch.where(ok, pdf, 0.0)


def evaluate(sc: Scene, mat, wo, wi):
    """(f [R,3], pdf [R]) of the non-delta lobes of material ids `mat`."""
    M = sc.mat
    kd, ks, eta, k = M["kd"][mat], M["ks"][mat], M["eta"][mat], M["k"][mat]
    a = torch.clamp(M["alpha"][mat], min=1e-3)
    refl = wo[:, 2] * wi[:, 2] > 0
    ci, co = wi[:, 2].abs(), wo[:, 2].abs()
    lam_pdf = torch.where(refl, ci * INV_PI, 0.0)
    mf_pdf = _mf_pdf(wo, wi, a)
    wh = _norm(wo + wi)
    f = torch.zeros_like(kd)
    pdf = torch.zeros_like(ci)
    kinds = sc.mat_kind
    for mid, kind in enumerate(kinds):
        sel = mat == mid
        if not bool(sel.any()):
            continue
        if kind == MATTE:
            ff, pp = kd * INV_PI, lam_pdf
        elif kind == PLASTIC:
            F = _fr_dielectric(_dot(wi, wh), torch.ones_like(ci),
                               torch.full_like(ci, 1.5))[:, None]
            ff = kd * INV_PI + _mf_refl_f(wo, wi, a, F * ks)
            pp = 0.5 * (lam_pdf + mf_pdf)
        elif kind == METAL:
            ff = _mf_refl_f(wo, wi, a, _fr_conductor(wi[:, 2], eta, k))
            pp = mf_pdf
        elif kind == SUBSTRATE:
            diff = ((28.0 / (23.0 * math.pi)) * kd * (1 - ks)
                    * ((1 - (1 - ci * 0.5) ** 5)
                       * (1 - (1 - co * 0.5) ** 5))[:, None])
            wsum = wo + wi
            cwh = _dot(wi, wh)
            fw = torch.clamp(1 - cwh, 0, 1) ** 5
            schlick = ks + fw[:, None] * (1 - ks)
            spec = (_tr_d(wh, a) / torch.clamp(
                4 * cwh.abs() * torch.maximum(ci, co), min=1e-7))[:, None] \
                * schlick
            spec = torch.where((_dot(wsum, wsum) < 1e-14)[:, None], 0.0, spec)
            ff, pp = diff + spec, 0.5 * (lam_pdf + mf_pdf)
        else:  # smooth glass: no non-delta lobe
            ff, pp = torch.zeros_like(kd), torch.zeros_like(ci)
        f = torch.where(sel[:, None], ff, f)
        pdf = torch.where(sel, pp, pdf)
    return (torch.where(refl[:, None], f, 0.0), torch.where(refl, pdf, 0.0))


def _cosine_hemisphere(u):
    uo = 2 * u - 1
    zero = (uo[:, 0].abs() < 1e-12) & (uo[:, 1].abs() < 1e-12)
    big = uo[:, 0].abs() > uo[:, 1].abs()
    r = torch.where(big, uo[:, 0], uo[:, 1])
    theta = torch.where(
        big, (math.pi / 4) * (uo[:, 1] / torch.where(big, uo[:, 0], 1.0)),
        math.pi / 2 - (math.pi / 4) * (uo[:, 0]
                                       / torch.where(big, 1.0, uo[:, 1])))
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    z = torch.sqrt(torch.clamp(1 - x * x - y * y, min=0))
    return torch.stack([x, y, z], -1)


def _sample_wh(wo, u, a):
    """The non-visible Trowbridge-Reitz sample of an isotropic alpha."""
    phi = 2 * math.pi * u[:, 1]
    t2 = a * a * u[:, 0] / torch.clamp(1 - u[:, 0], min=1e-9)
    ct = 1 / torch.sqrt(1 + t2)
    st = torch.sqrt(torch.clamp(1 - ct * ct, min=0))
    wh = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    return torch.where((wo[:, 2] * wh[:, 2] > 0)[:, None], wh, -wh)


def sample(sc: Scene, mat, wo, u, uc):
    """(wi, f, pdf, specular, transmission) of BSDF::Sample_f."""
    M = sc.mat
    kr, kt = M["kr"][mat], M["kt"][mat]
    a = torch.clamp(M["alpha"][mat], min=1e-3)
    eta0 = M["eta"][mat][:, 0]
    kinds = sc.mat_kind
    is_k = {k: torch.zeros_like(mat, dtype=torch.bool)
            for k in (MATTE, PLASTIC, METAL, GLASS, SUBSTRATE)}
    for mid, kind in enumerate(kinds):
        is_k[kind] = is_k[kind] | (mat == mid)
    wi = _cosine_hemisphere(u)
    wi = torch.where((wo[:, 2] < 0)[:, None],
                     wi * torch.tensor([1.0, 1.0, -1.0], dtype=wi.dtype,
                                       device=wi.device), wi)
    wh = _sample_wh(wo, u, a)
    wi_mf = 2 * _dot(wo, wh)[:, None] * wh - wo
    two_lobe = is_k[PLASTIC] | is_k[SUBSTRATE]
    choose_mf = (two_lobe & (uc < 0.5)) | is_k[METAL]
    wi = torch.where(choose_mf[:, None], wi_mf, wi)

    glass = is_k[GLASS]
    cos_o = wo[:, 2]
    F = _fr_dielectric(cos_o, torch.ones_like(cos_o), eta0)
    entering = cos_o > 0
    eta_rel = torch.where(entering, 1 / eta0, eta0)
    n_loc = torch.zeros_like(wo)
    n_loc[:, 2] = torch.where(entering, 1.0, -1.0)
    ci = _dot(n_loc, wo)
    s2t = torch.clamp(1 - ci * ci, min=0) * eta_rel * eta_rel
    tir = s2t >= 1
    ct = torch.sqrt(torch.clamp(1 - s2t, min=0))
    wi_refr = -wo * eta_rel[:, None] + (eta_rel * ci - ct)[:, None] * n_loc
    refl = glass & (uc < F)
    refr = glass & (uc >= F)
    wi = torch.where(refl[:, None],
                     torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1), wi)
    wi = torch.where(refr[:, None], wi_refr, wi)

    f, pdf = evaluate(sc, mat, wo, wi)
    aci = torch.clamp(wi[:, 2].abs(), min=1e-7)
    f_r = F[:, None] * kr / aci[:, None]
    f_t = torch.where(tir[:, None], 0.0,
                      ((1 - F) * eta_rel * eta_rel)[:, None] * kt
                      / aci[:, None])
    f = torch.where(refl[:, None], f_r, torch.where(refr[:, None], f_t, f))
    pdf = torch.where(refl, torch.clamp(F, min=1e-7),
                      torch.where(refr, torch.clamp(1 - F, min=1e-7), pdf))
    return wi, f, pdf, refl | refr, refr


def _power(f, g):
    den = f * f + g * g
    return torch.where(den > 0, f * f / torch.clamp(den, min=1e-30), 0.0)


# -- one bounce -------------------------------------------------------

def replay(sc: Scene, dist: LightDistribution, draws: Draws, st: dict,
           max_depth: int, rr_start: int = 4, rr_threshold: float = 1.0,
           voxel_shift=None):
    """The lanes' states after one bounce, from their states `st` before
    it (o, d, beta, ls [R,3]; eta_scale [R]; specular [R] bool; bounce
    [R] long), every lane live.  Returns a dict of the same fields, with
    active [R] bool, and normal [R,3] (the shading normal of the hit, the
    G-buffer's at bounce 0), found [R] bool and the hit point p [R,3].
    voxel_shift [R,3]: the light distribution's voxel moved by that many
    voxels (the other reading of a hit point on a voxel's face)."""
    dt = st["o"].dtype
    dev = st["o"].device

    def u1(slot):
        return torch.as_tensor(draws.u1(slot), dtype=dt, device=dev)

    def u2(slot):
        return torch.as_tensor(draws.u2(slot), dtype=dt, device=dev)

    o, d, beta, ls = st["o"], st["d"], st["beta"], st["ls"]
    bl, spec_in = st["bounce"], st["specular"]
    inf = torch.full_like(o[:, 0], float("inf"))
    hit = Hit(sc, o, d, inf)
    found = hit.found
    L = sc.light_L
    lt = torch.clamp(hit.light, min=0)
    le = torch.where(((hit.light >= 0) & (_dot(hit.ng, -d) > 0))[:, None],
                     L[lt], 0.0)
    ls = ls + torch.where(((bl == 0) | spec_in)[:, None], beta * le, 0.0)

    shading = found & (bl < max_depth)
    ns = torch.where(found[:, None], hit.ns, 0.0)
    ns_safe = torch.where(found[:, None], hit.ns,
                          torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev))
    fr = frame_of(ns_safe)
    wo_w = -d
    wo = _local(fr, wo_w)
    mat = hit.mat
    is_glass = torch.zeros_like(found)
    for mid, kind in enumerate(sc.mat_kind):
        if kind == GLASS:
            is_glass = is_glass | (mat == mid)
    nee = shading & ~is_glass

    # Next-event estimation: the light half.
    lid, pmf = dist.sample(u1(SLOT_LIGHT_SELECT), hit.p, voxel_shift)
    wi_l, ldist, pdf_l, li = _sample_tri_light(sc, lid, hit.p,
                                               u2(SLOT_LIGHT_SAMPLE))
    f_l, pdf_sc = evaluate(sc, mat, wo, _local(fr, wi_l))
    f_l = f_l * _dot(wi_l, ns_safe).abs()[:, None]
    lvalid = (nee & (pdf_l > 0) & (li > 0).any(-1) & (f_l > 0).any(-1))
    occ = _occluded(sc, _offset(hit.p, hit.ng, wi_l), wi_l,
                    torch.where(lvalid, torch.clamp(ldist * 0.999, min=0),
                                0.0))
    li = torch.where((lvalid & ~occ)[:, None], li, 0.0)
    got_l = (li > 0).any(-1) & lvalid
    contr_l = f_l * li / torch.clamp(pdf_l, min=1e-30)[:, None]
    w_l = _power(pdf_l, pdf_sc)

    # The BSDF half.
    wi_b, f_b, pdf_b, spec_b, _ = sample(sc, mat, wo, u2(SLOT_BSDF_NEE),
                                         u1(SLOT_BSDF_COMPONENT))
    wi2 = _world(fr, wi_b)
    f_b = f_b * _dot(wi2, ns_safe).abs()[:, None]
    hit2 = Hit(sc, _offset(hit.p, hit.ng, wi2), wi2,
               torch.where(nee, inf, 0.0))
    same = hit2.found & (hit2.light == lid)
    li_b = torch.where((same & (_dot(hit2.ng, -wi2) > 0))[:, None], L[lid],
                       0.0)
    _, _, _, nl, area = sc.light_tris()
    d2 = _dot(hit2.p - hit.p, hit2.p - hit.p)
    cos2 = _dot(hit2.ng, wi2).abs()
    lpdf_b = torch.where(cos2 > 1e-7,
                         d2 / torch.clamp(cos2 * area[lid], min=1e-12), 0.0)
    w_b = torch.where(spec_b, 1.0, _power(pdf_b, lpdf_b))
    bvalid = (nee & (pdf_b > 0) & (f_b > 0).any(-1)
              & (spec_b | (lpdf_b > 0)))
    got_b = (li_b > 0).any(-1) & bvalid
    contr_b = f_b * li_b / torch.clamp(pdf_b, min=1e-30)[:, None]
    ld = (torch.where(got_l[:, None], contr_l * w_l[:, None], 0.0)
          + torch.where(got_b[:, None], contr_b * w_b[:, None], 0.0))
    ld = ld / torch.clamp(pmf, min=1e-30)[:, None]
    ls = ls + torch.where(nee[:, None], beta * ld, 0.0)

    # The continuation.
    wi_c, f_c, pdf_c, spec_c, trans_c = sample(
        sc, mat, wo, u2(SLOT_BSDF), u1(SLOT_BSDF_COMPONENT_PC))
    wi_cw = _world(fr, wi_c)
    w_c = (f_c * _dot(wi_cw, ns_safe).abs()[:, None]
           / torch.clamp(pdf_c, min=1e-30)[:, None])
    dead = ~shading | (f_c <= 0).all(-1) | (pdf_c <= 0)
    beta = torch.where(dead[:, None], beta, beta * w_c)
    eta2 = sc.mat["eta"][mat][:, 0] ** 2
    entering = _dot(wo_w, hit.ng) > 0
    eta_mul = torch.where(spec_c & trans_c,
                          torch.where(entering, eta2,
                                      1 / torch.clamp(eta2, min=1e-9)), 1.0)
    eta_scale = st["eta_scale"] * torch.where(dead, 1.0, eta_mul)
    active = found & (bl < max_depth) & ~dead

    # Russian roulette.
    survival = (beta * eta_scale[:, None]).max(-1).values
    q = torch.clamp(1 - survival, min=0.05)
    do_rr = (bl > rr_start - 1) & active & (survival < rr_threshold)
    killed = do_rr & (u1(SLOT_RR) < q)
    active = active & ~killed
    beta = torch.where((do_rr & ~killed)[:, None],
                       beta / torch.clamp(1 - q, min=1e-6)[:, None], beta)
    return {"o": _offset(hit.p, hit.ng, wi_cw), "d": wi_cw, "beta": beta,
            "ls": ls, "eta_scale": eta_scale, "specular": spec_c,
            "active": active, "normal": ns, "found": found, "p": hit.p}
