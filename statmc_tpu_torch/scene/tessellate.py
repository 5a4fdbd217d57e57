# Copied from statmc_tpu/scene/tessellate.py (numpy host code; behaviour unchanged).
"""Shape tessellation: every non-triangle pbrt shape becomes triangles.

The reference implements each shape as an analytic Shape subclass with
its own Intersect (src/shapes/{disk,cylinder,cone,paraboloid,
hyperboloid,curve,heightfield,loopsubdiv,nurbs}.cpp).  Per-shape
analytic intersectors are virtual-dispatch-and-branch machinery a TPU
wavefront cannot use; here every shape is tessellated at scene-build
time into the flat triangle tables the fused MXU intersector consumes
(accel/fused.py), with analytic vertex normals so shading quality
matches the quadric forms.  Spheres stay analytic (scene/build.py) --
they are the only shape whose silhouette visibly suffers from
tessellation in the bundled scenes (glass balls).

pbrt parameterizations are preserved exactly: disk (height, radius,
innerradius, phimax; disk.cpp:48), cylinder (radius, zmin, zmax,
phimax; cylinder.cpp:47), cone (radius, height, phimax; cone.cpp:47),
paraboloid (radius, zmin, zmax, phimax; paraboloid.cpp:47),
hyperboloid (p1, p2, phimax; hyperboloid.cpp:47), heightfield (nu, nv,
Pz; heightfield.cpp:36 -- pbrt itself triangulates it), loopsubdiv
(nlevels, indices, P; loopsubdiv.cpp:128 -- pbrt itself refines to a
triangle mesh), curve (type flat/cylinder/ribbon, 4 bezier control
points, width/width0/width1; curve.cpp:70), nurbs (nu/nv, uorder/
vorder, uknots/vknots, P/Pw; nurbs.cpp:238 -- pbrt also tessellates).
"""
from __future__ import annotations

import numpy as np

# Tessellation densities: quadrics are smooth and low-curvature in the
# bundled scenes; these match pbrt's own heightfield/nurbs grid usage.
QUADRIC_SLICES = 64  # around phi
QUADRIC_STACKS = 16  # along the sweep axis
CURVE_SEGMENTS = 8  # bezier subdivisions per curve shape


def _grid_mesh(fn, nu: int, nv: int, wrap_u: bool = False):
    """Tessellate a parametric surface fn(u, v) -> (p, n) over [0,1]^2.

    Returns (P [V,3], N [V,3], UV [V,2], idx [F,3]) with V=(nu+1)*(nv+1)
    vertices (u wraps are duplicated so UVs stay clean)."""
    us = np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    P, N = fn(uu.reshape(-1), vv.reshape(-1))
    UV = np.stack([uu.reshape(-1), vv.reshape(-1)], axis=-1)
    idx = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = (i + 1) * (nv + 1) + j
            idx.append((a, b, b + 1))
            idx.append((a, b + 1, a + 1))
    return (P.astype(np.float32), N.astype(np.float32),
            UV.astype(np.float32), np.asarray(idx, np.int32))


def disk(params):
    h = float(params.find_one("height", 0.0))
    r = float(params.find_one("radius", 1.0))
    ri = float(params.find_one("innerradius", 0.0))
    phimax = np.radians(float(params.find_one("phimax", 360.0)))

    def fn(u, v):
        phi = u * phimax
        rad = r + (ri - r) * v  # v=0 outer rim, v=1 inner (pbrt disk.cpp:63)
        p = np.stack([rad * np.cos(phi), rad * np.sin(phi),
                      np.full_like(phi, h)], -1)
        n = np.broadcast_to(np.array([0.0, 0.0, 1.0]), p.shape).copy()
        return p, n

    return _grid_mesh(fn, QUADRIC_SLICES, 1)


def cylinder(params):
    r = float(params.find_one("radius", 1.0))
    z0 = float(params.find_one("zmin", -1.0))
    z1 = float(params.find_one("zmax", 1.0))
    phimax = np.radians(float(params.find_one("phimax", 360.0)))

    def fn(u, v):
        phi = u * phimax
        z = z0 + v * (z1 - z0)
        p = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
        n = np.stack([np.cos(phi), np.sin(phi), np.zeros_like(phi)], -1)
        return p, n

    return _grid_mesh(fn, QUADRIC_SLICES, QUADRIC_STACKS)


def cone(params):
    r = float(params.find_one("radius", 1.0))
    h = float(params.find_one("height", 1.0))
    phimax = np.radians(float(params.find_one("phimax", 360.0)))

    def fn(u, v):
        phi = u * phimax
        rad = r * (1.0 - v)
        p = np.stack([rad * np.cos(phi), rad * np.sin(phi), v * h], -1)
        # dpdu x dpdv normal of the cone surface (cone.cpp:113).
        n = np.stack([np.cos(phi) * h, np.sin(phi) * h,
                      np.full_like(phi, r)], -1)
        n = n / np.linalg.norm(n, axis=-1, keepdims=True)
        return p, n

    return _grid_mesh(fn, QUADRIC_SLICES, QUADRIC_STACKS)


def paraboloid(params):
    r = float(params.find_one("radius", 1.0))
    z0 = float(params.find_one("zmin", 0.0))
    z1 = float(params.find_one("zmax", 1.0))
    phimax = np.radians(float(params.find_one("phimax", 360.0)))

    def fn(u, v):
        phi = u * phimax
        z = z0 + v * (z1 - z0)
        rad = r * np.sqrt(np.maximum(z / max(z1, 1e-12), 0.0))
        p = np.stack([rad * np.cos(phi), rad * np.sin(phi), z], -1)
        # z = zmax/r^2 * rad^2 -> gradient (2 k x, 2 k y, -1), k=z1/r^2
        k = z1 / (r * r)
        n = np.stack([2 * k * p[..., 0], 2 * k * p[..., 1],
                      -np.ones_like(phi)], -1)
        n = -n / np.linalg.norm(n, axis=-1, keepdims=True)
        return p, n

    return _grid_mesh(fn, QUADRIC_SLICES, QUADRIC_STACKS)


def hyperboloid(params):
    p1 = np.asarray(params.find_one("p1", [0.0, 0.0, 0.0]), np.float32)
    p2 = np.asarray(params.find_one("p2", [1.0, 1.0, 1.0]), np.float32)
    phimax = np.radians(float(params.find_one("phimax", 360.0)))

    def fn(u, v):
        phi = u * phimax
        # Sweep the segment p1->p2 around z (hyperboloid.cpp:125).
        pt = p1[None] + v[..., None] * (p2 - p1)[None]
        x = pt[..., 0] * np.cos(phi) - pt[..., 1] * np.sin(phi)
        y = pt[..., 0] * np.sin(phi) + pt[..., 1] * np.cos(phi)
        p = np.stack([x, y, pt[..., 2]], -1)
        return p, None

    P, _, UV, idx = _grid_mesh(
        lambda u, v: (fn(u, v)[0],
                      np.zeros(u.shape + (3,))), QUADRIC_SLICES,
        QUADRIC_STACKS)
    return P, _vertex_normals(P, idx), UV, idx


def heightfield(params):
    nu = int(params.find_one("nu", 2))
    nv = int(params.find_one("nv", 2))
    z = np.asarray(params.find_floats("Pz"), np.float32).reshape(nv, nu)
    us = np.linspace(0.0, 1.0, nu)
    vs = np.linspace(0.0, 1.0, nv)
    uu, vv = np.meshgrid(us, vs, indexing="xy")
    P = np.stack([uu, vv, z], -1).reshape(-1, 3).astype(np.float32)
    UV = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for j in range(nv - 1):
        for i in range(nu - 1):
            a = j * nu + i
            b = a + nu
            idx.append((a, a + 1, b + 1))
            idx.append((a, b + 1, b))
    idx = np.asarray(idx, np.int32)
    return P, _vertex_normals(P, idx), UV, idx


def _vertex_normals(P, idx):
    """Area-weighted vertex normals for a triangulated surface."""
    n = np.zeros_like(P)
    fn = np.cross(P[idx[:, 1]] - P[idx[:, 0]], P[idx[:, 2]] - P[idx[:, 0]])
    for k in range(3):
        np.add.at(n, idx[:, k], fn)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(norm, 1e-12)).astype(np.float32)


def loopsubdiv(params):
    """Loop subdivision surface, refined like pbrt's loopsubdiv.cpp
    (beta weights; boundary handled with the simple interior rule since
    the bundled scenes use closed meshes)."""
    levels = int(params.find_one("levels", params.find_one("nlevels", 3)))
    P = np.asarray(params.find_floats("P"), np.float32).reshape(-1, 3)
    idx = np.asarray(params.find_ints("indices"), np.int32).reshape(-1, 3)
    for _ in range(max(0, levels)):
        P, idx = _loop_once(P, idx)
    return P.astype(np.float32), _vertex_normals(P, idx), None, idx


def _loop_once(P, idx):
    V = P.shape[0]
    edge_mid = {}
    new_pts = list(P)
    # adjacency
    neighbors = [set() for _ in range(V)]
    for f in idx:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            neighbors[a].add(int(b))
            neighbors[b].add(int(a))
    # edge -> opposite vertices
    edge_opp = {}
    for f in idx:
        for a, b, c in ((f[0], f[1], f[2]), (f[1], f[2], f[0]),
                        (f[2], f[0], f[1])):
            key = (min(int(a), int(b)), max(int(a), int(b)))
            edge_opp.setdefault(key, []).append(int(c))

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key in edge_mid:
            return edge_mid[key]
        opp = edge_opp.get(key, [])
        if len(opp) == 2:
            p = 0.375 * (P[key[0]] + P[key[1]]) + 0.125 * (
                P[opp[0]] + P[opp[1]])
        else:  # boundary edge
            p = 0.5 * (P[key[0]] + P[key[1]])
        edge_mid[key] = len(new_pts)
        new_pts.append(p)
        return edge_mid[key]

    # even (old) vertex update
    for v in range(V):
        ring = sorted(neighbors[v])
        n = len(ring)
        if n == 0:
            continue
        if n == 3:
            beta = 3.0 / 16.0
        else:
            beta = 3.0 / (8.0 * n)
        new_pts[v] = (1 - n * beta) * P[v] + beta * np.sum(
            P[ring], axis=0)

    faces = []
    for f in idx:
        a, b, c = int(f[0]), int(f[1]), int(f[2])
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
    return np.asarray(new_pts, np.float32), np.asarray(faces, np.int32)


def _bezier_eval(cp, t):
    """Cubic bezier point+tangent; cp [4,3], t [...]."""
    t = t[..., None]
    mt = 1.0 - t
    p = (mt ** 3 * cp[0] + 3 * mt ** 2 * t * cp[1]
         + 3 * mt * t ** 2 * cp[2] + t ** 3 * cp[3])
    d = (3 * mt ** 2 * (cp[1] - cp[0]) + 6 * mt * t * (cp[2] - cp[1])
         + 3 * t ** 2 * (cp[3] - cp[2]))
    return p, d


def curve(params):
    """Bezier curve -> thin two-sided ribbon strip.

    The reference intersects flat curves facing the ray
    (curve.cpp:148); a tessellated ribbon with a stable frame is the
    standard rasterizer approximation and is accurate for hair-width
    curves (the ribbon's orientation error is O(width))."""
    cps = np.asarray(params.find_floats("P"), np.float32).reshape(-1, 3)
    w0 = float(params.find_one("width0", params.find_one("width", 1.0)))
    w1 = float(params.find_one("width1", params.find_one("width", 1.0)))
    n_seg = (cps.shape[0] - 1) // 3  # chained cubic segments
    n_seg = max(n_seg, 1)
    P_out, N_out, UV_out, idx = [], [], [], []
    for s in range(n_seg):
        cp = cps[3 * s : 3 * s + 4]
        if cp.shape[0] < 4:
            break
        ts = np.linspace(0.0, 1.0, CURVE_SEGMENTS + 1)
        p, d = _bezier_eval(cp, ts)
        tmag = np.linalg.norm(d, axis=-1, keepdims=True)
        tang = d / np.maximum(tmag, 1e-12)
        # Stable frame: pick the world axis least aligned with the
        # mean tangent, propagate side vectors along the strip.
        ref = np.eye(3)[np.argmin(np.abs(tang.mean(axis=0)))]
        side = np.cross(tang, ref)
        side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True),
                           1e-12)
        u_global = (np.arange(CURVE_SEGMENTS + 1) / CURVE_SEGMENTS
                    + s) / n_seg
        w = 0.5 * (w0 + (w1 - w0) * u_global)
        base = len(P_out)
        for i in range(CURVE_SEGMENTS + 1):
            P_out.append(p[i] - side[i] * w[i])
            P_out.append(p[i] + side[i] * w[i])
            nrm = np.cross(side[i], tang[i])
            N_out.append(nrm)
            N_out.append(nrm)
            UV_out.append((u_global[i], 0.0))
            UV_out.append((u_global[i], 1.0))
        for i in range(CURVE_SEGMENTS):
            a = base + 2 * i
            idx.append((a, a + 1, a + 3))
            idx.append((a, a + 3, a + 2))
    return (np.asarray(P_out, np.float32), np.asarray(N_out, np.float32),
            np.asarray(UV_out, np.float32), np.asarray(idx, np.int32))


def _bspline_basis(knots, order, i, u):
    """Cox-de Boor recursion for one basis function value."""
    if order == 1:
        return 1.0 if knots[i] <= u < knots[i + 1] else 0.0
    b = 0.0
    d1 = knots[i + order - 1] - knots[i]
    if d1 > 0:
        b += (u - knots[i]) / d1 * _bspline_basis(knots, order - 1, i, u)
    d2 = knots[i + order] - knots[i + 1]
    if d2 > 0:
        b += (knots[i + order] - u) / d2 * _bspline_basis(
            knots, order - 1, i + 1, u)
    return b


def nurbs(params):
    nu = int(params.find_one("nu", 0))
    nv = int(params.find_one("nv", 0))
    uorder = int(params.find_one("uorder", 4))
    vorder = int(params.find_one("vorder", 4))
    uknots = np.asarray(params.find_floats("uknots"), np.float64)
    vknots = np.asarray(params.find_floats("vknots"), np.float64)
    pw = params.find_floats("Pw")
    if pw is not None:
        cp = np.asarray(pw, np.float64).reshape(nv, nu, 4)
    else:
        cp3 = np.asarray(params.find_floats("P"), np.float64).reshape(
            nv, nu, 3)
        cp = np.concatenate([cp3, np.ones((nv, nu, 1))], -1)
    u0, u1 = uknots[uorder - 1], uknots[nu]
    v0, v1 = vknots[vorder - 1], vknots[nv]
    NU, NV = 32, 32
    P = np.zeros((NU + 1, NV + 1, 3), np.float32)
    for a in range(NU + 1):
        u = u0 + (u1 - u0) * (a / NU) * 0.999999
        bu = np.array([_bspline_basis(uknots, uorder, i, u)
                       for i in range(nu)])
        for b in range(NV + 1):
            v = v0 + (v1 - v0) * (b / NV) * 0.999999
            bv = np.array([_bspline_basis(vknots, vorder, j, v)
                           for j in range(nv)])
            acc = np.einsum("j,i,jik->k", bv, bu, cp)
            P[a, b] = (acc[:3] / max(acc[3], 1e-12)).astype(np.float32)
    uu, vv = np.meshgrid(np.linspace(0, 1, NU + 1),
                         np.linspace(0, 1, NV + 1), indexing="ij")
    UV = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)
    Pf = P.reshape(-1, 3)
    idx = []
    for i in range(NU):
        for j in range(NV):
            a = i * (NV + 1) + j
            b = (i + 1) * (NV + 1) + j
            idx.append((a, b, b + 1))
            idx.append((a, b + 1, a + 1))
    idx = np.asarray(idx, np.int32)
    return Pf, _vertex_normals(Pf, idx), UV, idx


TESSELLATORS = {
    "disk": disk,
    "cylinder": cylinder,
    "cone": cone,
    "paraboloid": paraboloid,
    "hyperboloid": hyperboloid,
    "heightfield": heightfield,
    "loopsubdiv": loopsubdiv,
    "curve": curve,
    "nurbs": nurbs,
}


def tessellate_shape(sd):
    """ShapeDesc -> (P, N, UV, idx) in object space, or None."""
    fn = TESSELLATORS.get(sd.shape_type)
    if fn is None:
        return None
    out = fn(sd.params)
    if out is None or out[0].shape[0] == 0:
        return None
    return out
