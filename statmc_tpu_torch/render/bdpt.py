"""Bidirectional path tracing (port of statmc_tpu/render/bdpt.py).

pbrt's BDPTIntegrator (src/integrators/bdpt.cpp), as the JAX package
re-derives it:

* a camera and a light subpath, two bounded random walks that record
  each vertex's forward and reverse AREA densities (Vertex::
  ConvertDensity), as SoA tensors [P, V, ...];
* every (s, t) strategy with s + t <= maxdepth + 2: s = 0 (the camera
  path hits a light), s = 1 (light resampling, the NEE analogue), s >= 2
  (vertex-vertex connections) and t = 1 (a light vertex connects to the
  lens and splats to the pixel it lands in);
* pbrt's recursive MIS weight over all strategies, from the stored
  densities with the endpoint overrides substituted per (s, t).

One lane is one pixel sample, and every strategy runs over all lanes,
masked, as in the JAX package.  The t = 1 splats, many lanes into one
pixel, are summed by ``serial_scatter_add`` in lane order, as the JAX
package's serial scatter sums them, with no floating-point atomics: two
runs on the card agree bit for bit.

Behaviours of the JAX package that the port mirrors (ROADMAP.md section
C): the light subpath never starts at an infinite light (escaped camera
rays still make an infinite-light vertex, and the MIS denominators drop
the alternatives that would start there); goniometric and projection
lights emit as point lights; the camera's importance (``_pdf_we``,
``_sample_wi_camera``) is the perspective pinhole's whatever the camera
model; and shading goes through ``bsdf.gather_materials`` / ``evaluate``
/ ``sample`` alone: no medium, no BSSRDF probe chain (a subsurface
material is its smooth dielectric interface).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import spans
from ..core import math as cm
from ..core import rng as crng
from ..core import spectrum as spec
from ..scene import build as sb
from . import bsdf as B
from . import camera as CAM
from . import lights as LT
from .alt_integrators import AltRenderer
from .integrator import _offset_origin
from .intersect import intersect_scene, occluded_scene
from .lightdistrib import sample_light_id
from .sppm import _light_power_pmf, pick_lights

# Vertex type tags.
VT_NONE = 0
VT_CAMERA = 1
VT_LIGHT = 2
VT_SURFACE = 3
# Set to a list to record, for every t = 1 strategy, the lanes that splat
# and the distinct pixels they land on.
splat_stats = None


def serial_scatter_add(out, idx, val):
    """out[idx[j]] += val[j] for every lane j, in lane order per index, as
    a serial scatter-add sums them: the lanes are stably sorted by index,
    and the k-th lane of every index is added in pass k, where no index
    repeats.  Deterministic on the card (no atomics)."""
    n = idx.numel()
    if n == 0:
        return out
    order = torch.argsort(idx, stable=True)
    si = idx[order]
    pos = torch.arange(n, device=idx.device)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = si[1:] != si[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.argsort(rank, stable=True)
    lanes = order[by_rank]
    counts = torch.bincount(rank).tolist()
    a = 0
    for c in counts:
        sel = lanes[a:a + c]
        ix = idx[sel]
        out[ix] = out[ix] + val[sel]
        a += c
    return out


def _remap0(x):
    """pbrt bdpt.cpp:remap0 -- treat 0 pdfs as 1 in MIS ratios."""
    return torch.where(x > 0, x, 1.0)


def _convert_density(pdf_dir, from_p, to_p, to_ng, to_on_surface):
    """Solid-angle pdf at from_p -> area density at to_p
    (Vertex::ConvertDensity)."""
    w = to_p - from_p
    d2 = torch.sum(w * w, -1)
    inv_d2 = torch.where(d2 > 0, 1.0 / torch.clamp(d2, min=1e-20), 0.0)
    cosw = torch.abs(torch.sum(to_ng * w, -1)) * cm.sqrt(inv_d2)
    return pdf_dir * inv_d2 * torch.where(to_on_surface, cosw, 1.0)


def _tri_rows(scene, light_id):
    """Triangle index of each lane's light: other kinds' prims may index
    past the table, and the JAX package's gathers clamp."""
    return torch.clamp(scene.light_prim[light_id], 0,
                       scene.tri_p0.shape[0] - 1).long()


def _sph_rows(scene, light_id):
    return torch.clamp(scene.light_prim[light_id], 0,
                       scene.sph_center.shape[0] - 1).long()


def _emit_sample(scene, light_id, u_pos, u_dir):
    """BDPT's Sample_Le over lanes: (o, d, Le, ng, pdf_pos, pdf_dir,
    delta_pos) for point, spot (with its falloff), area triangle, area
    sphere and distant lights; goniometric and projection lights emit as
    point lights, infinite lights emit nothing.  (render/sppm.py's
    sample_le differs: no spot falloff, and beta instead of densities.)"""
    li = light_id.long()
    kind = scene.light_kind[li]
    Lrad = scene.light_L[li]
    pos = scene.light_pos[li]
    par = scene.light_params[li]
    aux = scene.light_aux[li]
    R = li.shape[0]
    dev = li.device

    # Point (+gonio/proj): uniform sphere, pdfPos delta, pdfDir 1/4pi.
    z = 1.0 - 2.0 * u_dir[:, 0]
    r_ = cm.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u_dir[:, 1]
    d_sph = torch.stack([r_ * torch.cos(phi), r_ * torch.sin(phi), z], -1)
    o = pos
    d = d_sph
    Le = Lrad
    ng = d_sph
    pdf_pos = torch.ones((R,), device=dev)
    pdf_dir = torch.full((R,), 1.0 / (4.0 * math.pi), device=dev)
    delta_pos = torch.ones((R,), dtype=torch.bool, device=dev)

    # Spot: uniform cone with pbrt's falloff (spot.cpp:Sample_Le).
    is_spot = kind == sb.LIGHT_SPOT
    cos_total = par[:, 0]
    zc = 1.0 - u_dir[:, 0:1] * (1.0 - cos_total[:, None])
    rc = cm.sqrt(torch.clamp(1.0 - zc * zc, min=0.0))
    frame_s = B.ShadingFrame.from_normal(aux)
    d_cone = frame_s.to_world(torch.cat(
        [rc * torch.cos(phi)[:, None], rc * torch.sin(phi)[:, None], zc], -1))
    pdf_cone = 1.0 / (2.0 * math.pi * torch.clamp(1.0 - cos_total, min=1e-9))
    cos_falloff = par[:, 1]
    cs = cm.dot(d_cone, aux)
    delta_f = torch.clamp((cs - cos_total) / torch.clamp(
        cos_falloff - cos_total, min=1e-9), 0, 1)
    df2 = delta_f * delta_f
    falloff = torch.where(cs < cos_total, 0.0,
                          torch.where(cs > cos_falloff, 1.0, df2 * df2))
    d = torch.where(is_spot[:, None], d_cone, d)
    Le = torch.where(is_spot[:, None], Lrad * falloff[:, None], Le)
    ng = torch.where(is_spot[:, None], aux, ng)
    pdf_dir = torch.where(is_spot, pdf_cone, pdf_dir)

    # Area triangle: uniform point, cosine direction (diffuse.cpp).
    if scene.tri_p0.shape[0] > 0:
        is_tri = kind == sb.LIGHT_AREA_TRI
        t = _tri_rows(scene, li)
        p0, e1, e2 = scene.tri_p0[t], scene.tri_e1[t], scene.tri_e2[t]
        su = cm.sqrt(torch.clamp(u_pos[:, 0], min=1e-12))
        b0 = 1.0 - su
        b1 = u_pos[:, 1] * su
        p_tri = p0 + e1 * b0[:, None] + e2 * b1[:, None]
        n_tri = cm.normalize(cm.cross(e1, e2))
        area = torch.clamp(scene.light_area[li], min=1e-12)
        frame_t = B.ShadingFrame.from_normal(n_tri)
        rr = cm.sqrt(torch.clamp(u_dir[:, 0], min=0.0))
        cz = cm.sqrt(torch.clamp(1.0 - u_dir[:, 0], min=0.0))
        d_cos = frame_t.to_world(torch.stack(
            [rr * torch.cos(phi), rr * torch.sin(phi), cz], -1))
        o = torch.where(is_tri[:, None], p_tri + n_tri * 1e-4, o)
        d = torch.where(is_tri[:, None], d_cos, d)
        Le = torch.where(is_tri[:, None], Lrad, Le)
        ng = torch.where(is_tri[:, None], n_tri, ng)
        pdf_pos = torch.where(is_tri, 1.0 / area, pdf_pos)
        pdf_dir = torch.where(is_tri, torch.clamp(cz, min=0.0) / math.pi,
                              pdf_dir)
        delta_pos = delta_pos & ~is_tri

    # Area sphere: uniform surface point, cosine direction.
    if scene.sph_center.shape[0] > 0:
        is_sph = kind == sb.LIGHT_AREA_SPH
        si = _sph_rows(scene, li)
        p_s = scene.sph_center[si] + d_sph * scene.sph_radius[si][:, None]
        # The emission normal carries the ReverseOrientation sign.
        n_s = d_sph
        if scene.sph_flip is not None:
            n_s = n_s * scene.sph_flip[si][:, None]
        frame_sp = B.ShadingFrame.from_normal(n_s)
        rr = cm.sqrt(torch.clamp(u_pos[:, 0], min=0.0))
        phi2 = 2.0 * math.pi * u_pos[:, 1]
        cz2 = cm.sqrt(torch.clamp(1.0 - u_pos[:, 0], min=0.0))
        d_cos2 = frame_sp.to_world(torch.stack(
            [rr * torch.cos(phi2), rr * torch.sin(phi2), cz2], -1))
        area_s = torch.clamp(scene.light_area[li], min=1e-12)
        o = torch.where(is_sph[:, None], p_s + n_s * 1e-4, o)
        d = torch.where(is_sph[:, None], d_cos2, d)
        Le = torch.where(is_sph[:, None], Lrad, Le)
        ng = torch.where(is_sph[:, None], n_s, ng)
        pdf_pos = torch.where(is_sph, 1.0 / area_s, pdf_pos)
        pdf_dir = torch.where(is_sph, torch.clamp(cz2, min=0.0) / math.pi,
                              pdf_dir)
        delta_pos = delta_pos & ~is_sph

    # Distant: a disk outside the scene, parallel rays (distant.cpp:
    # pdfPos = 1/(pi R^2), pdfDir delta).  light_pos holds the direction
    # toward the light.
    is_dist = kind == sb.LIGHT_DISTANT
    wdir = pos
    wr = scene.world_radius
    frame_d = B.ShadingFrame.from_normal(wdir)
    rd = cm.sqrt(torch.clamp(u_pos[:, 0], min=0.0)) * wr
    phid = 2.0 * math.pi * u_pos[:, 1]
    o_dist = scene.world_center + frame_d.to_world(torch.stack(
        [rd * torch.cos(phid), rd * torch.sin(phid), torch.zeros_like(rd)],
        -1)) + wdir * (2.0 * wr)
    o = torch.where(is_dist[:, None], o_dist, o)
    d = torch.where(is_dist[:, None], -wdir, d)
    Le = torch.where(is_dist[:, None], Lrad, Le)
    ng = torch.where(is_dist[:, None], -wdir, ng)
    pdf_pos = torch.where(is_dist, _disk_pdf(scene), pdf_pos)
    pdf_dir = torch.where(is_dist, 1.0, pdf_dir)

    ok = kind != sb.LIGHT_INFINITE
    Le = torch.where(ok[:, None], Le, 0.0)
    return o, d, Le, ng, pdf_pos, pdf_dir, delta_pos


def _pdf_le_dir(scene, light_id, ng_light, w):
    """pdfDir of a light emitting direction w from a point with normal
    ng_light (Light::Pdf_Le's direction part)."""
    li = light_id.long()
    kind = scene.light_kind[li]
    cosw = cm.dot(ng_light, w)
    pdf = torch.full(li.shape, 1.0 / (4.0 * math.pi), device=li.device)
    cos_total = scene.light_params[li][..., 0]
    pdf = torch.where(
        kind == sb.LIGHT_SPOT,
        1.0 / (2.0 * math.pi * torch.clamp(1.0 - cos_total, min=1e-9)), pdf)
    pdf = torch.where(
        (kind == sb.LIGHT_AREA_TRI) | (kind == sb.LIGHT_AREA_SPH),
        torch.clamp(cosw, min=0.0) / math.pi, pdf)
    return torch.where(kind == sb.LIGHT_DISTANT, 0.0, pdf)


def _scene_has_infinite(scene) -> bool:
    return bool(torch.any(scene.light_kind == sb.LIGHT_INFINITE))


def _infinite_light_density(scene, pmf_all, w):
    """InfiniteLightDensity (bdpt.h:114-126): the sum over infinite lights
    of Pdf_Li(w) pmf(light), the solid-angle density with which the
    strategy family samples direction w toward the environment."""
    R = w.shape[0]
    dev = w.device
    zero3 = torch.zeros((R, 3), device=dev)
    total = torch.zeros((R,), device=dev)
    for li in torch.nonzero(scene.light_kind == sb.LIGHT_INFINITE)[:, 0] \
            .tolist():
        lid = torch.full((R,), li, dtype=torch.int32, device=dev)
        p = LT.pdf_li(scene, lid, zero3, w, zero3, zero3,
                      torch.zeros((R,), dtype=torch.bool, device=dev))
        total = total + pmf_all[li] * p
    return total


def _disk_pdf(scene):
    """1 / (pi worldRadius^2), rounded step by step in float32 as the JAX
    package computes it from its float32 world radius."""
    wr = np.float32(scene.world_radius)
    return float(np.float32(1.0) / (np.float32(np.pi) * wr * wr))


def _pdf_light_origin(scene, pmf_all, light_id):
    """pmf(light) pdfPos (Vertex::PdfLightOrigin, area part)."""
    li = light_id.long()
    pmf = pmf_all[li]
    kind = scene.light_kind[li]
    area = torch.clamp(scene.light_area[li], min=1e-12)
    pdf_pos = torch.where(
        (kind == sb.LIGHT_AREA_TRI) | (kind == sb.LIGHT_AREA_SPH),
        1.0 / area,
        torch.where(kind == sb.LIGHT_DISTANT,
                    torch.full_like(area, _disk_pdf(scene)), 1.0))
    return pmf * pdf_pos


class _Draws:
    """The draw source of the walks and connections.

    Threefry mode (keys given): a draw at (bounce, slot) hashes the lane's
    key (core/rng.py uniform_1d/2d).  Primary-sample-space mode (U given):
    each (bounce, slot) call site owns a fixed range of the dims of U
    [C, n], assigned in the order the sites are first reached, from
    `skip` on -- the JAX package's order, so one U names one path in both
    packages (render/pssmlt.py mutates U and evaluates it again)."""

    def __init__(self, keys=None, U=None, skip: int = 0):
        self.keys = keys
        self.U = U
        self._dims = {}
        self._next = skip

    def _dim(self, b, slot, n):
        key = (int(b), int(slot))
        if key not in self._dims:
            self._dims[key] = self._next
            self._next += n
        return self._dims[key]

    def d1(self, b, slot):
        if self.U is None:
            return crng.uniform_1d(self.keys, b, slot)
        i = self._dim(b, slot, 1)
        assert i + 1 <= self.U.shape[1], "MLT U vector too short"
        return self.U[:, i]

    def d2(self, b, slot):
        if self.U is None:
            return crng.uniform_2d(self.keys, b, slot)
        i = self._dim(b, slot, 2)
        assert i + 2 <= self.U.shape[1], "MLT U vector too short"
        return self.U[:, i:i + 2]


class _Path:
    """SoA subpath: tensors [P, V, ...]; slot 0 is the endpoint."""

    def __init__(self, P, V, device):
        self.P, self.V = P, V

        def z(*s, dtype=torch.float32):
            return torch.zeros((P, V) + s, dtype=dtype, device=device)

        self.p = z(3)
        self.ng = z(3)
        self.ns = z(3)
        self.beta = z(3)
        self.pdf_fwd = z()
        self.pdf_rev = z()
        self.mat_id = z(dtype=torch.int32)
        self.uv = z(2)
        self.wo = z(3)  # world, toward the previous vertex
        self.vtype = z(dtype=torch.int32)
        self.delta = z(dtype=torch.bool)  # specular scattering vertex
        # Slot 0 only: the light's POSITION is a Dirac delta (point, spot,
        # distant: pbrt's IsDeltaLight); only the s = 0 alternative is
        # excluded by it (bdpt.cpp:537).
        self.light_delta = z(dtype=torch.bool)
        # An escaped camera ray's light vertex (bdpt.cpp:962-1000): its
        # densities stay in solid-angle measure (bdpt.h:330).
        self.infinite = z(dtype=torch.bool)
        self.light_id = torch.full((P, V), -1, dtype=torch.int32,
                                   device=device)

    def set(self, i, **kw):
        for k, v in kw.items():
            getattr(self, k)[:, i] = v

    def exists(self, i):
        return self.vtype[:, i] != VT_NONE

    def on_surface(self, i):
        """Vertex::IsOnSurface: surface hits and area-light vertices carry
        a geometric normal; camera, delta-light and infinite endpoints do
        not, so densities converted to them keep the 1/d^2 form."""
        return (self.vtype[:, i] == VT_SURFACE) | (
            (self.vtype[:, i] == VT_LIGHT) & ~self.light_delta[:, i]
            & ~self.infinite[:, i])


def _frame(ns):
    return B.ShadingFrame.from_normal(torch.where(
        torch.any(ns != 0, -1, keepdim=True), ns,
        torch.tensor([0.0, 0.0, 1.0], device=ns.device)))


def _bsdf_at(scene, path, i, pairs, present=None):
    """[(f, pdf)] of the BSDF at vertex i of `path`, one for each world
    (wo, wi) pair: the JAX package's _bsdf_f / _bsdf_pdf calls at that
    vertex, made as one evaluation over the pairs' lanes side by side
    (every lane is evaluated on its own, so the values are the same)."""
    k = len(pairs)

    def rep(x):
        return torch.cat([x] * k) if k > 1 else x

    m = B.gather_materials(scene, rep(path.mat_id[:, i]), rep(path.uv[:, i]),
                           rep(path.p[:, i]))
    frame = _frame(rep(path.ns[:, i]))
    f, pdf = B.evaluate(m, frame.to_local(torch.cat([a for a, _ in pairs])),
                        frame.to_local(torch.cat([b for _, b in pairs])),
                        present)
    return list(zip(f.chunk(k), pdf.chunk(k)))


def camera_rays(cam, p_film):
    """The JAX package's generate_rays: a realistic camera traces its lens
    from the pupil rectangle's centre and drops the ray's weight."""
    if cam.lens is not None:
        o, d, _ = CAM.generate_rays_weighted(
            cam, p_film, torch.full_like(p_film, 0.5))
        return o, d
    return CAM.generate_rays(cam, p_film)


class BDPTRenderer(AltRenderer):
    """integrator "bdpt": every driver iteration adds `pixelsamples` full
    bidirectional samples per pixel."""

    def _reset_state(self):
        s, dev = self.s, self.device
        self.film_sum = torch.zeros((self.P, 3), device=dev)
        self.splat_sum = torch.zeros((self.P, 3), device=dev)
        self.n_samples = 0
        # Strategy depth: s + t <= max_depth + 2 (pbrt's maxDepth edges).
        self.max_depth = int(s.ecfg.max_depth)
        # Debug hook: restrict to a set of (s, t) strategies (None: all).
        self.strategy_filter = None
        # Debug hook: MIS weights -> 1 (biased).
        self.debug_no_mis = False
        # MLT's contribution mode: drop the t = 1 strategies AND their MIS
        # denominator terms, so the remaining sum still partitions.
        self.exclude_t1 = False
        self._has_inf = _scene_has_infinite(s.scene)
        self._pmf_all = _light_power_pmf(s.scene)
        cam = s.cam
        c2w = cam.camera_to_world.cpu().numpy().astype(np.float64)
        r2c = cam.raster_to_camera.cpu().numpy().astype(np.float64)
        self._w2c = torch.as_tensor(np.linalg.inv(c2w).astype(np.float32),
                                    device=dev)
        self._cam_p = torch.as_tensor(
            (c2w @ np.array([0.0, 0.0, 0.0, 1.0]))[:3].astype(np.float32),
            device=dev)
        self._c2r = torch.as_tensor(np.linalg.inv(r2c).astype(np.float32),
                                    device=dev)
        self._area = self._film_area()

    @property
    def film_mean(self):
        n = max(self.n_samples, 1)
        return (self.film_sum + self.splat_sum) / n

    # ------------------------------------------------------------------
    def _camera_walk(self, keys, o0, d0, V):
        """Camera subpath: vertex 0 the camera, then up to V-1 surface
        vertices (GenerateCameraSubpath, bdpt.cpp:352-395)."""
        P = o0.shape[0]
        path = _Path(P, V, self.device)
        ones = torch.ones((P, 3), device=self.device)
        path.set(0, p=o0, ng=d0, ns=d0, beta=ones, vtype=VT_CAMERA)
        _, pdf_dir0 = self._pdf_we(o0, d0)
        self._walk(path, keys, o0, d0, ones, pdf_dir0, start=1,
                   mode_importance=False)
        return path

    def _light_walk(self, keys, V, n_lanes=None):
        """Light subpath (GenerateLightSubpath, bdpt.cpp:397-476); n_lanes
        overrides one lane a pixel (MLT runs one lane a chain)."""
        scene = self.s.scene
        P = n_lanes if n_lanes is not None else self.P
        u_sel = keys.d1(0, crng.SLOT_LIGHT_SELECT + 16)
        light_id, pmf = pick_lights(self._pmf_all, u_sel)
        u_pos = keys.d2(0, crng.SLOT_LIGHT_SAMPLE + 16)
        u_dir = keys.d2(0, crng.SLOT_BSDF + 16)
        o, d, Le, ng, pdf_pos, pdf_dir, delta_pos = _emit_sample(
            scene, light_id, u_pos, u_dir)
        path = _Path(P, V, self.device)
        ok = (torch.any(Le > 0, -1) & (pdf_pos > 0) & (pdf_dir > 0)
              & (pmf > 0))
        path.set(0, p=o, ng=ng, ns=ng, beta=Le, pdf_fwd=pmf * pdf_pos,
                 vtype=torch.where(ok, VT_LIGHT, VT_NONE),
                 light_id=light_id, light_delta=delta_pos)
        cos0 = cm.absdot(ng, d)
        beta = Le * cos0[:, None] / torch.clamp(
            pmf * pdf_pos * pdf_dir, min=1e-20)[:, None]
        beta = torch.where(ok[:, None], beta, 0.0)
        self._walk(path, keys, o, d, beta, pdf_dir, start=1,
                   mode_importance=True)
        return path

    def _walk(self, path, keys, o, d, beta, pdf_dir, start, mode_importance):
        """The shared RandomWalk (bdpt.cpp:294-350): records vertices with
        forward and reverse area densities."""
        s, dev = self.s, self.device
        scene, bvh, present = s.scene, s.bvh, s.icfg.mat_types
        P = path.P
        active = torch.any(beta > 0, -1)
        slot_base = 32 if mode_importance else 0
        has_inf = (not mode_importance) and self._has_inf
        always = torch.ones((P,), dtype=torch.bool, device=dev)
        for i in range(start, path.V):
            hit = intersect_scene(scene, o, d, torch.where(active, cm.INF,
                                                           0.0), bvh)
            found = hit.found & active
            # Forward area density at the new vertex.
            prev_p = path.p[:, i - 1]
            pdf_fwd = _convert_density(pdf_dir, prev_p, hit.p, hit.ng, always)
            if has_inf:
                # An escaped camera ray -> an infinite-light vertex
                # (bdpt.cpp:962-1000): beta kept, direction in wo, pdf_fwd
                # in solid angle (bdpt.h:330).
                escaped = active & ~hit.found
            else:
                escaped = torch.zeros((P,), dtype=torch.bool, device=dev)
            far_p = o + d * (2.0 * scene.world_radius)
            m = B.gather_materials(scene, hit.mat_id, hit.uv, hit.p)
            frame = _frame(hit.ns)
            wo_l = frame.to_local(-d)
            delta = B.is_specular(m)
            keep = found | escaped
            path.set(
                i,
                p=torch.where(found[:, None], hit.p,
                              torch.where(escaped[:, None], far_p, 0.0)),
                ng=torch.where(found[:, None], hit.ng, 0.0),
                ns=torch.where(found[:, None], hit.ns, 0.0),
                beta=torch.where(keep[:, None], beta, 0.0),
                pdf_fwd=torch.where(found, pdf_fwd,
                                    torch.where(escaped, pdf_dir, 0.0)),
                mat_id=torch.where(found, hit.mat_id.to(torch.int32), 0),
                uv=torch.where(found[:, None], hit.uv, 0.0),
                wo=torch.where(keep[:, None], -d, 0.0),
                vtype=torch.where(found, VT_SURFACE,
                                  torch.where(escaped, VT_LIGHT, VT_NONE)),
                delta=found & delta,
                infinite=escaped,
                light_id=torch.where(found, hit.light_id.to(torch.int32), -1),
            )
            if i + 1 >= path.V:
                # The last vertex never continues, so no reverse pdf.
                break
            u_b = keys.d2(i + slot_base, crng.SLOT_BSDF)
            uc = keys.d1(i + slot_base, crng.SLOT_BSDF_COMPONENT_PC)
            bs = B.sample(m, wo_l, u_b, uc, present)
            wi_w = frame.to_world(bs.wi)
            cosw = cm.absdot(wi_w, hit.ns)
            new_beta = beta * bs.f * cosw[:, None] / torch.clamp(
                bs.pdf, min=1e-20)[:, None]
            # pbrt's shading-normal correction for importance transport
            # (bdpt.cpp CorrectShadingNormal).
            if mode_importance:
                num = cm.absdot(-d, hit.ns) * cm.absdot(wi_w, hit.ng)
                den = cm.absdot(-d, hit.ng) * cm.absdot(wi_w, hit.ns)
                corr = torch.where(den > 1e-9,
                                   num / torch.clamp(den, min=1e-9), 0.0)
                new_beta = new_beta * corr[:, None]
            # The reverse pdf at the PREVIOUS vertex.
            _, pdf_rev_dir = B.evaluate(m, frame.to_local(wi_w), wo_l,
                                        present)
            pdf_rev_dir = torch.where(bs.specular, 0.0, pdf_rev_dir)
            prev_rev = _convert_density(pdf_rev_dir, hit.p, prev_p,
                                        path.ng[:, i - 1],
                                        path.on_surface(i - 1))
            path.pdf_rev[:, i - 1] = torch.where(found, prev_rev,
                                                 path.pdf_rev[:, i - 1])
            live = found & (bs.pdf > 0) & torch.any(bs.f > 0, -1)
            pdf_dir = torch.where(bs.specular, 0.0, bs.pdf)
            o = _offset_origin(hit.p, hit.ng, wi_w)
            d = wi_w
            beta = torch.where(live[:, None], new_beta, 0.0)
            active = live

    # ------------------------------------------------------------------
    def _pdf_we(self, p_from, w):
        """(pdf_pos, pdf_dir) of the pinhole camera emitting ray (p, w)
        (cameras/perspective.cpp:Pdf_We), whatever the camera model."""
        cos_t = cm.transform_vector(self._w2c, w)[..., 2]
        c3 = torch.clamp(cos_t, min=1e-6)
        pdf_dir = torch.where(
            cos_t > 1e-6,
            1.0 / torch.clamp(self._area * (c3 * (c3 * c3)), min=1e-12),
            0.0)
        return torch.ones_like(pdf_dir), pdf_dir

    def _film_area(self):
        """Area of the screen window on the z = 1 camera plane."""
        r2c = self.s.cam.raster_to_camera.cpu().numpy().astype(np.float64)
        W, H = self.s.width, self.s.height
        pmin = r2c @ np.array([0.0, 0.0, 0.0, 1.0])
        pmax = r2c @ np.array([float(W), float(H), 0.0, 1.0])
        pmin = pmin[:3] / pmin[3]
        pmax = pmax[:3] / pmax[3]
        with np.errstate(divide="ignore", invalid="ignore"):
            pmin = pmin / pmin[2]  # projected to the z = 1 camera plane
            pmax = pmax / pmax[2]
        return float(abs((pmax[0] - pmin[0]) * (pmax[1] - pmin[1])))

    def _sample_wi_camera(self, p_ref):
        """PerspectiveCamera::Sample_Wi for a pinhole lens: (wi, dist, We
        [P, 3], raster index [P], inside, cos at the lens)."""
        W, H = self.s.width, self.s.height
        to_cam = self._cam_p[None] - p_ref
        dist = cm.length(to_cam)
        wi = to_cam / torch.clamp(dist, min=1e-12)[:, None]
        # The direction camera -> p_ref in camera space, projected.
        d_cam = cm.transform_vector(self._w2c, -wi)
        cos_t = d_cam[..., 2]
        safe = cos_t > 1e-6
        p_plane = d_cam / torch.clamp(cos_t, min=1e-6)[:, None]
        p_ras = cm.transform_point(self._c2r, p_plane)
        xr = p_ras[..., 0]
        yr = p_ras[..., 1]
        inside = safe & (xr >= 0) & (xr < W) & (yr >= 0) & (yr < H)
        idx = (torch.clamp(yr.to(torch.int32), 0, H - 1) * W
               + torch.clamp(xr.to(torch.int32), 0, W - 1))
        c = torch.clamp(cos_t, min=1e-6)
        c2 = c * c
        we = torch.where(inside, 1.0 / (self._area * (c2 * c2)), 0.0)
        return (wi, dist, we[:, None] * torch.ones((1, 3), device=we.device),
                idx, inside, cos_t)

    # ------------------------------------------------------------------
    def _mis_weight(self, qs, pt, s_n, t_n, overrides,
                    env_no_lightwalk=None):
        """bdpt.cpp:MISWeight:477-576 with functional endpoint overrides
        (('q'|'p', index) -> pdf_rev).  env_no_lightwalk [P]: lanes whose
        path ends at an infinite light; the light walk never starts there,
        so the s' >= 2 alternatives' terms are dropped for them."""
        dev = self.device
        if s_n + t_n == 2:
            return torch.ones((pt.P,), device=dev)
        sum_ri = torch.zeros((pt.P,), device=dev)
        no = torch.zeros((pt.P,), dtype=torch.bool, device=dev)

        def rev(path, tag, i):
            return overrides.get((tag, i), path.pdf_rev[:, i])

        def dlt(path, tag, i):
            # Connection endpoints act as connectible (non-delta).
            if (tag == "p" and i == t_n - 1) or (tag == "q" and i == s_n - 1):
                return no
            return path.delta[:, i]

        ri = torch.ones((pt.P,), device=dev)
        for i in range(t_n - 1, 0, -1):
            ri = ri * _remap0(rev(pt, "p", i)) / _remap0(pt.pdf_fwd[:, i])
            if i == 1 and self.exclude_t1:
                # MLT never samples t = 1; its terms go too.
                continue
            use = ~dlt(pt, "p", i) & ~dlt(pt, "p", i - 1)
            if env_no_lightwalk is not None and s_n + t_n - i >= 2:
                # The (s + t - i, i) alternative starts the light walk at
                # the environment.
                use = use & ~env_no_lightwalk
            sum_ri = sum_ri + torch.where(use, ri, 0.0)
        ri = torch.ones((pt.P,), device=dev)
        for i in range(s_n - 1, -1, -1):
            ri = ri * _remap0(rev(qs, "q", i)) / _remap0(qs.pdf_fwd[:, i])
            if i > 0:
                # bdpt.cpp:536: the previous vertex's SPECULAR delta; a
                # delta light position never suppresses these terms.
                use = ~dlt(qs, "q", i) & ~dlt(qs, "q", i - 1)
            else:
                # The s = 0 alternative: impossible iff the light position
                # cannot be hit (bdpt.cpp:537 IsDeltaLight).
                use = ~dlt(qs, "q", 0) & ~qs.light_delta[:, 0]
            sum_ri = sum_ri + torch.where(use, ri, 0.0)
        return 1.0 / (1.0 + sum_ri)

    def _vis(self, pa, pb, ng_a, valid):
        """Unoccluded between pa and pb (a shadow ray over all lanes; the
        invalid ones get t_max 0)."""
        s = self.s
        wdir = pb - pa
        dist = cm.length(wdir)
        wn = wdir / torch.clamp(dist, min=1e-12)[:, None]
        return ~occluded_scene(
            s.scene, _offset_origin(pa, ng_a, wn), wn,
            torch.where(valid, torch.clamp(dist * 0.999, min=0.0), 0.0),
            s.bvh)

    def strategies(self):
        """The (s, t >= 2) strategies in the JAX package's order."""
        D = self.max_depth
        return [(s_n, t_n) for t_n in range(2, D + 3)
                for s_n in range(0, D + 2) if s_n + t_n <= D + 2]

    def one_sample(self, base_key, sample_index: int):
        """(film, splat) [P, 3] of one bidirectional sample per pixel."""
        s, P, dev = self.s, self.P, self.device
        D = self.max_depth
        ids = torch.arange(P, dtype=torch.int32, device=dev)
        keys = _Draws(keys=crng.pixel_keys(base_key, ids, sample_index))
        pxy = torch.stack([(ids % s.width).to(torch.float32),
                           (ids // s.width).to(torch.float32)], -1) \
            + keys.d2(0, crng.SLOT_CAMERA)
        with spans.span("bdpt.camera_walk"):
            o0, d0 = camera_rays(s.cam, pxy)
            pt = self._camera_walk(keys, o0, d0, D + 2)
        with spans.span("bdpt.light_walk"):
            qs = self._light_walk(keys, D + 1)
        flt = self.strategy_filter
        sts = [st for st in self.strategies() + [(s_n, 1)
                                                 for s_n in range(2, D + 2)]
               if flt is None or st in flt]
        with spans.span("bdpt.connect"):
            outs = self.connect(qs, pt, keys, sts)
        film = torch.zeros((P, 3), device=dev)
        splat = torch.zeros((P, 3), device=dev)
        for (s_n, t_n), out in zip(sts, outs):
            w = out[-2] if t_n == 1 else out[1]
            if self.debug_no_mis:
                w = (w > 0).to(w.dtype)
            if t_n > 1:
                film = film + out[0] * w[:, None]
                continue
            # t = 1: the light subpath's splat onto the camera's pixels.
            with spans.span("bdpt.splat"):
                contrib, idx, _, valid = out
                lanes = torch.nonzero(valid)[:, 0]
                if splat_stats is not None:
                    splat_stats.append((int(lanes.numel()), int(
                        torch.unique(idx[lanes]).numel())))
                add = serial_scatter_add(
                    torch.zeros((P, 3), device=dev), idx[lanes].long(),
                    (contrib * w[:, None])[lanes])
                splat = splat + add
        return film, splat

    def connect(self, qs, pt, keys, sts):
        """The outputs of the strategies `sts` [(s, t)] in order: (L, w)
        for t >= 2 (_connect), (L, pixel, w, valid) for t = 1
        (_connect_t1).  Each strategy runs up to its BSDF requests, in
        order (so the s = 1 strategies draw in the JAX package's order);
        then each vertex's requests, from every strategy, are evaluated in
        one bsdf.evaluate call; then each strategy finishes, in order."""
        gens = [self._connect_t1(qs, s_n) if t_n == 1
                else self._connect(qs, pt, s_n, t_n, keys)
                for s_n, t_n in sts]
        outs, asks = [None] * len(gens), {}
        for k, g in enumerate(gens):
            try:
                asks[k] = next(g)
            except StopIteration as e:  # s = 0: no BSDF
                outs[k] = e.value
        groups = {}  # (path, vertex) -> [(strategy, request, pairs)]
        for k, reqs in asks.items():
            for j, (path, i, pairs) in enumerate(reqs):
                groups.setdefault((id(path), i), (path, i, []))[2].append(
                    (k, j, pairs))
        answers = {k: [None] * len(reqs) for k, reqs in asks.items()}
        present = self.s.icfg.mat_types
        for path, i, items in groups.values():
            res = _bsdf_at(self.s.scene, path, i,
                           [p for _, _, pairs in items for p in pairs],
                           present)
            for k, j, pairs in items:
                answers[k][j], res = res[:len(pairs)], res[len(pairs):]
        for k in asks:
            try:
                gens[k].send(answers[k])
            except StopIteration as e:
                outs[k] = e.value
        return outs

    # ------------------------------------------------------------------
    def _connect(self, qs, pt, s_n, t_n, keys):
        """One (s, t >= 2) strategy over all lanes (bdpt.cpp:ConnectBDPT),
        a generator for connect(): it yields its BSDF requests [(path,
        vertex, [(wo, wi), ...])], receives their [(f, pdf), ...], and
        returns (contribution [P, 3], MIS weight [P])."""
        s, dev = self.s, self.device
        scene = s.scene
        pmf_all = self._pmf_all
        P = pt.P
        ti = t_n - 1
        pt_ok = pt.exists(ti) & (pt.vtype[:, ti] == VT_SURFACE)
        has_inf = self._has_inf
        always = torch.ones((P,), dtype=torch.bool, device=dev)

        if s_n == 0:
            # The camera path alone: pt[t-1] must be emissive -- an area
            # light hit, or the escaped-ray infinite-light vertex.
            lid = pt.light_id[:, ti]
            le = LT.area_light_le(scene, lid, pt.ng[:, ti], pt.wo[:, ti])
            is_inf = pt.infinite[:, ti]
            if has_inf:
                env_dir = -pt.wo[:, ti]
                le = torch.where(is_inf[:, None],
                                 LT.escaped_radiance(scene, env_dir), le)
            L = pt.beta[:, ti] * le
            emissive = ((pt.vtype[:, ti] == VT_SURFACE) & (lid >= 0)) | is_inf
            valid = pt.exists(ti) & emissive & torch.any(le > 0, -1)
            valid = valid & pt.exists(t_n - 2)
            # Overrides: pt[t-1].pdf_rev = PdfLightOrigin, pt[t-2].pdf_rev
            # = PdfLight (the direction density at pt[t-2]).
            ov = {}
            lid_s = torch.clamp(lid, min=0)
            origin = _pdf_light_origin(scene, pmf_all, lid_s)
            if has_inf:
                # bdpt.h:401-404: infinite vertices use the summed
                # solid-angle density of sampling this direction.
                origin = torch.where(
                    is_inf, _infinite_light_density(scene, pmf_all, env_dir),
                    origin)
            ov[("p", ti)] = origin
            wdir = pt.p[:, ti - 1] - pt.p[:, ti]
            dist = torch.clamp(cm.length(wdir), min=1e-12)
            wn = wdir / dist[:, None]
            pdir = _pdf_le_dir(scene, lid_s, pt.ng[:, ti], wn)
            prev_rev = _convert_density(
                pdir, pt.p[:, ti], pt.p[:, ti - 1], pt.ng[:, ti - 1],
                pt.vtype[:, ti - 1] == VT_SURFACE)
            if has_inf:
                # Vertex::PdfLight for infinite lights (bdpt.h:372): the
                # planar world-disc density, cos-projected onto the
                # receiver, no 1/d^2.
                plan = _disk_pdf(scene)
                cos_prev = cm.absdot(pt.ng[:, ti - 1], pt.wo[:, ti])
                prev_rev = torch.where(
                    is_inf, plan * torch.where(pt.on_surface(ti - 1),
                                               cos_prev, 1.0), prev_rev)
            ov[("p", ti - 1)] = prev_rev
            L = torch.where(valid[:, None], L, 0.0)
            w = self._mis_weight(qs, pt, s_n, t_n, ov,
                                 env_no_lightwalk=is_inf if has_inf else None)
            return L, torch.where(valid, w, 0.0)

        if s_n == 1:
            # Resample a light from pt[t-1] (the NEE-analogue strategy).
            u_sel = keys.d1(t_n, crng.SLOT_LIGHT_SELECT + 8)
            light_id, sel_pmf = sample_light_id(s.dist, u_sel, pt.p[:, ti])
            u_l = keys.d2(t_n, crng.SLOT_LIGHT_SAMPLE + 8)
            ls = LT.sample_li(scene, light_id, pt.p[:, ti], pt.ng[:, ti], u_l)
            wdir = ls.p_light - pt.p[:, ti]
            dist = torch.clamp(cm.length(wdir), min=1e-12)
            wn = wdir / dist[:, None]
            wprev = pt.p[:, ti - 1] - pt.p[:, ti]
            dprev = torch.clamp(cm.length(wprev), min=1e-12)
            wpn = wprev / dprev[:, None]
            # f toward the light; qs[0].pdf_rev = pt[t-1].Pdf(pt[t-2] ->
            # qs[0]); pt[t-2].pdf_rev = pt[t-1].Pdf(qs[0] -> pt[t-2]).
            ((f, _), (_, pdf_q0), (_, pdf_p2)), = yield [
                (pt, ti, [(pt.wo[:, ti], ls.wi), (pt.wo[:, ti], wn),
                          (wn, wpn)])]
            f = f * cm.absdot(ls.wi, pt.ns[:, ti])[:, None]
            valid = (pt_ok & ~pt.delta[:, ti] & (ls.pdf > 0)
                     & torch.any(ls.li > 0, -1) & torch.any(f > 0, -1))
            valid = valid & self._vis(pt.p[:, ti], ls.p_light, pt.ng[:, ti],
                                      valid)
            beta_light = ls.li / torch.clamp(ls.pdf * sel_pmf,
                                             min=1e-20)[:, None]
            L = pt.beta[:, ti] * f * beta_light
            # The sampled light vertex for MIS: pdf_fwd = PdfLightOrigin.
            qs1 = _Path(P, 1, dev)
            lid_s = torch.clamp(light_id, min=0)
            kind = scene.light_kind[lid_s.long()]
            is_area = (kind == sb.LIGHT_AREA_TRI) | (kind == sb.LIGHT_AREA_SPH)
            is_inf_l = kind == sb.LIGHT_INFINITE
            ng_l = torch.where(is_area[:, None],
                               self._area_light_normal(scene, lid_s, ls), -wn)
            pdf_fwd0 = (_pdf_light_origin(scene, pmf_all, lid_s) * sel_pmf
                        / torch.clamp(pmf_all[lid_s.long()], min=1e-20))
            if has_inf:
                # PdfLightOrigin of an infinite light: the summed
                # solid-angle direction density (bdpt.h:401-404).
                pdf_fwd0 = torch.where(
                    is_inf_l, _infinite_light_density(scene, pmf_all, wn),
                    pdf_fwd0)
            qs1.set(0, p=ls.p_light, ng=ng_l, ns=ng_l, beta=beta_light,
                    pdf_fwd=pdf_fwd0,
                    vtype=torch.where(valid, VT_LIGHT, VT_NONE),
                    light_id=light_id, light_delta=ls.is_delta,
                    infinite=is_inf_l)
            ov = {}
            q0_rev = _convert_density(pdf_q0, pt.p[:, ti], ls.p_light, ng_l,
                                      is_area)
            if has_inf:
                # ConvertDensity passes infinite vertices through
                # (bdpt.h:330): the raw solid-angle BSDF pdf.
                q0_rev = torch.where(is_inf_l, pdf_q0, q0_rev)
            ov[("q", 0)] = q0_rev
            # pt[t-1].pdf_rev = the light's emission pdf toward pt[t-1].
            pdir = _pdf_le_dir(scene, lid_s, ng_l, -wn)
            p_ti_rev = _convert_density(pdir, ls.p_light, pt.p[:, ti],
                                        pt.ng[:, ti], always)
            if has_inf:
                # Vertex::PdfLight for infinite lights (bdpt.h:372).
                plan = _disk_pdf(scene) * cm.absdot(pt.ng[:, ti], wn)
                p_ti_rev = torch.where(is_inf_l, plan, p_ti_rev)
            ov[("p", ti)] = p_ti_rev
            ov[("p", ti - 1)] = _convert_density(
                pdf_p2, pt.p[:, ti], pt.p[:, ti - 1], pt.ng[:, ti - 1],
                pt.vtype[:, ti - 1] == VT_SURFACE)
            L = torch.where(valid[:, None], L, 0.0)
            w = self._mis_weight(qs1, pt, 1, t_n, ov,
                                 env_no_lightwalk=is_inf_l if has_inf
                                 else None)
            return L, torch.where(valid, w, 0.0)

        # s >= 2: a surface-surface connection.
        si = s_n - 1
        qs_ok = qs.exists(si) & (qs.vtype[:, si] == VT_SURFACE)
        valid = pt_ok & qs_ok & ~pt.delta[:, ti] & ~qs.delta[:, si]
        wdir = qs.p[:, si] - pt.p[:, ti]
        d2 = torch.clamp(cm.length_squared(wdir), min=1e-20)
        dist = cm.sqrt(d2)
        wn = wdir / dist[:, None]
        wq = qs.p[:, si - 1] - qs.p[:, si]
        dq = torch.clamp(cm.length(wq), min=1e-12)
        wqn = wq / dq[:, None]
        wp = pt.p[:, ti - 1] - pt.p[:, ti]
        dp = torch.clamp(cm.length(wp), min=1e-12)
        wpn = wp / dp[:, None]
        # At pt[t-1]: f toward qs[s-1] with qs[s-1].pdf_rev's pdf, and
        # pt[t-2].pdf_rev's Pdf(qs[s-1] -> pt[t-2]); at qs[s-1]: f toward
        # pt[t-1] with pt[t-1].pdf_rev's pdf, and qs[s-2].pdf_rev's
        # Pdf(pt[t-1] -> qs[s-2]).
        ((f_t, pdf_qs1), (_, pdf_pt2)), ((f_s, pdf_pt1), (_, pdf_qs2)) = \
            yield [(pt, ti, [(pt.wo[:, ti], wn), (wn, wpn)]),
                   (qs, si, [(qs.wo[:, si], -wn), (-wn, wqn)])]
        g = (cm.absdot(wn, pt.ns[:, ti]) * cm.absdot(wn, qs.ns[:, si]) / d2)
        valid = valid & torch.any(f_t > 0, -1) & torch.any(f_s > 0, -1)
        valid = valid & self._vis(pt.p[:, ti], qs.p[:, si], pt.ng[:, ti],
                                  valid)
        L = pt.beta[:, ti] * f_t * g[:, None] * f_s * qs.beta[:, si]
        ov = {}
        # qs[s-1].pdf_rev = pt[t-1].Pdf(pt[t-2] -> qs[s-1]).
        ov[("q", si)] = _convert_density(pdf_qs1, pt.p[:, ti], qs.p[:, si],
                                         qs.ng[:, si], always)
        # qs[s-2].pdf_rev = qs[s-1].Pdf(pt[t-1] -> qs[s-2]).
        ov[("q", si - 1)] = _convert_density(
            pdf_qs2, qs.p[:, si], qs.p[:, si - 1], qs.ng[:, si - 1],
            qs.on_surface(si - 1))
        # pt[t-1].pdf_rev = qs[s-1].Pdf(qs[s-2] -> pt[t-1]).
        ov[("p", ti)] = _convert_density(pdf_pt1, qs.p[:, si], pt.p[:, ti],
                                         pt.ng[:, ti], always)
        # pt[t-2].pdf_rev = pt[t-1].Pdf(qs[s-1] -> pt[t-2]).
        ov[("p", ti - 1)] = _convert_density(
            pdf_pt2, pt.p[:, ti], pt.p[:, ti - 1], pt.ng[:, ti - 1],
            pt.vtype[:, ti - 1] == VT_SURFACE)
        L = torch.where(valid[:, None], L, 0.0)
        w = self._mis_weight(qs, pt, s_n, t_n, ov)
        return L, torch.where(valid, w, 0.0)

    def _area_light_normal(self, scene, light_id, ls):
        """The geometric EMISSION normal at an area-light sample point:
        triangles carry ReverseOrientation in their winding, spheres in
        sph_flip."""
        li = light_id.long()
        if scene.tri_p0.shape[0] > 0:
            t = _tri_rows(scene, li)
            n_tri = cm.normalize(cm.cross(scene.tri_e1[t], scene.tri_e2[t]))
        else:
            n_tri = torch.zeros_like(ls.p_light)
        if scene.sph_center.shape[0] > 0:
            si = _sph_rows(scene, li)
            n_sph = cm.normalize(ls.p_light - scene.sph_center[si])
            if scene.sph_flip is not None:
                n_sph = n_sph * scene.sph_flip[si][:, None]
            kind = scene.light_kind[li]
            return torch.where((kind == sb.LIGHT_AREA_SPH)[:, None], n_sph,
                               n_tri)
        return n_tri

    def _connect_t1(self, qs, s_n):
        """t = 1: connect qs[s-1] to the camera; the splat lands on the
        raster pixel of the connection (bdpt.cpp:721-744).  A generator
        like _connect, returning (contribution, pixel, MIS weight, valid)."""
        s, dev = self.s, self.device
        P = qs.P
        si = s_n - 1
        ok = (qs.exists(si) & (qs.vtype[:, si] == VT_SURFACE)
              & ~qs.delta[:, si])
        wi, dist, we, idx, inside, cos_lens = self._sample_wi_camera(
            qs.p[:, si])
        wq = qs.p[:, si - 1] - qs.p[:, si]
        dq = torch.clamp(cm.length(wq), min=1e-12)
        wqn = wq / dq[:, None]
        # f toward the camera, and qs[s-2].pdf_rev's Pdf(camera -> qs[s-2]).
        ((f, _), (_, pdf_q2)), = yield [
            (qs, si, [(qs.wo[:, si], wi), (wi, wqn)])]
        # The importance-transport shading-normal correction.
        num = cm.absdot(qs.wo[:, si], qs.ns[:, si]) * cm.absdot(wi,
                                                               qs.ng[:, si])
        den = cm.absdot(qs.wo[:, si], qs.ng[:, si]) * cm.absdot(wi,
                                                               qs.ns[:, si])
        corr = torch.where(den > 1e-9, num / torch.clamp(den, min=1e-9), 0.0)
        cosw = cm.absdot(wi, qs.ns[:, si])
        # Pinhole Sample_Wi: pdf = dist^2 / |cos(lens normal, wi)|.
        dd = torch.clamp(dist, min=1e-12)
        pdf_dist = dd * dd / torch.clamp(cos_lens, min=1e-6)
        valid = ok & inside & torch.any(f > 0, -1) & torch.any(we > 0, -1)
        cam_p = qs.p[:, si] + wi * dist[:, None]
        valid = valid & self._vis(qs.p[:, si], cam_p, qs.ng[:, si], valid)
        L = (qs.beta[:, si] * f * (corr * cosw)[:, None] * we
             / pdf_dist[:, None])
        # MIS: the camera side is one vertex; qs[s-1].pdf_rev = the
        # camera's Pdf_We direction density, qs[s-2].pdf_rev =
        # qs[s-1].Pdf(camera -> qs[s-2]).
        pt1 = _Path(P, 1, dev)
        pt1.set(0, p=cam_p, ng=wi, ns=wi, beta=we,
                vtype=torch.where(valid, VT_CAMERA, VT_NONE))
        ov = {}
        _, pdf_dir = self._pdf_we(cam_p, -wi)
        ov[("q", si)] = _convert_density(
            pdf_dir, cam_p, qs.p[:, si], qs.ng[:, si],
            torch.ones((P,), dtype=torch.bool, device=dev))
        ov[("q", si - 1)] = _convert_density(
            pdf_q2, qs.p[:, si], qs.p[:, si - 1], qs.ng[:, si - 1],
            qs.on_surface(si - 1))
        w = self._mis_weight(qs, pt1, s_n, 1, ov)
        L = torch.where(valid[:, None], L, 0.0)
        return L, idx, torch.where(valid, w, 0.0), valid

    # ------------------------------------------------------------------
    def make_contribution(self, n_chains: int, max_dims: int = 256):
        """The Kelemen-MLT contribution function over the BDPT strategy sum
        (render/pssmlt.py): f(U [C, n_dims]) -> (y [C], L [C, 3], pix [C]
        int32), the full t >= 2 strategy sum of the path U names; the t = 1
        strategies and their MIS terms are left out (exclude_t1), so the
        reduced mixture still partitions.  n_dims is counted on a one-lane
        evaluation (the JAX package counts it on an abstract trace)."""
        s = self.s
        W, H = s.width, s.height
        D = self.max_depth
        self.exclude_t1 = True
        holder = {}

        def f(U):
            C = U.shape[0]
            keys = _Draws(U=U, skip=2)
            px = torch.clamp(U[:, 0] * W, 0.0, W - 1e-3)
            py = torch.clamp(U[:, 1] * H, 0.0, H - 1e-3)
            with spans.span("bdpt.camera_walk"):
                o0, d0 = camera_rays(s.cam, torch.stack([px, py], -1))
                pt = self._camera_walk(keys, o0, d0, D + 2)
            with spans.span("bdpt.light_walk"):
                qs = self._light_walk(keys, D + 1, n_lanes=C)
            L = torch.zeros((C, 3), device=U.device)
            with spans.span("bdpt.connect"):
                for c, w in self.connect(qs, pt, keys, self.strategies()):
                    L = L + c * w[:, None]
            pix = py.to(torch.int32) * W + px.to(torch.int32)
            holder["dims"] = keys._next
            return spec.luminance(L), L, pix

        f(torch.full((1, max_dims), 0.5, device=self.device))
        return f, holder["dims"]

    def _render_iteration(self, i: int) -> float:
        s = self.s
        ecfg = s.ecfg
        n = ecfg.pixel_samples if not ecfg.exp_iterations or i == 1 \
            else ecfg.pixel_samples << (i - 2)
        key = crng.fold_in(crng.base_key(s.base_seed, device=self.device), i)
        film = torch.zeros((self.P, 3), device=self.device)
        splat = torch.zeros((self.P, 3), device=self.device)
        for j in range(n):
            f2, sp2 = self.one_sample(key, i * n + j)
            film = film + f2
            splat = splat + sp2
        self.film_sum = self.film_sum + film
        self.splat_sum = self.splat_sum + splat
        self.n_samples += n
        D = self.max_depth
        # Two walks of ~D segments and ~D^2/2 connection shadow rays.
        return float(n * self.P * (2 * D + (D * (D + 1)) // 2))

