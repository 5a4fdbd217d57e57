"""Stochastic progressive photon mapping (port of statmc_tpu/render/sppm.py).

pbrt's SPPMIntegrator (src/integrators/sppm.cpp), as the JAX package
re-derives it:

* camera pass: follow each pixel's ray through specular chains,
  accumulate direct light (Le + NEE) on the way, and store ONE visible
  point at the first non-specular vertex (or at the last depth);
* photon pass: emit ``photonsperiteration`` photons from the lights
  (``sample_le``), trace ``maxdepth`` bounces, and deposit each vertex
  after the first into every visible point within that pixel's radius;
* per-pixel update with alpha = 2/3, and the estimate
  L = Ld / iterations + tau / (iterations * pi * R^2) (``film_mean``).

Both passes run each bounce on the lanes still active, and stop once
none is left.  The deposit differs from the JAX package's in form only:
where the JAX package tests every (visible point, photon vertex) pair
(a dense [P, Nph] pass, ``deposit_dense`` here, kept as the grid's plain
twin), the port puts the visible points into a uniform grid whose cell
is at least the largest current radius (pbrt's own design), finds each
photon vertex's candidates in its cell and the 26 around it, keeps
exactly the pairs with d2 <= r2 computed as the dense pass computes
them, evaluates the BSDF on those pairs only, in chunks bounded in
memory, and sums each visible point's pairs in (visible point, photon)
order with a segment sum: no floating-point atomics, so two runs on the
card agree bit for bit.

Two JAX-package behaviours are mirrored: spot photons get no falloff
(``hasattr(lights, "_spot_falloff")`` is false there), and infinite,
goniometric and projection lights emit no photons.
"""
from __future__ import annotations

import math

import torch

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

ALPHA = 2.0 / 3.0  # pbrt "radiussearch" alpha default
# Candidate (visible point, photon vertex) pairs tested per chunk of the
# grid deposit, and kept pairs whose BSDF is evaluated per chunk.
PAIR_CHUNK = 1 << 24
EVAL_CHUNK = 1 << 22
# Set to a list to record, per deposit, the photon vertices, the
# candidate pairs tested and the pairs kept.
deposit_stats = None


def _light_power_pmf(scene):
    """Photon-allocation pmf matching each light kind's Power()
    (src/lights/*.cpp): point 4 pi I, spot 2 pi (1 - (cosFalloff +
    cosTotal) / 2) I, area pi area L, distant/infinite pi worldRadius^2 L."""
    k = scene.light_kind
    lum = spec.luminance(scene.light_L)
    wr2 = scene.world_radius * scene.world_radius
    cos_total = scene.light_params[:, 0]
    cos_falloff = scene.light_params[:, 1]
    power = torch.where(
        k <= sb.LIGHT_AREA_SPH,
        lum * torch.clamp(scene.light_area, min=1e-9) * math.pi,
        torch.where(
            k == sb.LIGHT_SPOT,
            lum * 2.0 * math.pi * (1.0 - 0.5 * (cos_falloff + cos_total)),
            torch.where(
                (k == sb.LIGHT_DISTANT) | (k == sb.LIGHT_INFINITE),
                lum * math.pi * wr2,
                lum * 4.0 * math.pi)))  # point / gonio / proj
    total = torch.clamp(torch.sum(power), min=1e-20)
    return power / total


def pick_lights(pmf, u):
    """(light id, its pmf) per lane: searchsorted on the power CDF, summed
    in the JAX package's order (jnp.cumsum), side left."""
    cdf = torch.cumsum(pmf, 0)
    light_id = torch.clamp(torch.searchsorted(cdf, u.contiguous()), 0,
                           pmf.shape[0] - 1)
    return light_id.to(torch.int32), pmf[light_id]


def sample_le(scene, light_id, u_pos, u_dir):
    """Photon origin / direction / weight for one light per lane (each
    light type's Sample_Le; beta = Le cos / (pdfPos pdfDir)): point,
    spot, area (triangle and sphere) and distant lights; the others give
    beta 0."""
    li = light_id.long()
    kind = scene.light_kind[li]
    Lrad = scene.light_L[li]
    pos = scene.light_pos[li]
    par = scene.light_params[li]

    # Uniform sphere direction (point lights; pdf 1/4pi).
    z = 1.0 - 2.0 * u_dir[:, 0]
    r_ = cm.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u_dir[:, 1]
    d_sph = torch.stack([r_ * torch.cos(phi), r_ * torch.sin(phi), z], -1)

    o = pos
    d = d_sph
    beta = Lrad * (4.0 * math.pi)  # I / pdfDir

    # Spot: uniform cone around the spot axis (SpotLight::Sample_Le),
    # without falloff, as the JAX package computes it.
    is_spot = kind == sb.LIGHT_SPOT
    cos_total = par[:, 0]
    axis = scene.light_aux[li]
    zc = 1.0 - u_dir[:, 0:1] * (1.0 - cos_total[:, None])
    rc = cm.sqrt(torch.clamp(1.0 - zc * zc, min=0.0))
    frame_s = B.ShadingFrame.from_normal(axis)
    d_cone = frame_s.to_world(torch.cat(
        [rc * torch.cos(phi)[:, None], rc * torch.sin(phi)[:, None], zc], -1))
    pdf_cone = 1.0 / (2.0 * math.pi
                      * torch.clamp(1.0 - cos_total, min=1e-6))
    beta_spot = Lrad / pdf_cone[:, None]
    d = torch.where(is_spot[:, None], d_cone, d)
    beta = torch.where(is_spot[:, None], beta_spot, beta)

    # Area triangle: uniform point + cosine direction.
    if scene.tri_p0.shape[0] > 0:
        is_tri = kind == sb.LIGHT_AREA_TRI
        # Other kinds' prims index past the table; their values are
        # masked off below (the JAX package's gathers clamp).
        t = torch.clamp(scene.light_prim[li], 0,
                        scene.tri_p0.shape[0] - 1).long()
        p0, e1, e2 = scene.tri_p0[t], scene.tri_e1[t], scene.tri_e2[t]
        su = cm.sqrt(torch.clamp(u_pos[:, 0], min=1e-12))
        b0 = 1.0 - su
        b1 = u_pos[:, 1] * su
        p_tri = p0 + e1 * b0[:, None] + e2 * b1[:, None]
        n_tri = cm.cross(e1, e2)
        n_tri = n_tri / torch.clamp(cm.length(n_tri), min=1e-12)[:, None]
        area = scene.light_area[li]
        frame_t = B.ShadingFrame.from_normal(n_tri)
        rr = cm.sqrt(u_dir[:, 0])
        d_cos = frame_t.to_world(torch.stack(
            [rr * torch.cos(phi), rr * torch.sin(phi),
             cm.sqrt(torch.clamp(1.0 - u_dir[:, 0], min=0.0))], -1))
        # beta = L cos / (pdfPos pdfDir) = L pi area
        beta_tri = Lrad * math.pi * torch.clamp(area, min=1e-12)[:, None]
        o = torch.where(is_tri[:, None], p_tri + n_tri * 1e-4, o)
        d = torch.where(is_tri[:, None], d_cos, d)
        beta = torch.where(is_tri[:, None], beta_tri, beta)

    # Area sphere: uniform surface point + cosine direction.
    if scene.sph_center.shape[0] > 0:
        is_sph = kind == sb.LIGHT_AREA_SPH
        si = torch.clamp(scene.light_prim[li], 0,
                         scene.sph_center.shape[0] - 1).long()
        c = scene.sph_center[si]
        rad = scene.sph_radius[si]
        p_s = c + d_sph * rad[:, None]
        # The emission normal carries the ReverseOrientation sign.
        n_s = d_sph * scene.sph_flip[si][:, None]
        frame_sp = B.ShadingFrame.from_normal(n_s)
        rr = cm.sqrt(u_pos[:, 0])
        phi2 = 2.0 * math.pi * u_pos[:, 1]
        d_cos2 = frame_sp.to_world(torch.stack(
            [rr * torch.cos(phi2), rr * torch.sin(phi2),
             cm.sqrt(torch.clamp(1.0 - u_pos[:, 0], min=0.0))], -1))
        area_s = scene.light_area[li]
        beta_s = Lrad * math.pi * torch.clamp(area_s, min=1e-12)[:, None]
        o = torch.where(is_sph[:, None], p_s + n_s * 1e-4, o)
        d = torch.where(is_sph[:, None], d_cos2, d)
        beta = torch.where(is_sph[:, None], beta_s, beta)

    # Distant: photons start on a worldRadius disk outside the scene and
    # travel -w (DistantLight::Sample_Le; light_pos holds the direction
    # toward the light).
    is_dist = kind == sb.LIGHT_DISTANT
    wdir = scene.light_pos[li]
    wr = scene.world_radius
    frame_d = B.ShadingFrame.from_normal(wdir)
    rd = cm.sqrt(torch.clamp(u_pos[:, 0], min=0.0)) * wr
    phid = 2.0 * math.pi * u_pos[:, 1]
    o_dist = scene.world_center + frame_d.to_world(torch.stack(
        [rd * torch.cos(phid), rd * torch.sin(phid), torch.zeros_like(rd)],
        -1)) + wdir * (2.0 * wr)
    beta_dist = Lrad * (math.pi * wr * wr)
    o = torch.where(is_dist[:, None], o_dist, o)
    d = torch.where(is_dist[:, None], -wdir, d)
    beta = torch.where(is_dist[:, None], beta_dist, beta)

    ok = ((kind != sb.LIGHT_INFINITE) & (kind != sb.LIGHT_GONIO)
          & (kind != sb.LIGHT_PROJ))
    return o, d, torch.where(ok[:, None], beta, 0.0)


def _frame(ns):
    return B.ShadingFrame.from_normal(torch.where(
        torch.any(ns != 0, -1, keepdim=True), ns,
        torch.tensor([0.0, 0.0, 1.0], device=ns.device)))


def _take(m: B.MaterialLanes, idx) -> B.MaterialLanes:
    """The lanes idx of every per-lane field of m."""
    return m._replace(**{f: getattr(m, f)[idx] for f in m._fields
                         if f != "fourier_tab" and getattr(m, f) is not None})


class VisiblePoints:
    """The camera pass's visible points and what the deposit reads of
    them: position, outgoing direction, material lanes, shading frame,
    wo in that frame, and the `have` mask."""

    def __init__(self, scene, vp_p, vp_wo, vp_mat, vp_uv, vp_ns, have,
                 present=None):
        self.p, self.have, self.present = vp_p, have, present
        self.m = B.gather_materials(scene, vp_mat, vp_uv, vp_p)
        self.frame = _frame(vp_ns)
        self.wo_l = self.frame.to_local(vp_wo)

    def contrib(self, vi, ph_wi, ph_beta):
        """f(wo, -ph_wi) * ph_beta for pairs of visible points vi [K] and
        photon vertices (ph_wi, ph_beta [K, 3])."""
        fr = B.ShadingFrame(self.frame.t[vi], self.frame.b[vi],
                            self.frame.n[vi])
        f, _ = B.evaluate(_take(self.m, vi), self.wo_l[vi],
                          fr.to_local(-ph_wi), self.present)
        return f * ph_beta


def deposit_dense(vp: VisiblePoints, r2, ph_p, ph_wi, ph_beta, ph_on):
    """The JAX package's dense deposit (statmc_tpu/render/sppm.py:368-386):
    every visible point against every photon vertex.  (phi [P, 3],
    m_count [P]); the plain twin of deposit_grid, for tests."""
    d2 = torch.sum((vp.p[:, None, :] - ph_p[None, :, :]) ** 2, -1)
    near = (d2 <= r2[:, None]) & ph_on[None, :] & vp.have[:, None]
    P, N = near.shape
    vi = torch.arange(P, device=near.device).repeat_interleave(N)
    pj = torch.arange(N, device=near.device).repeat(P)
    c = vp.contrib(vi, ph_wi[pj], ph_beta[pj]).reshape(P, N, 3)
    phi = torch.sum(torch.where(near[..., None], c, 0.0), dim=1)
    return phi, torch.sum(near, dim=1).to(torch.float32)


def _cell(x, lo, h):
    return torch.floor((x - lo) / h).to(torch.int64)


def grid_pairs(vp_p, have, r2, ph_p, ph_on):
    """The (visible point, photon vertex) pairs with d2 <= r2, found
    through a uniform grid of the visible points whose cell side is the
    largest radius: (vi, jj) sorted by visible point and then photon, and
    the candidate pairs tested.  d2 is computed as deposit_dense computes
    it, so the pair set is the dense pass's."""
    dev = ph_p.device
    v_idx = torch.nonzero(have)[:, 0]
    j_idx = torch.nonzero(ph_on)[:, 0]
    none = torch.zeros((0,), dtype=torch.int64, device=dev)
    if v_idx.numel() == 0 or j_idx.numel() == 0:
        return none, none, 0
    # A margin on the cell side keeps every pair within reach of rounding
    # inside the 27 cells.
    h = max(float(torch.sqrt(torch.max(r2[v_idx]).double())) * (1.0 + 1e-3),
            1e-12)
    lo = torch.amin(vp_p[v_idx], 0)
    cv = _cell(vp_p[v_idx], lo, h)
    dims = torch.amax(cv, 0) + 1
    # Cell keys with a two-cell border: the neighbours of any cell that
    # can reach a visible point have a key, and keys outside match nothing.
    ext = dims + 4

    def key(c):
        c = c + 2
        return c[..., 0] + ext[0] * (c[..., 1] + ext[1] * c[..., 2])

    vkey, vord = torch.sort(key(cv), stable=True)
    vsorted = v_idx[vord]
    cp = _cell(ph_p[j_idx], lo, h)
    inside = torch.all((cp >= -1) & (cp <= dims), -1)
    j_idx, cp = j_idx[inside], cp[inside]
    offs = torch.tensor([(dx, dy, dz) for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        dtype=torch.int64, device=dev)
    nkeys = key(cp[:, None, :] + offs[None])  # [J, 27]
    start = torch.searchsorted(vkey, nkeys)
    count = torch.searchsorted(vkey, nkeys, right=True) - start
    # Photon vertices in chunks of about PAIR_CHUNK candidate pairs.
    cum = torch.cumsum(torch.sum(count, 1), 0)
    n_all = int(cum[-1]) if cum.numel() else 0
    splits = torch.searchsorted(cum, torch.arange(
        PAIR_CHUNK, max(n_all, PAIR_CHUNK), PAIR_CHUNK, device=dev),
        right=True)
    edges = sorted({0, j_idx.numel(), *splits.tolist()})
    kept_v, kept_j = [none], [none]
    for a, b in zip(edges[:-1], edges[1:]):
        cnt = count[a:b].reshape(-1)
        total = int(cnt.sum())
        if total == 0:
            continue
        cell = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev),
                                       cnt, output_size=total)
        rank = torch.arange(total, device=dev) - (torch.cumsum(cnt, 0)
                                                  - cnt)[cell]
        vi = vsorted[start[a:b].reshape(-1)[cell] + rank]
        jj = j_idx[a:b][cell // 27]
        near = torch.sum((vp_p[vi] - ph_p[jj]) ** 2, -1) <= r2[vi]
        kept_v.append(vi[near])
        kept_j.append(jj[near])
    vi, jj = torch.cat(kept_v), torch.cat(kept_j)
    order = torch.argsort(vi * ph_p.shape[0] + jj)
    return vi[order], jj[order], n_all


def deposit_grid(vp: VisiblePoints, r2, ph_p, ph_wi, ph_beta, ph_on):
    """The same (phi, m_count) as deposit_dense through grid_pairs: the
    BSDF evaluated on the kept pairs only, in chunks, and each visible
    point's pairs summed in photon order by a segment sum."""
    P = vp.p.shape[0]
    vi, jj, n_tested = grid_pairs(vp.p, vp.have, r2, ph_p, ph_on)
    if deposit_stats is not None:
        deposit_stats.append({"vertices": int(ph_on.sum()),
                              "tested": n_tested, "kept": vi.numel()})
    if vi.numel() == 0:
        return (torch.zeros((P, 3), device=ph_p.device),
                torch.zeros((P,), device=ph_p.device))
    c = torch.cat([vp.contrib(vi[s:s + EVAL_CHUNK], ph_wi[jj[s:s + EVAL_CHUNK]],
                              ph_beta[jj[s:s + EVAL_CHUNK]])
                   for s in range(0, vi.numel(), EVAL_CHUNK)])
    lengths = torch.bincount(vi, minlength=P)
    phi = torch.segment_reduce(c, "sum", lengths=lengths, axis=0, unsafe=True)
    return phi, lengths.to(torch.float32)


class SPPMRenderer(AltRenderer):
    """integrator "sppm": each driver iteration is one SPPM pass (camera
    pass + photonsperiteration photons)."""

    def __init__(self, desc, base_seed: int = 0, device="cuda",
                 strict_assets: bool | None = None):
        self._ip = desc.integrator_params
        super().__init__(desc, base_seed, device, strict_assets)

    def _param(self, name, default):
        return self._ip.find_one(name, default) if self._ip else default

    def _reset_state(self):
        P, dev = self.P, self.device
        self.n_photons = int(self._param("photonsperiteration",
                                         max(P, 4096)))
        self.radius = torch.full((P,), float(self._param("radius", 1.0)),
                                 device=dev)
        self.n_acc = torch.zeros((P,), device=dev)
        self.tau = torch.zeros((P, 3), device=dev)
        self.Ld = torch.zeros((P, 3), device=dev)
        self.n_iters = 0
        self.total_photons = 0

    # ---- camera pass ------------------------------------------------------
    def camera_pass(self, key) -> dict:
        """Ld and the visible points of one pass, sample index 0 under
        `key` (the JAX package's _camera_pass(0))."""
        s, P, dev = self.s, self.P, self.device
        ids = torch.arange(P, dtype=torch.int32, device=dev)
        keys = crng.pixel_keys(key, ids, 0)
        pxy = torch.stack([(ids % s.width).to(torch.float32),
                           (ids // s.width).to(torch.float32)], -1)
        u_cam = crng.uniform_2d(keys, 0, crng.SLOT_CAMERA)
        o, d = CAM.generate_rays(s.cam, pxy + u_cam)
        c = dict(
            beta=torch.ones((P, 3), device=dev),
            Ld=torch.zeros((P, 3), device=dev),
            have=torch.zeros((P,), dtype=torch.bool, device=dev),
            vp_p=torch.zeros((P, 3), device=dev),
            vp_wo=torch.zeros((P, 3), device=dev),
            vp_beta=torch.zeros((P, 3), device=dev),
            vp_mat=torch.zeros((P,), dtype=torch.int32, device=dev),
            vp_uv=torch.zeros((P, 2), device=dev),
            vp_ns=torch.zeros((P, 3), device=dev),
            spec=torch.ones((P,), dtype=torch.bool, device=dev))
        lanes = ids.long()  # active lanes
        for b in range(s.icfg.max_depth + 1):
            if lanes.numel() == 0:
                break
            lanes, o, d = self._camera_step(c, keys, b, lanes, o, d)
        return c

    def _camera_step(self, c: dict, keys, b: int, lanes, o, d):
        """One bounce of the camera pass on the active lanes (rays o, d):
        updates the carry c in place; returns the lanes that continue and
        their next rays."""
        s, dev = self.s, self.device
        scene, bvh, present = s.scene, s.bvh, s.icfg.mat_types
        R = lanes.numel()
        k = keys[lanes]
        beta = c["beta"][lanes]
        hit = intersect_scene(scene, o, d, torch.full((R,), cm.INF,
                                                      device=dev), bvh)
        found = hit.found
        le = LT.area_light_le(scene, hit.light_id, hit.ng, -d)
        esc = LT.escaped_radiance(scene, d)
        lee = torch.where(found[:, None], le, esc)
        Ld = c["Ld"][lanes] + torch.where(c["spec"][lanes][:, None],
                                          beta * lee, 0.0)

        m = B.gather_materials(scene, hit.mat_id, hit.uv, hit.p)
        frame = _frame(hit.ns)
        wo_l = frame.to_local(-d)
        delta = B.is_specular(m)
        diffuse_hit = found & ~delta

        # NEE at every vertex (sppm.cpp camera pass direct light).
        u_sel = crng.uniform_1d(k, b, crng.SLOT_LIGHT_SELECT)
        light_id, sel_pmf = sample_light_id(s.dist, u_sel, hit.p)
        u_l = crng.uniform_2d(k, b, crng.SLOT_LIGHT_SAMPLE)
        ls = LT.sample_li(scene, light_id, hit.p, hit.ng, u_l)
        f_l, _ = B.evaluate(m, wo_l, frame.to_local(ls.wi), present)
        f_l = f_l * cm.absdot(ls.wi, hit.ns)[:, None]
        valid = diffuse_hit & (ls.pdf > 0) & torch.any(f_l > 0, -1)
        vl = torch.nonzero(valid)[:, 0]
        unocc = torch.zeros((R,), dtype=torch.bool, device=dev)
        if vl.numel():
            wi_v = ls.wi[vl]
            unocc[vl] = ~occluded_scene(
                scene, _offset_origin(hit.p[vl], hit.ng[vl], wi_v), wi_v,
                torch.clamp(ls.dist[vl] * 0.999, min=0.0), bvh)
        contr = f_l * ls.li / torch.clamp(ls.pdf * sel_pmf,
                                          min=1e-20)[:, None]
        c["Ld"][lanes] = Ld + torch.where(unocc[:, None], beta * contr, 0.0)

        # The visible point: the first non-specular hit, or the last
        # depth's hit (sppm.cpp's isDiffuse || (isGlossy && depth ==
        # maxDepth - 1), as the JAX package reads it).
        have = c["have"][lanes]
        store = (diffuse_hit | (found & (b == s.icfg.max_depth))) & ~have
        st = lanes[store]
        c["vp_p"][st] = hit.p[store]
        c["vp_wo"][st] = -d[store]
        c["vp_beta"][st] = beta[store]
        c["vp_mat"][st] = hit.mat_id[store].to(torch.int32)
        c["vp_uv"][st] = hit.uv[store]
        c["vp_ns"][st] = hit.ns[store]
        c["have"][lanes] = have | store

        # Continue only through specular lobes, until a visible point.
        u_b = crng.uniform_2d(k, b, crng.SLOT_BSDF)
        uc = crng.uniform_1d(k, b, crng.SLOT_BSDF_COMPONENT_PC)
        bs = B.sample(m, wo_l, u_b, uc, present)
        wi_c = frame.to_world(bs.wi)
        bsdf_beta = (bs.f * cm.absdot(wi_c, hit.ns)[:, None]
                     / torch.clamp(bs.pdf, min=1e-20)[:, None])
        cont = (found & delta & (bs.pdf > 0) & torch.any(bs.f > 0, -1)
                & ~have)
        c["beta"][lanes] = torch.where(cont[:, None], beta * bsdf_beta, beta)
        c["spec"][lanes] = cont
        return (lanes[cont], _offset_origin(hit.p, hit.ng, wi_c)[cont],
                wi_c[cont])

    # ---- photon pass --------------------------------------------------------
    def photon_pass(self, base_key, it: int, vp: VisiblePoints, radius):
        """(phi [P, 3], m_count [P]) of one pass's photons."""
        s, dev, P = self.s, self.device, self.P
        Nph = self.n_photons
        ids = torch.arange(Nph, dtype=torch.int32, device=dev)
        keys = crng.pixel_keys(crng.fold_in(base_key, 0x9E37), ids, it)
        u_sel = crng.uniform_1d(keys, 0, crng.SLOT_LIGHT_SELECT)
        light_id, sel = pick_lights(_light_power_pmf(s.scene), u_sel)
        u_pos = crng.uniform_2d(keys, 0, crng.SLOT_LIGHT_SAMPLE)
        u_dir = crng.uniform_2d(keys, 0, crng.SLOT_BSDF)
        o, d, beta = sample_le(s.scene, light_id, u_pos, u_dir)
        beta = beta / torch.clamp(sel, min=1e-12)[:, None] / Nph
        r2 = radius * radius
        lanes = torch.nonzero(torch.any(beta > 0, -1))[:, 0]
        o, d, beta = o[lanes], d[lanes], beta[lanes]
        acc = [torch.zeros((P, 3), device=dev), torch.zeros((P,), device=dev)]
        for b in range(s.icfg.max_depth):
            if lanes.numel() == 0:
                break
            lanes, o, d, beta = self._photon_step(keys, b, lanes, o, d, beta,
                                                  vp, r2, acc)
        return acc[0], acc[1]

    def _photon_step(self, keys, b: int, lanes, o, d, beta, vp, r2, acc):
        """One bounce of the photon pass on the live photons: deposits into
        acc = [phi, m_count] in place; returns the photons that live on,
        their next rays and throughput."""
        s, dev = self.s, self.device
        scene, bvh, present = s.scene, s.bvh, s.icfg.mat_types
        R = lanes.numel()
        k = keys[lanes]
        hit = intersect_scene(scene, o, d, torch.full((R,), cm.INF,
                                                      device=dev), bvh)
        found = hit.found
        if b > 0:
            # Every vertex but the first: direct light is the camera
            # pass's NEE (sppm.cpp skips depth 0).
            ph, mc = deposit_grid(vp, r2, hit.p, d, beta, found)
            acc[0] = acc[0] + ph
            acc[1] = acc[1] + mc

        m = B.gather_materials(scene, hit.mat_id, hit.uv, hit.p)
        frame = _frame(hit.ns)
        wo_l = frame.to_local(-d)
        u_b = crng.uniform_2d(k, b + 1, crng.SLOT_BSDF)
        uc = crng.uniform_1d(k, b + 1, crng.SLOT_BSDF_COMPONENT_PC)
        bs = B.sample(m, wo_l, u_b, uc, present)
        wi_c = frame.to_world(bs.wi)
        bnew = (beta * bs.f * cm.absdot(wi_c, hit.ns)[:, None]
                / torch.clamp(bs.pdf, min=1e-20)[:, None])
        # Russian roulette on the photon throughput.
        q = torch.clamp(1.0 - spec.luminance(bnew) / torch.clamp(
            spec.luminance(beta), min=1e-20), min=0.0)
        u_rr = crng.uniform_1d(k, b + 1, crng.SLOT_RR)
        live = found & (bs.pdf > 0) & torch.any(bs.f > 0, -1) & (u_rr >= q)
        bnew = bnew / torch.clamp(1.0 - q, min=1e-6)[:, None]
        return (lanes[live], _offset_origin(hit.p, hit.ng, wi_c)[live],
                wi_c[live], bnew[live])

    def _render_iteration(self, i: int) -> float:
        s = self.s
        base_key = crng.base_key(s.base_seed, device=self.device)
        it = self.n_iters
        cam = self.camera_pass(crng.fold_in(base_key, it))
        self.Ld = self.Ld + cam["Ld"]
        vp = VisiblePoints(s.scene, cam["vp_p"], cam["vp_wo"], cam["vp_mat"],
                           cam["vp_uv"], cam["vp_ns"], cam["have"],
                           s.icfg.mat_types)
        phi, m_count = self.photon_pass(base_key, it, vp, self.radius)
        # pbrt per-pixel update (sppm.cpp: "update pixel values").
        has_m = m_count > 0
        n_new = self.n_acc + ALPHA * m_count
        ratio = torch.where(has_m, n_new / torch.clamp(
            self.n_acc + m_count, min=1e-12), 1.0)
        r_new = self.radius * cm.sqrt(ratio)
        tau_new = (self.tau + cam["vp_beta"] * phi) * ratio[:, None]
        self.tau = torch.where(has_m[:, None], tau_new, self.tau)
        self.radius = torch.where(has_m, r_new, self.radius)
        self.n_acc = torch.where(has_m, n_new, self.n_acc)
        self.n_iters += 1
        self.total_photons += self.n_photons
        return float(self.n_photons * s.icfg.max_depth + self.P * 2)

    @property
    def film_mean(self):
        n = max(self.n_iters, 1)
        direct = self.Ld / n
        indirect = self.tau / (n * math.pi * torch.clamp(
            self.radius * self.radius, min=1e-12))[:, None]
        return direct + indirect
