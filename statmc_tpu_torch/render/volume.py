"""Volumetric path tracer (volpath) with participating media (port of
statmc_tpu/render/volume.py).

Re-derives the reference's VolPathIntegrator::Li
(src/integrators/volpath.cpp:54-188) and its media:

* HomogeneousMedium::Sample/Tr (src/media/homogeneous.cpp:44-77):
  channel-stratified exponential distance sampling, closed-form
  transmittance;
* GridDensityMedium::Sample/Tr (src/media/grid.cpp:47-115): delta
  tracking for the scattering event, ratio tracking for transmittance,
  trilinear density lookups in [0,1]^3 density space;
* the Henyey-Greenstein phase function (src/core/medium.cpp);
* attenuated NEE: shadow and BSDF/phase-MIS rays walk through
  null-material boundaries multiplying each segment's transmittance
  (Scene::IntersectTr, src/core/scene.cpp), a bounded loop of K closest
  hits (K = 1 without null materials);
* surface vertices as volpath.cpp:100-147 (NEE + BSDF sampling + etaScale
  Russian roulette from bounce 4).

Every lane runs max_depth + 1 + null_extra steps (medium and surface
vertices both consume a bounce, volpath.cpp:71; null pass-throughs do
not), and every draw is addressed by (pixel, sample, step, slot), the
tracking loops' by their iteration index too, exactly as in the JAX
package.  Where the JAX package runs each loop to its cap over every
lane, masked, this port stops each loop once no lane is still in it, and
runs a step and its tracking loops on the lanes still in them only,
gathered: a lane's draws do not depend on which other lanes run, and a
finished lane's state no longer changes, so every result is the same
(tests/test_torch_volume.py holds both forms bit for bit).  The keys of
(step, SLOT_TR) are folded once a step, not once an iteration, and a
loop's draws are made 8 iterations at a time for the lanes still in it
(the same threefry values, in an eighth of the launches).
"""
from __future__ import annotations

import math

import torch

from .. import spans
from ..core import math as cm
from ..core import rng as crng
from ..scene import build as sb
from . import bsdf as B
from . import lights as LT
from .albedo_lut import albedo_from_curves
from .integrator import (IntegratorConfig, SampleOutput, _approx_albedo,
                         _offset_origin, _scrub_ls, power_heuristic)
from .intersect import PRIM_TRI, Hit, intersect_scene
from .lightdistrib import sample_light_id

BIG = 1e8  # stands in for an infinite ray extent (escaped rays)
GRID_SAMPLE_STEPS = 256  # delta-tracking step cap (E[steps] ~ maxD*st*L)
GRID_TR_STEPS = 128  # ratio-tracking step cap per segment
# Key stride between transmittance_walk segments: each segment's
# ratio-tracking loop draws GRID_TR_STEPS iterations of SLOT_TR, so
# adjacent segments sit that far apart in key space.
_SEG_KEY_STRIDE = GRID_TR_STEPS

# When a list, trace_volpath appends ("step", lanes it runs on, step)
# before each bounce step and ("paths", paths, paths with a medium
# vertex, paths that entered a grid medium) at its end; every tracking
# loop appends (kind, lanes, iterations run) and every transmittance
# walk ("walk", lanes walking at its start, segments run): what
# chip_smoke.py reports.  None records nothing (and synchronises
# nothing).
track_stats = None


def _record(kind: str, *counts) -> None:
    if track_stats is not None:
        track_stats.append((kind, *counts))


def _live_lanes(mask):
    """The indices of the lanes where `mask` holds, or None when none
    does (one host synchronisation)."""
    lanes = torch.nonzero(mask)[:, 0]
    return lanes if lanes.numel() else None


def _any_lane(mask) -> bool:
    return bool(mask.any())


def _step_lanes(active):
    """The lanes a bounce step of trace_volpath runs on: the active ones
    (None when none is)."""
    return _live_lanes(active)


def _log1p(x):
    """log1p in float64, rounded once: the same float on the CPU and the
    card, where the tracking decisions compare it with uniforms."""
    return torch.log1p(x.double()).float()


def _exp(x):
    return torch.exp(x.double()).float()


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function (core/medium.h: the value is the pdf).
# ---------------------------------------------------------------------------


def hg_phase(g, cos_theta):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * math.pi * denom
                            * cm.sqrt(torch.clamp(denom, min=1e-12)))


def sample_hg(g, wo, u2):
    """Sample wi around -wo's axis (medium.cpp HenyeyGreenstein::Sample_p
    measures theta from wo and builds the frame around wo; the returned
    direction continues the path)."""
    g_safe = torch.where(torch.abs(g) < 1e-3, 1e-3, g)
    one = torch.ones_like(g_safe)
    # 1 + g^2 - sq^2 cancels; its products are fused as the JAX
    # package's compiled code fuses them.
    sq = cm.fma(-g_safe, g_safe, one) / cm.fma(-2.0 * g_safe, u2[:, 0],
                                               1.0 + g_safe)
    cos_t = torch.where(
        torch.abs(g) < 1e-3, 1.0 - 2.0 * u2[:, 0],
        -cm.fma(-sq, sq, cm.fma(g_safe, g_safe, one)) / (2.0 * g_safe))
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = cm.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi * u2[:, 1]).double()
    frame = B.ShadingFrame.from_normal(wo)
    local = torch.stack([sin_t * torch.cos(phi).float(),
                         sin_t * torch.sin(phi).float(), cos_t], dim=-1)
    return frame.to_world(local)


# ---------------------------------------------------------------------------
# Media lookups
# ---------------------------------------------------------------------------


def _apply44_p(m, p):
    """Homogeneous point transform, elementwise ([P,4,4] x [P,3])."""
    x = m[:, 0, 0] * p[:, 0] + m[:, 0, 1] * p[:, 1] + m[:, 0, 2] * p[:, 2] \
        + m[:, 0, 3]
    y = m[:, 1, 0] * p[:, 0] + m[:, 1, 1] * p[:, 1] + m[:, 1, 2] * p[:, 2] \
        + m[:, 1, 3]
    z = m[:, 2, 0] * p[:, 0] + m[:, 2, 1] * p[:, 1] + m[:, 2, 2] * p[:, 2] \
        + m[:, 2, 3]
    return torch.stack([x, y, z], dim=-1)


def _apply44_v(m, v):
    x = m[:, 0, 0] * v[:, 0] + m[:, 0, 1] * v[:, 1] + m[:, 0, 2] * v[:, 2]
    y = m[:, 1, 0] * v[:, 0] + m[:, 1, 1] * v[:, 1] + m[:, 1, 2] * v[:, 2]
    z = m[:, 2, 0] * v[:, 0] + m[:, 2, 1] * v[:, 1] + m[:, 2, 2] * v[:, 2]
    return torch.stack([x, y, z], dim=-1)


# The 8 lattice corners of a trilinear lookup, (x, y, z) offsets in the
# order the lerps below consume them.
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _grid_density(scene: sb.SceneTables, midx, p):
    """Trilinear density at p in [0,1]^3 density space; 0 outside
    (grid.cpp:47-61 Density + the D() out-of-range clamp).  The 8
    corners are one gather."""
    midx = midx.long()
    nxyz = scene.med_nxyz[midx].long()
    ps = p * nxyz.to(torch.float32) - 0.5
    pf = torch.floor(ps)
    dd = ps - pf
    G = scene.med_grid
    corners = torch.tensor(_CORNERS, device=p.device)
    idx = pf.to(torch.int64)[:, None, :] + corners[None]  # [P, 8, (x,y,z)]
    ok = ((idx >= 0) & (idx < nxyz[:, None, :])).all(-1)
    top = torch.tensor([G.shape[3] - 1, G.shape[2] - 1, G.shape[1] - 1],
                       device=p.device)
    idx = torch.minimum(torch.clamp(idx, min=0), top)
    v = torch.where(ok, G[midx[:, None], idx[..., 2], idx[..., 1],
                          idx[..., 0]], 0.0)
    dx, dy, dz = dd[:, 0], dd[:, 1], dd[:, 2]
    d00 = v[:, 0] * (1 - dx) + v[:, 1] * dx
    d10 = v[:, 2] * (1 - dx) + v[:, 3] * dx
    d01 = v[:, 4] * (1 - dx) + v[:, 5] * dx
    d11 = v[:, 6] * (1 - dx) + v[:, 7] * dx
    d0 = d00 * (1 - dy) + d10 * dy
    d1 = d01 * (1 - dy) + d11 * dy
    return d0 * (1 - dz) + d1 * dz


def _unit_cube_range(om, dm, tmax):
    """Ray overlap [t0, t1] with [0,1]^3 (Bounds3f::IntersectP)."""
    inv = torch.where(torch.abs(dm) > 1e-12, 1.0 / dm,
                      torch.where(dm >= 0, 1e12, -1e12))
    t_lo = (0.0 - om) * inv
    t_hi = (1.0 - om) * inv
    tn = torch.minimum(t_lo, t_hi)
    tf = torch.maximum(t_lo, t_hi)
    t0 = torch.clamp(torch.max(tn, dim=-1).values, min=0.0)
    t1 = torch.minimum(torch.min(tf, dim=-1).values, tmax)
    return t0, t1, t0 <= t1


def _tr_key(keys, step, slot: int, it):
    """Per-lane key of a tracking-loop iteration's draws: (step, slot,
    iteration) folded into the per-(pixel, sample) keys."""
    return crng.fold_in(crng._site_keys(keys, step, slot), it)


def _tr_site(keys, step):
    """The (step, SLOT_TR) keys, folded once a step; a tracking
    iteration folds only its index into them (_tr_key)."""
    return crng._site_keys(keys, step, crng.SLOT_TR)


# Tracking iterations whose draws are made together: one threefry call
# for a block of iterations of the lanes still tracking (each lane's
# values are those of its own iteration keys; a lane that leaves the
# loop early leaves its block's later draws unused).
_DRAW_BLOCK = 8


def _iteration_uniforms(site, its):
    """The two uniforms of each tracking iteration in `its` (an int
    tensor [C]) of each lane: its (step, SLOT_TR) keys with the
    iteration folded in.  Returns [L, C, 2]."""
    return crng.uniform(crng.fold_in(site[:, None, :], its[None, :]), (2,))


class _Draws:
    """The tracking loop's uniforms, made _DRAW_BLOCK iterations at a
    time for the lanes still in the loop: at(i) is iteration i's [L, 2]
    for the current lanes; keep(mask) drops the lanes that left."""

    def __init__(self, site, lanes, it_base: int, cap: int):
        self.site, self.lanes, self.base, self.cap = site, lanes, it_base, cap
        self.block = self.row = None

    def at(self, i: int):
        if i % _DRAW_BLOCK == 0:
            its = torch.arange(self.base + i,
                               self.base + min(i + _DRAW_BLOCK, self.cap),
                               device=self.site.device)
            self.block = _iteration_uniforms(self.site[self.lanes], its)
            self.row = torch.arange(self.lanes.numel(),
                                    device=self.site.device)
        return self.block[self.row, i % _DRAW_BLOCK]

    def keep(self, mask):
        self.lanes, self.row = self.lanes[mask], self.row[mask]
        return self.lanes


def _delta_tracking(scene, midx, om, dm, t0, t1, st0, imd, lanes, site):
    """Delta tracking (grid.cpp:63-72) on `lanes`, each from t0 until it
    escapes past t1 or meets a real collision.  Returns (t [P], scattered
    [P]); lanes outside `lanes` keep t0 and do not scatter."""
    t = t0.clone()
    scat = torch.zeros_like(t0, dtype=torch.bool)
    n_in = lanes.numel()
    draws = _Draws(site, lanes, 0, GRID_SAMPLE_STEPS)
    i = 0
    while i < GRID_SAMPLE_STEPS and lanes.numel():
        uu = draws.at(i)
        t_new = t[lanes] - _log1p(-uu[:, 0]) * imd[lanes] / st0[lanes]
        esc = t_new >= t1[lanes]
        dens = _grid_density(scene, midx[lanes],
                             om[lanes] + dm[lanes] * t_new[:, None])
        real = dens * imd[lanes] > uu[:, 1]
        t[lanes] = t_new
        scat[lanes] = ~esc & real
        lanes = draws.keep(~(esc | real))
        i += 1
    _record("delta", n_in, i)
    return t, scat


def _ratio_tracking(scene, midx, om, dm, t0, t1, st0, imd, lanes, site,
                    it_base: int):
    """Ratio tracking with Russian roulette (grid.cpp:75-115) on `lanes`,
    iteration i drawing key it_base + i.  Returns tr [P]: 1 off `lanes`."""
    tr = torch.ones_like(t0)
    t = t0.clone()
    n_in = lanes.numel()
    draws = _Draws(site, lanes, it_base, GRID_TR_STEPS)
    i = 0
    while i < GRID_TR_STEPS and lanes.numel():
        uu = draws.at(i)
        t_new = t[lanes] - _log1p(-uu[:, 0]) * imd[lanes] / st0[lanes]
        esc = t_new >= t1[lanes]
        dens = _grid_density(scene, midx[lanes],
                             om[lanes] + dm[lanes] * t_new[:, None])
        tr_l = tr[lanes]
        tr_new = tr_l * (1.0 - torch.clamp(dens * imd[lanes], min=0.0))
        q = torch.clamp(1.0 - tr_new, min=0.05)
        rr = tr_new < 0.1
        killed = rr & (uu[:, 1] < q)
        tr_new = torch.where(killed, 0.0, torch.where(rr, tr_new / (1.0 - q),
                                                      tr_new))
        tr[lanes] = torch.where(esc, tr_l, tr_new)
        t[lanes] = t_new
        lanes = draws.keep(~(esc | killed))
        i += 1
    _record("ratio", n_in, i)
    return tr


def _grid_setup(scene, midx, o, d, tmax):
    """Density-space ray, its overlap with the grid and the grid's
    tracking constants.  The ray keeps its world-distance parameter
    through the transform (pbrt transforms o and d without
    renormalizing, so sigma_t applies to t directly)."""
    w2m = scene.med_w2m[midx]
    om = _apply44_p(w2m, o)
    dm = _apply44_v(w2m, d)
    t0, t1, inbox = _unit_cube_range(om, dm, tmax)
    st0 = torch.clamp(scene.med_sigt0[midx], min=1e-20)
    imd = scene.med_inv_maxd[midx]
    return om, dm, t0, t1, inbox, st0, imd


def sample_medium(scene: sb.SceneTables, cfg: IntegratorConfig, med, o, d,
                  t_hit, keys, step, live=None, site=None):
    """Sample a scattering event in [0, t_hit) along unit d.

    Returns (t [P], sampled [P] bool, weight [P,3]): the beta factor is
    Tr*sigma_s/pdf on a scatter, Tr/pdf on pass-through
    (homogeneous.cpp:50-77; grid.cpp:63-72 delta tracking).  Meaningful
    only where med >= 0 and `live` (default: every lane) holds; delta
    tracking runs on those lanes of grid media only.  site: the (step,
    SLOT_TR) keys, when the caller has folded them."""
    P = o.shape[0]
    midx = torch.clamp(med, min=0).long()
    sa = scene.med_sigma_a[midx]
    ss = scene.med_sigma_s[midx]
    st = sa + ss  # [P,3]
    u = crng.uniform_2d(keys, step, crng.SLOT_MEDIUM)

    with spans.span("volume.sample_medium"):
        # Homogeneous closed form.
        chan = torch.clamp((u[:, 0] * 3).to(torch.int32), max=2).long()
        st_c = torch.gather(st, 1, chan[:, None])[:, 0]
        dist = -_log1p(-u[:, 1]) / torch.clamp(st_c, min=1e-20)
        t_h = torch.minimum(dist, t_hit)
        sampled_h = dist < t_hit
        tr = _exp(-st * torch.clamp(t_h, max=BIG)[:, None])
        density = torch.where(sampled_h[:, None], st * tr, tr)
        pdf = (density[:, 0] + density[:, 1] + density[:, 2]) / 3.0
        pdf = torch.where(pdf <= 0, 1.0, pdf)
        w_h = torch.where(sampled_h[:, None], tr * ss, tr) / pdf[:, None]

        if not cfg.has_grid_media:
            return t_h, sampled_h, w_h

        # Grid delta tracking in density space (grid.cpp:63-72).
        is_grid = scene.med_kind[midx] == 1
        om, dm, t0, t1, inbox, st0, imd = _grid_setup(scene, midx, o, d,
                                                      t_hit)
        run = is_grid & (med >= 0) & inbox
        if live is not None:
            run = run & live
        lanes = _live_lanes(run)
        if lanes is None:
            t_m, scat = t0, torch.zeros_like(sampled_h)
        else:
            if site is None:
                site = _tr_site(keys, step)
            t_m, scat = _delta_tracking(scene, midx, om, dm, t0, t1, st0,
                                        imd, lanes, site)
        t_g = torch.minimum(t_m, t_hit)
        w_g = torch.where(scat[:, None], ss / torch.clamp(st, min=1e-20),
                          torch.ones((P, 3), device=o.device))
        return (torch.where(is_grid, t_g, t_h),
                torch.where(is_grid, scat, sampled_h),
                torch.where(is_grid[:, None], w_g, w_h))


def _segment_tr(scene: sb.SceneTables, cfg: IntegratorConfig, med, o, d,
                seg, keys, step, it_base: int, live=None, site=None):
    """Transmittance through one medium segment of length seg along unit
    d (homogeneous closed form; grid ratio tracking, grid.cpp:75-115).
    Returns [P,3]; 1 where med < 0.  Ratio tracking runs on the lanes of
    grid media where `live` (default: every lane) holds; the others'
    values are those of lanes that never enter the loop."""
    midx = torch.clamp(med, min=0).long()
    st = scene.med_sigma_a[midx] + scene.med_sigma_s[midx]
    seg_c = torch.clamp(seg, 0.0, BIG)
    tr_h = _exp(-st * seg_c[:, None])

    if cfg.has_grid_media:
        with spans.span("volume.segment_tr"):
            is_grid = scene.med_kind[midx] == 1
            om, dm, t0, t1, inbox, st0, imd = _grid_setup(scene, midx, o, d,
                                                          seg_c)
            run = is_grid & (med >= 0) & inbox
            if live is not None:
                run = run & live
            lanes = _live_lanes(run)
            if lanes is None:
                tr_g = torch.ones_like(t0)
            else:
                if site is None:
                    site = _tr_site(keys, step)
                tr_g = _ratio_tracking(scene, midx, om, dm, t0, t1, st0, imd,
                                       lanes, site, it_base)
            tr_h = torch.where(is_grid[:, None], tr_g[:, None], tr_h)

    return torch.where((med >= 0)[:, None], tr_h, 1.0)


def _crossing_medium(scene: sb.SceneTables, hit, d, med):
    """Medium on the far side of a crossed surface: the shape's inside
    medium when the ray travels against the outward geometric normal,
    its outside medium otherwise (core/interaction.h GetMedium(w)).  Like
    the JAX package, a shape without a MediumInterface gives -1 (vacuum)
    here, where pbrt keeps the ray's medium (ROADMAP.md section C)."""
    n_tri = scene.tri_med_in.shape[0]
    n_sph = scene.sph_med_in.shape[0]
    none = torch.full_like(med, -1)
    ti = torch.clamp(hit.prim_idx, 0, max(n_tri, 1) - 1).long()
    si = torch.clamp(hit.prim_idx, 0, max(n_sph, 1) - 1).long()
    is_tri = hit.prim_kind == PRIM_TRI
    m_in = torch.where(is_tri, scene.tri_med_in[ti] if n_tri else none,
                       scene.sph_med_in[si] if n_sph else none)
    m_out = torch.where(is_tri, scene.tri_med_out[ti] if n_tri else none,
                        scene.sph_med_out[si] if n_sph else none)
    entering = cm.dot(d, hit.ng) < 0
    return torch.where(hit.found, torch.where(entering, m_in, m_out), med)


def _merge_hit(fresh, new: Hit, old: Hit) -> Hit:
    """new on the lanes where `fresh` holds, old elsewhere (fields that
    are None stay None)."""
    def pick(a, b):
        if a is None:
            return None
        f = fresh.reshape(fresh.shape + (1,) * (a.dim() - 1))
        return torch.where(f, a, b)

    return Hit(*[pick(a, b) for a, b in zip(new, old)])


def transmittance_walk(scene: sb.SceneTables, bvh, cfg: IntegratorConfig,
                       med0, o, d, t_max, keys, step, slot_tag: int,
                       site=None):
    """Walk a ray through media and null boundaries accumulating Tr
    (Scene::IntersectTr, src/core/scene.cpp:57-77).

    Returns (tr [P,3], hit, real): hit is the first real-material surface
    (or light) within t_max where real holds; tr excludes that surface's
    blocking (shadow rays zero it, MIS rays read its Le).  K segments
    bound the loop: K = 1 without null materials (cfg.null_extra == 0),
    else 1 + null_extra, so the walk crosses as many null interfaces as
    the bounce loop budgets pass-throughs for.  The loop stops once no
    lane is still walking: a later segment would multiply tr by 1 and
    leave hit and real as they are."""
    P = o.shape[0]
    K = 1 + cfg.null_extra if cfg.null_extra else 1
    tr = torch.ones((P, 3), device=o.device)
    cur_o = o
    med = med0
    remaining = t_max
    walking = t_max > 0
    first = real_any = None
    with spans.span("volume.walk"):
        n_in, segs = int(walking.sum()) if track_stats is not None else 0, 0
        for k in range(K):
            if k and not _any_lane(walking):
                break
            segs += 1
            hit = intersect_scene(scene, cur_o, d,
                                  torch.where(walking, remaining, 0.0), bvh)
            seg = torch.minimum(torch.where(hit.found, hit.t, BIG),
                                remaining)
            # Key spacing: _segment_tr draws it_base + i with i <
            # GRID_TR_STEPS, and distance sampling uses iterations
            # 0..GRID_SAMPLE_STEPS-1 of the same SLOT_TR keys; segments
            # sit a full loop cap apart and slot tags 16 segments apart,
            # so no (step, slot, iteration) key repeats.
            tr = tr * torch.where(
                walking[:, None],
                _segment_tr(scene, cfg, med, cur_o, d, seg, keys, step,
                            it_base=(GRID_SAMPLE_STEPS + _SEG_KEY_STRIDE
                                     * (16 * slot_tag + k)),
                            live=walking, site=site),
                1.0)
            is_hit = hit.found & walking
            null_mat = scene.mat_type[hit.mat_id.long()] == sb.MAT_NONE
            real = is_hit & ~null_mat
            masked = hit._replace(
                prim_kind=torch.where(real, hit.prim_kind, 0),
                light_id=torch.where(real, hit.light_id, -1))
            if first is None:
                first, real_any = masked, real
            else:
                fresh = real & ~real_any
                first = _merge_hit(fresh, masked, first)
                real_any = real_any | fresh
            # Cross null boundaries and continue.
            cross = is_hit & null_mat
            med = torch.where(cross, _crossing_medium(scene, hit, d, med),
                              med)
            remaining = torch.where(cross, remaining - hit.t, remaining)
            cur_o = torch.where(cross[:, None], hit.p + d * 1e-4, cur_o)
            walking = cross
        _record("walk", n_in, segs)
    return tr, first, real_any


# ---------------------------------------------------------------------------
# The volpath bounce loop
# ---------------------------------------------------------------------------


def _zero_carry(o0, d0, cam_medium: int) -> dict:
    P, dev = o0.shape[0], o0.device

    def z(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype, device=dev)

    return dict(
        o=o0, d=d0, L=z(P, 3), beta=torch.ones((P, 3), device=dev),
        specular=z(P, dtype=torch.bool),
        active=torch.ones((P,), dtype=torch.bool, device=dev),
        eta_scale=torch.ones((P,), device=dev),
        med=torch.full((P,), cam_medium, dtype=torch.int32, device=dev),
        bounce=z(P, dtype=torch.int32), mat_id=z(P), depth=z(P),
        normal=z(P, 3), albedo=z(P, 3), n_rays=z(P), path_len=z(P),
        cum_t=z(P), scattered=z(P, dtype=torch.bool),
        in_grid=z(P, dtype=torch.bool))


def _volpath_step(scene, bvh, dist, cfg: IntegratorConfig, carry: dict,
                  step: int, keys, albedo_luts=None) -> dict:
    """One bounce step over every lane of `carry` (volpath.cpp:62-187):
    the closest hit, medium sampling, then a medium vertex (phase NEE +
    phase continuation), a surface vertex (BSDF NEE + continuation) or a
    null pass-through, and Russian roulette.  Returns the new carry."""
    dev = carry["o"].device
    o, d = carry["o"], carry["d"]
    active = carry["active"]
    bl = carry["bounce"]
    med = carry["med"]
    beta = carry["beta"]
    L = carry["L"]
    site = _tr_site(keys, step) if cfg.has_grid_media else None
    present = cfg.mat_types

    hit = intersect_scene(scene, o, d, torch.where(active, cm.INF, 0.0),
                          bvh)
    found = hit.found & active
    t_hit = torch.where(found, hit.t, BIG)

    # --- medium event sampling (volpath.cpp:76-78) -----------------------
    in_med = active & (med >= 0)
    t_m, sampled_m, w_m = sample_medium(scene, cfg, med, o, d, t_hit, keys,
                                        step, live=in_med, site=site)
    beta = beta * torch.where(in_med[:, None], w_m, 1.0)
    beta_dead = torch.all(beta <= 0, dim=-1)
    mi = in_med & sampled_m & ~beta_dead

    # --- surface emission (volpath.cpp:100-110) --------------------------
    emit = ((bl == 0) | carry["specular"]) & ~mi & active & ~beta_dead
    le_hit = LT.area_light_le(scene, hit.light_id, hit.ng, -d)
    le_esc = LT.escaped_radiance(scene, d)
    le = torch.where(found[:, None], le_hit,
                     torch.where(active[:, None], le_esc, 0.0))
    L = L + torch.where(emit[:, None], beta * le, 0.0)

    depth_ok = bl < cfg.max_depth

    # =================== medium vertex ===================================
    m_vert = mi & depth_ok
    p_m = o + d * t_m[:, None]
    g = scene.med_g[torch.clamp(med, min=0).long()]

    # Light half of EstimateDirect (phase f == pdf).  The light selection
    # point is the vertex (medium or surface), so spatial distributions
    # look up the right voxel.
    u_sel = crng.uniform_1d(keys, step, crng.SLOT_LIGHT_SELECT)
    p_sel = torch.where(mi[:, None], p_m, hit.p)
    light_id, sel_pmf = sample_light_id(dist, u_sel, p_sel)
    u_light = crng.uniform_2d(keys, step, crng.SLOT_LIGHT_SAMPLE)
    lsamp = LT.sample_li(scene, light_id, p_m, torch.zeros_like(p_m),
                         u_light)
    ph_l = hg_phase(g, cm.dot(-d, lsamp.wi))
    lvalid = (m_vert & (lsamp.pdf > 0) & torch.any(lsamp.li > 0, -1)
              & (ph_l > 0))
    # Infinite/distant lights: pbrt's VisibilityTester endpoint is
    # p + 2*worldRadius*wi (infinite.cpp Sample_Li), so media attenuate
    # over that length, not over an unbounded ray.
    two_r = 2.0 * scene.world_radius
    sh_len = torch.clamp(lsamp.dist, max=two_r) * 0.999
    tr_l, _, blocked = transmittance_walk(
        scene, bvh, cfg, med, p_m, lsamp.wi,
        torch.where(lvalid, torch.clamp(sh_len, min=0.0), 0.0),
        keys, step, slot_tag=1, site=site)
    li_l = torch.where((lvalid & ~blocked)[:, None], lsamp.li * tr_l, 0.0)
    w_l = torch.where(lsamp.is_delta, 1.0,
                      power_heuristic(1.0, lsamp.pdf, 1.0, ph_l))
    contr_l = (ph_l[:, None] * li_l * w_l[:, None]
               / torch.clamp(lsamp.pdf, min=1e-30)[:, None])

    # Phase half.
    u_ph = crng.uniform_2d(keys, step, crng.SLOT_PHASE_NEE)
    wi_ph = sample_hg(g, -d, u_ph)
    ph_p = hg_phase(g, cm.dot(-d, wi_ph))
    pvalid = m_vert & ~lsamp.is_delta & (ph_p > 0)
    tr_p, hit_p, real_p = transmittance_walk(
        scene, bvh, cfg, med, p_m, wi_ph,
        torch.where(pvalid, cm.INF, 0.0), keys, step, slot_tag=2, site=site)
    same_light = real_p & (hit_p.light_id == light_id)
    li_p_hit = LT.area_light_le(scene, hit_p.light_id, hit_p.ng, -wi_ph)
    is_inf = scene.light_kind[light_id.long()] == sb.LIGHT_INFINITE
    li_p_esc = torch.where(is_inf[:, None],
                           LT.escaped_radiance(scene, wi_ph), 0.0)
    li_p = torch.where(same_light[:, None], li_p_hit,
                       torch.where(real_p[:, None], 0.0, li_p_esc))
    lpdf_p = LT.pdf_li(scene, light_id, p_m, wi_ph, hit_p.p, hit_p.ng,
                       real_p)
    w_p = power_heuristic(1.0, ph_p, 1.0, lpdf_p)
    contr_p = tr_p * li_p * w_p[:, None]  # f/pdf == 1 for HG
    contr_p = torch.where((pvalid & (lpdf_p > 0))[:, None]
                          | (pvalid & ~real_p & is_inf)[:, None],
                          contr_p, 0.0)

    ld_m = (contr_l + contr_p) / torch.clamp(sel_pmf, min=1e-30)[:, None]
    L = L + torch.where(m_vert[:, None], beta * ld_m, 0.0)

    # Phase-sampled continuation (beta unchanged: f/pdf == 1).
    u_pc_m = crng.uniform_2d(keys, step, crng.SLOT_PHASE)
    wi_m = sample_hg(g, -d, u_pc_m)

    # =================== surface vertex ==================================
    cum_t = carry["cum_t"] + torch.where(found, hit.t, 0.0)
    cone_w = cfg.cone0 + cfg.cone_spread * cum_t
    m = B.gather_materials(scene, hit.mat_id, hit.uv, hit.p,
                           uv_fp=cone_w * hit.uv_density)
    null_mat = m.mat_type == sb.MAT_NONE
    s_vert = found & ~mi & depth_ok & ~null_mat & ~beta_dead
    pass_through = found & ~mi & depth_ok & null_mat & ~beta_dead

    frame = B.ShadingFrame.from_normal(torch.where(
        torch.any(hit.ns != 0, -1, keepdim=True), hit.ns,
        torch.tensor([0.0, 0.0, 1.0], device=dev)))
    wo_l = frame.to_local(-d)

    # Bounce-0 feature capture (the G-buffers work under volpath too).
    first = (bl == 0) & s_vert
    carry_mat = torch.where(first, (hit.mat_id + 1).to(torch.float32),
                            carry["mat_id"])
    carry_depth = torch.where(first, hit.t, carry["depth"])
    carry_normal = torch.where(first[:, None], hit.ns, carry["normal"])
    if albedo_luts is not None:
        alb = albedo_from_curves(albedo_luts[0], albedo_luts[1], hit.mat_id,
                                 m.kd, B.cos_theta(wo_l))
    else:
        alb = _approx_albedo(m, B.cos_theta(wo_l))
    carry_albedo = torch.where(first[:, None], alb, carry["albedo"])

    # NEE (volpath.cpp:124-127; attenuated visibility).
    nee = s_vert & ~B.is_specular(m)
    lsamp_s = LT.sample_li(scene, light_id, hit.p, hit.ng, u_light)
    wi_sl = frame.to_local(lsamp_s.wi)
    f_l, pdf_scat = B.evaluate(m, wo_l, wi_sl, present)
    f_l = f_l * cm.absdot(lsamp_s.wi, hit.ns)[:, None]
    svalid = (nee & (lsamp_s.pdf > 0) & torch.any(lsamp_s.li > 0, -1)
              & torch.any(f_l > 0, -1))
    sh_o = _offset_origin(hit.p, hit.ng, lsamp_s.wi)
    med_sh = _crossing_medium(scene, hit, lsamp_s.wi, med)
    sh_len_s = torch.clamp(lsamp_s.dist, max=two_r) * 0.999
    tr_s, _, blocked_s = transmittance_walk(
        scene, bvh, cfg, med_sh, sh_o, lsamp_s.wi,
        torch.where(svalid, torch.clamp(sh_len_s, min=0.0), 0.0),
        keys, step, slot_tag=3, site=site)
    li_s = torch.where((svalid & ~blocked_s)[:, None], lsamp_s.li * tr_s,
                       0.0)
    w_sl = torch.where(lsamp_s.is_delta, 1.0,
                       power_heuristic(1.0, lsamp_s.pdf, 1.0, pdf_scat))
    contr_sl = (f_l * li_s * w_sl[:, None]
                / torch.clamp(lsamp_s.pdf, min=1e-30)[:, None])

    # BSDF half.
    u_bs = crng.uniform_2d(keys, step, crng.SLOT_BSDF_NEE)
    uc_bs = crng.uniform_1d(keys, step, crng.SLOT_BSDF_COMPONENT)
    bsmp = B.sample(m, wo_l, u_bs, uc_bs, present)
    wi_b = frame.to_world(bsmp.wi)
    f_b = bsmp.f * cm.absdot(wi_b, hit.ns)[:, None]
    bvalid = (nee & ~lsamp_s.is_delta & (bsmp.pdf > 0)
              & torch.any(f_b > 0, -1))
    bs_o = _offset_origin(hit.p, hit.ng, wi_b)
    med_b = _crossing_medium(scene, hit, wi_b, med)
    tr_b, hit_b, real_b = transmittance_walk(
        scene, bvh, cfg, med_b, bs_o, wi_b,
        torch.where(bvalid, cm.INF, 0.0), keys, step, slot_tag=4, site=site)
    same_l_b = real_b & (hit_b.light_id == light_id)
    li_b_hit = LT.area_light_le(scene, hit_b.light_id, hit_b.ng, -wi_b)
    li_b_esc = torch.where(is_inf[:, None],
                           LT.escaped_radiance(scene, wi_b), 0.0)
    li_b = torch.where(same_l_b[:, None], li_b_hit,
                       torch.where(real_b[:, None], 0.0, li_b_esc))
    lpdf_b = LT.pdf_li(scene, light_id, hit.p, wi_b, hit_b.p, hit_b.ng,
                       real_b)
    w_bb = torch.where(bsmp.specular, 1.0,
                       power_heuristic(1.0, bsmp.pdf, 1.0, lpdf_b))
    contr_bb = (f_b * (tr_b * li_b) * w_bb[:, None]
                / torch.clamp(bsmp.pdf, min=1e-30)[:, None])
    contr_bb = torch.where(
        (bvalid & (bsmp.specular | (lpdf_b > 0)))[:, None]
        | (bvalid & ~real_b & is_inf)[:, None], contr_bb, 0.0)

    ld_s = ((torch.where(svalid[:, None], contr_sl, 0.0) + contr_bb)
            / torch.clamp(sel_pmf, min=1e-30)[:, None])
    L = L + torch.where(nee[:, None], beta * ld_s, 0.0)

    # BSDF continuation (volpath.cpp:129-147).
    u_pc = crng.uniform_2d(keys, step, crng.SLOT_BSDF)
    uc_pc = crng.uniform_1d(keys, step, crng.SLOT_BSDF_COMPONENT_PC)
    psmp = B.sample(m, wo_l, u_pc, uc_pc, present)
    wi_c = frame.to_world(psmp.wi)
    bsdf_beta = (psmp.f * cm.absdot(wi_c, hit.ns)[:, None]
                 / torch.clamp(psmp.pdf, min=1e-30)[:, None])
    dead_s = s_vert & (torch.all(psmp.f <= 0, -1) | (psmp.pdf <= 0))
    eta2 = m.eta[:, 0] ** 2
    entering = cm.dot(-d, hit.ng) > 0
    eta_mul = torch.where(
        psmp.specular & psmp.transmission & s_vert,
        torch.where(entering, eta2, 1.0 / torch.clamp(eta2, min=1e-9)), 1.0)

    # ---- merge the three vertex kinds -----------------------------------
    new_beta = torch.where(s_vert[:, None], beta * bsdf_beta, beta)
    d_new = torch.where(m_vert[:, None], wi_m,
                        torch.where(pass_through[:, None], d,
                                    torch.where(s_vert[:, None], wi_c, d)))
    o_surf = _offset_origin(hit.p, hit.ng, d_new)
    o_new = torch.where(
        m_vert[:, None], p_m,
        torch.where(pass_through[:, None], hit.p + d * 1e-4,
                    torch.where(s_vert[:, None], o_surf, o)))
    # Medium transitions: continuation rays crossing a surface pick up the
    # far side's medium (transmission: d_new on the same side of ng as the
    # incoming d); medium vertices stay in theirs.
    crossed = cm.dot(d_new, hit.ng) * cm.dot(d, hit.ng) > 0
    med_new = torch.where(pass_through | (s_vert & crossed),
                          _crossing_medium(scene, hit, d_new, med), med)
    spec_new = torch.where(m_vert, False,
                           torch.where(pass_through, carry["specular"],
                                       psmp.specular))
    eta_scale = carry["eta_scale"] * torch.where(dead_s, 1.0, eta_mul)

    active = active & ~beta_dead & (m_vert | pass_through
                                    | (s_vert & ~dead_s))

    # Russian roulette (volpath.cpp:179-187: bounces > 3).
    rr_beta_max = torch.max(new_beta * eta_scale[:, None], dim=-1).values
    q = torch.clamp(1.0 - rr_beta_max, min=0.05)
    u_rr = crng.uniform_1d(keys, step, crng.SLOT_RR)
    do_rr = (bl > 3) & active & (rr_beta_max < cfg.rr_threshold)
    killed = do_rr & (u_rr < q)
    active = active & ~killed
    new_beta = torch.where((do_rr & ~killed)[:, None],
                           new_beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                           new_beta)

    n_rays = (carry["n_rays"] + carry["active"].to(torch.float32)
              + 2.0 * (m_vert | nee).to(torch.float32))
    path_len = carry["path_len"] + (m_vert | s_vert).to(torch.float32)
    bl_new = bl + torch.where(pass_through, 0, 1).to(torch.int32)
    # Whether the path has had a medium vertex, and has been in a grid
    # medium (read by track_stats only).
    in_grid = carry["in_grid"] | (
        (med_new >= 0) & (scene.med_kind[torch.clamp(med_new, min=0).long()]
                          == 1))
    return dict(
        o=o_new, d=d_new, L=L, beta=new_beta, specular=spec_new,
        active=active, eta_scale=eta_scale, med=med_new, bounce=bl_new,
        mat_id=carry_mat, depth=carry_depth, normal=carry_normal,
        albedo=carry_albedo, n_rays=n_rays, path_len=path_len, cum_t=cum_t,
        scattered=carry["scattered"] | m_vert, in_grid=in_grid)


def trace_volpath(scene, bvh, dist, cfg: IntegratorConfig, o0, d0, keys,
                  avg_ls, win_bsdf, win_light, feedback_on: bool,
                  albedo_luts=None, ld_stream=None) -> SampleOutput:
    """The media-aware bounce loop, with integrator.trace's SampleOutput
    contract, so the film, moments and denoiser work unchanged.  Ls[0]
    carries the film estimate; the per-bounce tallies, SMIS and ACRR are
    statpath features volpath does not have (volpath.cpp has neither) and
    stay zero (avg_ls, win_bsdf, win_light and feedback_on are unused).
    Every draw is a threefry uniform under every sampler mode, as in the
    JAX package, so ld_stream is unused too.

    Each of the max_depth + 1 + null_extra steps runs on the lanes still
    active, gathered; a lane that is no longer active keeps its carry
    (the JAX package's masked step leaves it unchanged but for the
    bounce counter, which no output reads), and the loop ends early once
    no lane is active."""
    P = o0.shape[0]
    NB = max(cfg.nb_mis, 1)
    carry = _zero_carry(o0, d0, scene.cam_medium)
    for step in range(cfg.max_depth + 1 + cfg.null_extra):
        lanes = _step_lanes(carry["active"])
        if lanes is None:
            break
        _record("step", lanes.numel(), step)
        new = _volpath_step(scene, bvh, dist, cfg,
                            {k: v[lanes] for k, v in carry.items()}, step,
                            keys[lanes], albedo_luts)
        carry = {k: v.index_put((lanes,), new[k]) for k, v in carry.items()}

    if track_stats is not None:
        _record("paths", P, int(carry["scattered"].sum()),
                int(carry["in_grid"].sum()))
    ls = torch.zeros((P, cfg.n_ls, 3), device=o0.device)
    ls[:, 0, :] = carry["L"]
    z = torch.zeros((P, NB), device=o0.device)
    return SampleOutput(
        ls=_scrub_ls(ls), mis_bsdf=z, mis_light=z.clone(),
        mat_id=carry["mat_id"], depth=carry["depth"],
        normal=carry["normal"], albedo=carry["albedo"],
        n_rays=carry["n_rays"], path_len=carry["path_len"])
