"""Wavefront statistics-tracking path integrator (port of
statmc_tpu/render/integrator.py: IntegratorConfig, _bounce_step,
_scrub_ls, _carry_output, trace, trace_wavefront).

One ``_bounce_step`` advances every lane by one lockstep bounce: the
closest hit, emitted light, next-event estimation with both MIS halves,
selective MIS, BSDF continuation, the BSSRDF relocation of lanes that
enter a subsurface material (render/sss.py), approximate-contribution
Russian roulette and the bounce-0 G-buffer capture.  ``trace_wavefront`` drives
it with path regeneration: the JAX package's ``lax.while_loop`` becomes a
host loop over tensor ops with the same condition; ``trace`` drives it
one sample per lane over a fixed number of steps (the per-sample driver
of the lockstep sampler).  Random draws are addressed by (pixel, sample,
step-in-sample, slot) under every sampler mode of core/rng.py, so
per-lane results match the JAX package.  In the exact lockstep mode the
draws are instead read from each tile's serial PCG32 stream at a cursor
that rides the carry (render/lockstep_exact.py).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import spans
from ..core import math as cm
from ..core import rng as crng
from ..core import spectrum as spec
from ..scene import build as sb
from . import bounce_graphs as BG
from . import bsdf as B
from . import lights as LT
from .albedo_lut import albedo_from_curves
from .intersect import intersect_scene, occluded_scene
from .lightdistrib import sample_light_id


class IntegratorConfig(NamedTuple):
    """Static integrator configuration (statpath.cpp:1026-1173)."""
    max_depth: int = 5
    n_ls: int = 1  # Radiance bounceEnd (>=1); >1 when ACRR tracks bounces
    nb_mis: int = 0  # MISWinRate bounceEnd; 0 disables SMIS tallies
    enable_smis: bool = False
    enable_acrr: bool = False
    rr_threshold: float = 1.0
    rr_start_bounce: int = 4  # reference: RR from the 5th bounce (b > 3)
    sampler_mode: int = 0  # core/rng.py MODE_*
    cone0: float = 0.0  # ray-cone width at the origin
    cone_spread: float = 0.0  # ray-cone growth per unit distance
    direct_only: bool = False  # whitted/directlighting: specular-only paths
    null_extra: int = 0  # extra steps for null-material pass-throughs
    # The scene's material types (MAT_*): the BSDF skips the families no
    # lane can have (render/bsdf.py); None evaluates every family.
    mat_types: frozenset | None = None
    # The scene has subsurface materials: run the in-bounce BSSRDF block
    # (render/sss.py, statpath.cpp:892-926); off, no probe-chain call and
    # no exit-vertex NEE runs.
    enable_sss: bool = False
    # volpath + the scene declares media: the driver calls the media-aware
    # bounce loop (render/volume.py, volpath.cpp:54-188) instead of trace.
    volumetric: bool = False
    # A grid medium exists: run delta and ratio tracking (homogeneous
    # media are closed-form).
    has_grid_media: bool = False


class SampleOutput(NamedTuple):
    ls: Any  # [P, NL, 3] per-bounce radiance estimates (Ls[0] = film L)
    mis_bsdf: Any  # [P, NB]
    mis_light: Any  # [P, NB]
    mat_id: Any  # [P] material id feature (0 = miss)
    depth: Any  # [P]
    normal: Any  # [P,3]
    albedo: Any  # [P,3]
    n_rays: Any  # [P] rays traced for this sample
    path_len: Any  # [P]


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return torch.where(denom > 0, f * f / torch.clamp(denom, min=1e-30), 0.0)


def _offset_origin(p, ng, w):
    """Spawn-ray origin offset along the geometric normal."""
    n = torch.where(cm.dot(ng, w)[..., None] < 0, -ng, ng)
    return p + n * 1e-4 * torch.clamp(cm.length(p), min=1.0)[..., None]


def _zero_path_carry(P: int, NL: int, NB: int, device) -> dict:
    """Per-path state that resets at every sample start."""
    def z(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype, device=device)

    return dict(
        ls=z(P, NL, 3), betas=torch.ones((P, NL, 3), device=device),
        specular=z(P, dtype=torch.bool),
        active=torch.ones((P,), dtype=torch.bool, device=device),
        eta_scale=torch.ones((P,), device=device),
        mis_bsdf=z(P, NB), mis_light=z(P, NB), mat_id=z(P), depth=z(P),
        normal=z(P, 3), albedo=z(P, 3), n_rays=z(P), path_len=z(P),
        cum_t=z(P), bounce=z(P, dtype=torch.int32),
    )


@spans.spanned("integrator.bounce_step")
def _bounce_step(scene, bvh, dist, cfg: IntegratorConfig, carry, step, keys,
                 avg_ls, win_bsdf, win_light, feedback_on: bool,
                 albedo_luts, ld_stream=None):
    """One lockstep bounce over all lanes; `step` (an int, or [P] per
    lane) is the step-in-sample draw-site index.  ld_stream: None
    (random), (scramble keys, sample index) for the LD modes, (table
    rows, sample index) for MODE_LOCKSTEP, or (the tiles' raw streams
    [T, L], each lane's tile [P]) for MODE_LOCKSTEP_EXACT, whose cursor
    is carry["cursor"].

    The step's own tensor code is `_step_ops`, cut at its three scene
    queries: the closest hit, the shadow ray and the BSDF-MIS ray, which
    run here, eagerly, through this module's `intersect_scene` and
    `occluded_scene`.  On the card, where render/bounce_graphs.py's
    eager_reason finds nothing against it, the four stretches between
    the queries replay as CUDA graphs; else they run op by op.  Either
    way each lane's results are the same, bit for bit."""
    def query(req):
        kind, o, d, t_max, kw = req
        if kind == "occluded":
            return occluded_scene(scene, o, d, t_max, bvh)
        return intersect_scene(scene, o, d, t_max, bvh, **kw)

    dev = carry["o"].device
    if BG.eager_reason(scene, cfg, ld_stream, dev) is None:
        def body(x):
            return _step_ops(scene, bvh, dist, cfg, x["carry"], x["step"],
                             x["keys"], x["avg_ls"], x["win_bsdf"],
                             x["win_light"], feedback_on, albedo_luts,
                             x["ld"])

        # Only configurations that read feedback_on capture it.
        fb = feedback_on if cfg.enable_smis or cfg.enable_acrr else None
        return BG.replay_step(
            body, dict(carry=carry, step=step, keys=keys, avg_ls=avg_ls,
                       win_bsdf=win_bsdf, win_light=win_light,
                       ld=ld_stream),
            (cfg, fb), (scene, dist, albedo_luts), query)
    if dev.type == "cuda":
        spans.count("graph.bounce.eager", 1)
    return BG.drive(_step_ops(scene, bvh, dist, cfg, carry, step, keys,
                              avg_ls, win_bsdf, win_light, feedback_on,
                              albedo_luts, ld_stream), query)


def _step_ops(scene, bvh, dist, cfg: IntegratorConfig, carry, step, keys,
              avg_ls, win_bsdf, win_light, feedback_on: bool, albedo_luts,
              ld_stream):
    """The bounce step's own tensor code, as a generator: it yields each
    scene query as (kind, o, d, t_max, keyword arguments), kind
    "intersect" or "occluded", takes the answer back through send(), and
    returns the new carry.  bvh is read by the SSS block alone, whose
    probe chain runs its own queries (an eager step)."""
    P = carry["o"].shape[0]
    dev = carry["o"].device
    NL = cfg.n_ls
    NB = max(cfg.nb_mis, 1)
    o, d = carry["o"], carry["d"]
    active = carry["active"]
    betas, ls = carry["betas"], carry["ls"]
    bl = carry["bounce"]
    mode = cfg.sampler_mode
    # The lockstep table is addressed by the per-lane bounce counter
    # (null pass-throughs consume no draws, statpath.cpp:823-827); every
    # other mode by the step counter.
    dstep = bl if mode == crng.MODE_LOCKSTEP else step
    exact = mode == crng.MODE_LOCKSTEP_EXACT
    if exact:
        streams, lane_tile = ld_stream
        cur0 = carry["cursor"].long()

        def take_at(pos):
            return streams[lane_tile,
                           torch.clamp(pos, 0, streams.shape[1] - 1)]

    def draw_1d(slot):
        return crng.draw_1d(keys, ld_stream, mode, dstep, slot)

    def draw_2d(slot):
        return crng.draw_2d(keys, ld_stream, mode, dstep, slot)

    # Dead lanes carry t_max = 0: they cannot hit anything.
    tmax_live = torch.where(active, cm.INF, 0.0)
    # The exact replay needs pbrt's BSDF frame (ss = normalize(dpdu)) at
    # every vertex, so cosine-sampled directions match draw for draw; hair
    # scenes need it for the Marschner frame (None: hair scenes only).
    hit = yield ("intersect", o, d, tmax_live,
                 {"want_tangent": True if exact else None})
    found = hit.found & active

    # --- emitted light at the vertex (bounce 0 or after specular) ---
    emit = (bl == 0) | carry["specular"]
    le_hit = LT.area_light_le(scene, hit.light_id, hit.ng, -d)
    le_esc = LT.escaped_radiance(scene, d)
    le = torch.where(found[..., None], le_hit,
                     torch.where(active[..., None], le_esc, 0.0))
    ls = ls + torch.where((emit & active)[..., None, None],
                          betas * le[:, None, :], 0.0)

    shading = found & (bl < cfg.max_depth)
    cum_t = carry["cum_t"] + torch.where(found, hit.t, 0.0)
    if scene.has_textures:
        # Ray-cone footprint of the hit (the stand-in for ray
        # differentials): its width in uv units drives the MIP level.
        cone_w = cfg.cone0 + cfg.cone_spread * cum_t
        m = B.gather_materials(
            scene, hit.mat_id, hit.uv, hit.p,
            uv_fp=cone_w * hit.uv_density,
            uv_axes=(hit.uv_axes * cone_w[..., None, None]
                     if hit.uv_axes is not None else None))
    else:
        # Hair lanes read their width offset from the ribbon's uv.
        m = B.gather_materials(scene, hit.mat_id,
                               hit.uv if sb.scene_has_hair(scene) else None)
    null_mat = m.mat_type == sb.MAT_NONE
    shading = shading & ~null_mat

    ns_safe = torch.where(torch.any(hit.ns != 0, -1, keepdim=True), hit.ns,
                          cm.const((0.0, 0.0, 1.0), dev))
    frame = B.ShadingFrame.from_normal(ns_safe)
    if hit.tangent is not None:
        # pbrt's BSDF frame takes dpdu as its x axis (ss): the Marschner
        # model's longitudinal angle is measured against the curve axis.
        t_proj = hit.tangent - cm.dot(hit.tangent, ns_safe)[..., None] \
            * ns_safe
        ok = torch.sum(t_proj * t_proj, -1, keepdim=True) > 1e-12
        t_x = cm.normalize(torch.where(ok, t_proj, frame.t))
        frame = B.ShadingFrame(t_x, cm.cross(ns_safe, t_x), ns_safe)
    wo_world = -d
    wo_l = frame.to_local(wo_world)

    # --- bounce-0 feature capture -----------------------------------
    first = (bl == 0) & shading
    mat_feature = (hit.mat_id + 1).to(torch.float32)
    carry_mat = torch.where(first, mat_feature, carry["mat_id"])
    carry_depth = torch.where(first, hit.t, carry["depth"])
    carry_normal = torch.where(first[..., None], hit.ns, carry["normal"])
    if albedo_luts is not None:
        alb = albedo_from_curves(albedo_luts[0], albedo_luts[1], hit.mat_id,
                                 m.kd, B.cos_theta(wo_l))
    else:
        alb = _approx_albedo(m, B.cos_theta(wo_l))
    carry_albedo = torch.where(first[..., None], alb, carry["albedo"])

    # --- next-event estimation --------------------------------------
    delta_bsdf = B.is_specular(m)
    nee = shading & ~delta_bsdf

    if exact:
        # pbrt: select(1) + uLight(2) + uScattering(2), consumed only when
        # NEE runs (statpath.cpp:846,744-752).
        u_sel = take_at(cur0)
        u_light = torch.stack([take_at(cur0 + 1), take_at(cur0 + 2)], -1)
    else:
        u_sel = draw_1d(crng.SLOT_LIGHT_SELECT)
        u_light = draw_2d(crng.SLOT_LIGHT_SAMPLE)
    light_id, sel_pmf = sample_light_id(dist, u_sel, hit.p)

    lsamp = LT.sample_li(scene, light_id, hit.p, hit.ng, u_light)
    wi_l = frame.to_local(lsamp.wi)
    f_l, pdf_l_scatter = B.evaluate(m, wo_l, wi_l, cfg.mat_types)
    f_l = f_l * cm.absdot(lsamp.wi, hit.ns)[..., None]
    lvalid = (nee & (lsamp.pdf > 0) & torch.any(lsamp.li > 0, -1)
              & torch.any(f_l > 0, -1))
    sh_o = _offset_origin(hit.p, hit.ng, lsamp.wi)
    occ = yield ("occluded", sh_o, lsamp.wi,
                 torch.where(lvalid, torch.clamp(lsamp.dist * 0.999, min=0.0),
                             0.0), {})
    li_l = torch.where((lvalid & ~occ)[..., None], lsamp.li, 0.0)
    contributed_l = torch.any(li_l > 0, -1) & lvalid
    w_l = power_heuristic(1.0, lsamp.pdf, 1.0, pdf_l_scatter)
    contr_l = f_l * li_l / torch.clamp(lsamp.pdf, min=1e-30)[..., None]

    # BSDF half of EstimateDirect.
    if exact:
        u_bs = torch.stack([take_at(cur0 + 3), take_at(cur0 + 4)], -1)
        uc_bs = u_bs[:, 0]  # pbrt remaps uScattering.x in place
    else:
        u_bs = draw_2d(crng.SLOT_BSDF_NEE)
        uc_bs = draw_1d(crng.SLOT_BSDF_COMPONENT)
    bsmp = B.sample(m, wo_l, u_bs, uc_bs, cfg.mat_types)
    wi2 = frame.to_world(bsmp.wi)
    f_b = bsmp.f * cm.absdot(wi2, hit.ns)[..., None]
    bs_o = _offset_origin(hit.p, hit.ng, wi2)
    hit2 = yield ("intersect", bs_o, wi2, torch.where(nee, cm.INF, 0.0),
                  {"lean": True})
    same_light = hit2.found & (hit2.light_id == light_id)
    li_b_hit = LT.area_light_le(scene, hit2.light_id, hit2.ng, -wi2)
    is_inf_light = scene.light_kind[light_id.long()] == sb.LIGHT_INFINITE
    li_b_esc = torch.where(is_inf_light[..., None],
                           LT.escaped_radiance(scene, wi2), 0.0)
    li_b = torch.where(same_light[..., None], li_b_hit,
                       torch.where(hit2.found[..., None], 0.0, li_b_esc))
    light_pdf_b = LT.pdf_li(scene, light_id, hit.p, wi2, hit2.p, hit2.ng,
                            hit2.found)
    w_b = torch.where(bsmp.specular, 1.0,
                      power_heuristic(1.0, bsmp.pdf, 1.0, light_pdf_b))
    bvalid = (nee & ~lsamp.is_delta & (bsmp.pdf > 0) & torch.any(f_b > 0, -1)
              & (bsmp.specular | (light_pdf_b > 0)))
    contributed_b = torch.any(li_b > 0, -1) & bvalid
    contr_b = f_b * li_b / torch.clamp(bsmp.pdf, min=1e-30)[..., None]

    # --- SMIS strategy disabling (statpath.cpp:559-560,630-728) -----
    smis_here = cfg.enable_smis & (bl < cfg.nb_mis)
    bidx = torch.clamp(bl, max=NB - 1).long()
    # one_hot's range check would read the lanes back to the host.
    bhot = (bidx[:, None] == torch.arange(NB, device=dev)).to(torch.float32)

    def at_b(arr):  # [P, NB] -> [P] value at this lane's bounce
        return torch.gather(arr, 1, bidx[:, None])[:, 0]

    wr_l = at_b(win_light)
    wr_b = at_b(win_bsdf)
    t_b = at_b(carry["mis_bsdf"])
    t_l = at_b(carry["mis_light"])
    fb = feedback_on
    dl0 = smis_here & fb & (wr_l < 1e-3) & (t_l == 0) \
        & ((wr_b >= 1e-3) | (t_b > 0))
    db0 = smis_here & fb & (wr_b < 1e-3) & (t_b == 0) \
        & ((wr_l >= 1e-3) | (t_l > 0))

    exec_l1 = (~dl0 | lsamp.is_delta) & contributed_l
    clear_db = exec_l1 & ~lsamp.is_delta & (w_l <= 0.5)
    db1 = db0 & ~clear_db
    exec_b = ~db1 & ~lsamp.is_delta & contributed_b
    goto_l = exec_b & (w_b <= 0.5) & dl0
    dl1 = dl0 & ~goto_l

    # Contributions with SMIS full-weight promotion.
    ld = torch.zeros((P, 3), device=dev)
    add_l1 = torch.where(
        lsamp.is_delta[..., None], contr_l,
        torch.where((db0 & (w_l > 0.5))[..., None], contr_l,
                    contr_l * w_l[..., None]))
    ld = ld + torch.where(exec_l1[..., None], add_l1, 0.0)
    add_b = torch.where(dl1[..., None], contr_b, contr_b * w_b[..., None])
    ld = ld + torch.where(exec_b[..., None], add_b, 0.0)
    add_l2 = torch.where((db1 & (w_l > 0.5))[..., None], contr_l,
                         contr_l * w_l[..., None])
    ld = ld + torch.where((goto_l & contributed_l)[..., None], add_l2, 0.0)

    ld = ld / torch.clamp(sel_pmf, min=1e-30)[..., None]
    ls = ls + torch.where(nee[..., None, None], betas * ld[:, None, :], 0.0)

    # Tallies (only when SMIS active at this bounce).
    wl_hi = torch.where(w_l > 0.5, 1.0, 0.0)
    wl_lo = torch.where(w_l > 0.5, 0.0, 1.0)
    wb_hi = torch.where(w_b > 0.5, 1.0, 0.0)
    wb_lo = torch.where(w_b > 0.5, 0.0, 1.0)
    l1 = exec_l1 & ~lsamp.is_delta
    inc_lt = torch.where(l1, wl_hi, 0.0)
    inc_bt = torch.where(l1, wl_lo, 0.0)
    inc_bt = inc_bt + torch.where(exec_b, wb_hi, 0.0)
    inc_lt = inc_lt + torch.where(exec_b, wb_lo, 0.0)
    rerun = goto_l & contributed_l
    inc_lt = inc_lt + torch.where(rerun, wl_hi, 0.0)
    inc_bt = inc_bt + torch.where(rerun, wl_lo, 0.0)
    sm = (smis_here & nee).to(torch.float32)
    mis_bsdf = carry["mis_bsdf"] + bhot * (sm * inc_bt)[:, None]
    mis_light = carry["mis_light"] + bhot * (sm * inc_lt)[:, None]

    # --- BSDF sampling for path continuation ------------------------
    if exact:
        # NEE consumed 5 iff it ran; the continuation's Get2D whenever the
        # bounce shades (statpath.cpp:869, even when f or pdf is 0).
        cur1 = cur0 + 5 * nee.long()
        u_pc = torch.stack([take_at(cur1), take_at(cur1 + 1)], -1)
        uc_pc = u_pc[:, 0]
        cur2 = cur1 + 2 * shading.long()
    else:
        u_pc = draw_2d(crng.SLOT_BSDF)
        uc_pc = draw_1d(crng.SLOT_BSDF_COMPONENT_PC)
    psmp = B.sample(m, wo_l, u_pc, uc_pc, cfg.mat_types)
    wi_c = frame.to_world(psmp.wi)
    bsdf_beta = (psmp.f * cm.absdot(wi_c, hit.ns)[..., None]
                 / torch.clamp(psmp.pdf, min=1e-30)[..., None])
    dead = ~shading | torch.all(psmp.f <= 0, -1) | (psmp.pdf <= 0)
    if cfg.direct_only:
        dead = dead | ~psmp.specular
    pass_through = found & (bl < cfg.max_depth) & null_mat
    dead = dead & ~pass_through

    nl_iota = torch.arange(NL, device=dev)
    bmask = (nl_iota[None, :] <= bl[:, None]) & ~dead[:, None]
    betas = betas * torch.where(
        bmask[..., None],
        torch.where(pass_through[:, None, None], 1.0, bsdf_beta[:, None, :]),
        1.0)
    specular_new = torch.where(pass_through, carry["specular"],
                               psmp.specular)
    eta2 = m.eta[..., 0] ** 2
    entering = cm.dot(wo_world, hit.ng) > 0
    eta_mul = torch.where(
        psmp.specular & psmp.transmission,
        torch.where(entering, eta2, 1.0 / torch.clamp(eta2, min=1e-9)), 1.0)
    eta_scale = carry["eta_scale"] * torch.where(dead, 1.0, eta_mul)

    d_new = torch.where(pass_through[..., None], d, wi_c)
    o_new = _offset_origin(hit.p, hit.ng, d_new)
    o_new = torch.where(pass_through[..., None], hit.p + d * 1e-4, o_new)

    active = active & found & (bl < cfg.max_depth) & ~dead

    sss_rays = None
    if cfg.enable_sss and scene.sss is not None:
        if exact:
            raise ValueError("the exact lockstep replay does not model the "
                             "BSSRDF's draw sites (subsurface materials)")
        d_new, o_new, betas, ls, specular_new, active, sss_rays = _sss_block(
            scene, bvh, dist, m, hit, frame, psmp, shading, dead, active,
            keys, dstep, bl, NL, betas, ls, d_new, o_new, specular_new)

    # --- Russian roulette (statpath.cpp:930-953) --------------------
    rr_here = bl > (cfg.rr_start_bounce - 1)
    avg_idx = torch.clamp(bl + 1, max=NL - 1).long()
    acrr_on = cfg.enable_acrr and feedback_on
    if acrr_on:
        avg_l0 = torch.clamp(avg_ls[:, 0], min=1e-12)
        avg_at = torch.gather(avg_ls, 1, avg_idx[:, None])[:, 0]
        avg = avg_at / avg_l0
    else:
        avg = 1.0
    rr_beta_max = torch.max(betas[:, 0, :] * eta_scale[:, None], dim=-1).values
    survival = rr_beta_max * avg
    q = torch.clamp(1.0 - survival, min=0.05)
    do_rr = rr_here & active & ~pass_through & (survival < cfg.rr_threshold)
    if exact:
        # pbrt's Get1D sits inside both conditionals (statpath.cpp:941-948).
        u_rr = take_at(cur2)
        cur3 = cur2 + do_rr.long()
    else:
        u_rr = draw_1d(crng.SLOT_RR)
    killed = do_rr & (u_rr < q)
    active = active & ~killed
    betas = torch.where((do_rr & ~killed)[:, None, None],
                        betas / torch.clamp(1.0 - q, min=1e-6)[:, None, None],
                        betas)

    n_rays = (carry["n_rays"] + carry["active"].to(torch.float32)
              + 2.0 * nee.to(torch.float32))
    if sss_rays is not None:
        n_rays = n_rays + sss_rays
    path_len = carry["path_len"] + shading.to(torch.float32)
    bl_new = bl + torch.where(pass_through, 0, 1).to(torch.int32)
    new_carry = dict(
        o=o_new, d=d_new, ls=ls, betas=betas,
        specular=specular_new, active=active, eta_scale=eta_scale,
        mis_bsdf=mis_bsdf, mis_light=mis_light,
        mat_id=carry_mat, depth=carry_depth,
        normal=carry_normal, albedo=carry_albedo, n_rays=n_rays,
        path_len=path_len, cum_t=cum_t, bounce=bl_new,
    )
    if exact:
        new_carry["cursor"] = cur3.to(torch.int32)
    return new_carry


def _firing_lanes(fire):
    """(take, put) over the lanes where `fire` holds, or None when none
    does: take gathers those lanes of a per-lane tensor, put scatters a
    result back over all lanes with `fill` elsewhere.  The SSS block runs
    on the gathered lanes (one host synchronisation a bounce step), where
    the JAX package runs it over all lanes, the others masked; every op
    of the block is per lane, so each lane's results are the same
    (tests/test_torch_hair_sss.py holds both forms bit for bit)."""
    lanes = torch.nonzero(fire)[:, 0]
    if lanes.numel() == 0:
        return None
    P = fire.shape[0]

    def take(x):
        return x[lanes] if torch.is_tensor(x) and x.dim() > 0 else x

    def put(x, fill):
        out = torch.full((P,) + x.shape[1:], fill, dtype=x.dtype,
                         device=x.device)
        out[lanes] = x
        return out

    return take, put


def _sss_block(scene, bvh, dist, m, hit, frame, psmp, shading, dead, active,
               keys, dstep, bl, NL, betas, ls, d_new, o_new, specular_new):
    """BSSRDF transport within the bounce (statpath.cpp:892-926): a lane
    transmitted through a subsurface material's interface is relocated
    to an exit point (Sample_Sp's probe chain), its betas[i <= bounce]
    scaled by S/pdf; one EstimateDirect with the Sw lobe runs at the exit
    point, and the path continues along a cosine-sampled Sw direction,
    all before Russian roulette, as the reference orders it.  A failed
    Sample_Sp ends the path.  Returns the updated (d_new, o_new, betas,
    ls, specular_new, active) and the lanes' extra rays: the probe
    chain, the exit shadow ray and the exit BSDF-MIS ray."""
    from . import sss as SSS

    sid = m.sss_id
    sss_fire = shading & (sid >= 0) & psmp.transmission & ~dead & active
    gathered = _firing_lanes(sss_fire)
    if gathered is None:
        return d_new, o_new, betas, ls, specular_new, active, None
    take, put = gathered
    k_keys, k_step, k_sid = take(keys), take(dstep), take(sid)
    tid = torch.clamp(k_sid, min=0).long()
    u_ax = crng.uniform_1d(k_keys, k_step, crng.SLOT_SSS_AXIS)
    u_rad = crng.uniform_2d(k_keys, k_step, crng.SLOT_SSS_RADIUS)
    spr = SSS.sample_sp(scene, bvh, scene.sss, k_sid, take(hit.p),
                        B.ShadingFrame(*map(take, frame)), take(hit.mat_id),
                        u_ax, u_rad, take(sss_fire))
    k_ok = take(sss_fire) & spr.ok
    # Direct lighting at the exit vertex (statpath.cpp:903-914).
    eta_sss = scene.sss.eta[tid]
    c_sss = scene.sss.c_sw[tid]
    ld_sss = SSS.estimate_direct_sw(scene, bvh, dist, k_keys, k_step, spr.p,
                                    spr.ns, eta_sss, c_sss, k_ok)
    # Sw continuation (statpath.cpp:917-925): wo = +ns at pi, wi
    # cosine-sampled, weight f |cos| / pdf = Sw pi.
    u_sw = crng.uniform_2d(k_keys, k_step, crng.SLOT_SSS_SW)
    wi_sw_l = B.cosine_sample_hemisphere(u_sw)
    wi_sw = B.ShadingFrame.from_normal(spr.ns).to_world(wi_sw_l)
    f_over_pdf = SSS.sw_eval(eta_sss, c_sss, wi_sw_l[:, 2]) * math.pi
    o_sw = _offset_origin(spr.p, spr.ns, wi_sw)

    sss_ok = put(k_ok, False)
    # betas[i] *= S/pdf for i <= bounces (statpath.cpp:899).
    bm_s = ((torch.arange(NL, device=bl.device)[None, :] <= bl[:, None])
            & sss_ok[:, None])[..., None]
    betas = betas * torch.where(bm_s, put(spr.s_over_pdf, 0.0)[:, None, :],
                                1.0)
    ls = ls + torch.where(sss_ok[..., None, None],
                          betas * put(ld_sss, 0.0)[:, None, :], 0.0)
    betas = betas * torch.where(bm_s, put(f_over_pdf, 1.0)[:, None, None],
                                1.0)
    d_new = torch.where(sss_ok[..., None], put(wi_sw, 0.0), d_new)
    o_new = torch.where(sss_ok[..., None], put(o_sw, 0.0), o_new)
    specular_new = torch.where(sss_ok, False, specular_new)
    # A failed Sample_Sp breaks the path (statpath.cpp:898).
    active = active & ~(sss_fire & ~put(spr.ok, True))
    sss_rays = torch.where(sss_fire, float(SSS.PROBE_STEPS) + 2.0, 0.0)
    return d_new, o_new, betas, ls, specular_new, active, sss_rays


def _approx_albedo(m: B.MaterialLanes, cos_o):
    """Closed-form per-family directional albedo (used when the albedo
    G-buffer curves are not built)."""
    t = m.mat_type
    f_diel = B.fresnel_dielectric(torch.abs(cos_o), 1.0, 1.5)[..., None]
    f_cond = B.fresnel_conductor(cos_o, m.eta, m.k)
    f_glass = B.fresnel_dielectric(torch.abs(cos_o), 1.0,
                                   m.eta[..., 0])[..., None]
    alb = m.kd
    alb = torch.where(((t == sb.MAT_PLASTIC) | (t == sb.MAT_UBER)
                       | (t == sb.MAT_SUBSTRATE))[..., None],
                      m.kd + m.ks * f_diel, alb)
    alb = torch.where((t == sb.MAT_METAL)[..., None], f_cond, alb)
    alb = torch.where((t == sb.MAT_MIRROR)[..., None], m.kr, alb)
    alb = torch.where((t == sb.MAT_GLASS)[..., None],
                      m.kr * f_glass + m.kt * (1.0 - f_glass), alb)
    return torch.clamp(alb, 0.0, 1.0)


def _scrub_ls(ls):
    """NaN / negative / infinite luminance scrub on Ls[0] only
    (statpath.cpp:333-351)."""
    l0 = ls[:, 0, :]
    y = spec.luminance(l0)
    bad = torch.isnan(torch.sum(l0, -1)) | (y < -1e-5) | torch.isinf(y)
    ls = ls.clone()
    ls[:, 0, :] = torch.where(bad[..., None], 0.0, l0)
    return ls


def _carry_output(cfg: IntegratorConfig, carry) -> SampleOutput:
    nb = max(cfg.nb_mis, 1)
    return SampleOutput(
        ls=_scrub_ls(carry["ls"]),
        mis_bsdf=carry["mis_bsdf"][:, :nb],
        mis_light=carry["mis_light"][:, :nb],
        mat_id=carry["mat_id"], depth=carry["depth"],
        normal=carry["normal"], albedo=carry["albedo"],
        n_rays=carry["n_rays"], path_len=carry["path_len"],
    )


def trace(scene, bvh, dist, cfg: IntegratorConfig, o0, d0, keys, avg_ls,
          win_bsdf, win_light, feedback_on: bool, albedo_luts=None,
          ld_stream=None) -> SampleOutput:
    """Per-sample driver: every lane traces one sample through
    max_depth + 1 + null_extra steps (the JAX package's lax.scan), with
    the scalar step as the draw-site index.  Its per-sample outputs equal
    trace_wavefront's."""
    P = o0.shape[0]
    carry = dict(o=o0, d=d0, **_zero_path_carry(P, cfg.n_ls,
                                                max(cfg.nb_mis, 1),
                                                o0.device))
    for step in range(cfg.max_depth + 1 + cfg.null_extra):
        carry = _bounce_step(scene, bvh, dist, cfg, carry, step, keys,
                             avg_ls, win_bsdf, win_light, feedback_on,
                             albedo_luts, ld_stream)
    return _carry_output(cfg, carry)


def trace_wavefront(scene, bvh, dist, cfg: IntegratorConfig, gen_ray_fn,
                    pixel_ids, base_key, sample_start: int, n_samples: int,
                    avg_ls, win_bsdf, win_light, feedback_on: bool,
                    record_fn, albedo_luts=None) -> None:
    """Path-regeneration wavefront driver.

    A lane that finishes its sample immediately starts its next one;
    completed samples go to ``record_fn(out, done)`` the moment they
    finish, in per-pixel sample order, so film sums and streaming
    moments equal the per-sample driver's.  The loop runs while any lane
    is live or has samples left, for at most n_samples * n_steps steps
    (the JAX package's while_loop condition).  A step runs in the spans
    sync.wavefront (that condition), wavefront.regen,
    integrator.bounce_step and wavefront.record (spans.py)."""
    P = pixel_ids.shape[0]
    dev = pixel_ids.device
    NL = cfg.n_ls
    NB = max(cfg.nb_mis, 1)
    n_steps = cfg.max_depth + 1 + cfg.null_extra
    mode = cfg.sampler_mode
    # LD modes: pixel-stable scramble words, built once per call.
    scr = (crng.pixel_scramble(base_key, pixel_ids)
           if mode != crng.MODE_RANDOM else None)

    carry = dict(o=torch.zeros((P, 3), device=dev),
                 d=torch.zeros((P, 3), device=dev),
                 **_zero_path_carry(P, NL, NB, dev))
    carry["active"] = torch.zeros((P,), dtype=torch.bool, device=dev)
    keys = torch.zeros((P, 2), dtype=torch.int64, device=dev)
    live = torch.zeros((P,), dtype=torch.bool, device=dev)
    s_local = torch.full((P,), -1, dtype=torch.int32, device=dev)
    sis = torch.zeros((P,), dtype=torch.int32, device=dev)

    for _ in range(n_samples * n_steps):
        with spans.span("sync.wavefront"):
            more = bool(torch.any(live | (s_local + 1 < n_samples)))
        if not more:
            break
        # --- regenerate finished lanes ---------------------------------
        with spans.span("wavefront.regen"):
            regen = ~live & (s_local + 1 < n_samples)
            s_local = torch.where(regen, s_local + 1, s_local)
            sample_idx = sample_start + torch.clamp(s_local, min=0)
            fresh_keys = crng.pixel_keys(base_key, pixel_ids, sample_idx)
            keys = torch.where(regen[:, None], fresh_keys, keys)
            ld = (scr, sample_idx) if scr is not None else None
            u_cam = crng.draw_2d(keys, ld, mode, 0, crng.SLOT_CAMERA)
            o_new, d_new = gen_ray_fn(u_cam)
            fresh = _zero_path_carry(P, NL, NB, dev)
            fresh["o"], fresh["d"] = o_new, d_new
            for k, old in carry.items():
                r = regen.reshape((P,) + (1,) * (old.dim() - 1))
                carry[k] = torch.where(r, fresh[k], old)
            live = live | regen
            carry["active"] = carry["active"] & live
            sis = torch.where(regen, 0, sis)

        # --- one lockstep physics step ----------------------------------
        carry = _bounce_step(scene, bvh, dist, cfg, carry, sis, keys,
                             avg_ls, win_bsdf, win_light, feedback_on,
                             albedo_luts, ld)
        sis = sis + 1

        # --- record finished samples ------------------------------------
        with spans.span("wavefront.record"):
            done = live & (~carry["active"] | (sis >= n_steps))
            out = _carry_output(cfg, carry)
            # Non-done lanes contribute exact zeros, so masked moment
            # updates are no-ops even if an in-flight lane holds inf/NaN.
            dm = done[:, None]
            out = out._replace(
                ls=torch.where(done[:, None, None], out.ls, 0.0),
                mis_bsdf=torch.where(dm, out.mis_bsdf, 0.0),
                mis_light=torch.where(dm, out.mis_light, 0.0),
                mat_id=torch.where(done, out.mat_id, 0.0),
                depth=torch.where(done, out.depth, 0.0),
                normal=torch.where(dm, out.normal, 0.0),
                albedo=torch.where(dm, out.albedo, 0.0),
                n_rays=torch.where(done, out.n_rays, 0.0),
                path_len=torch.where(done, out.path_len, 0.0),
            )
            record_fn(out, done)
            live = live & ~done
