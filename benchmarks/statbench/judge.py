"""The comparison that decides ``correct``.

Every number is a widest gap, a share or a count, with a limit of its own
from ``limits/<cell>.json``; a run is correct when every number is finite
and at most its limit.  The reference (reference.py) runs in float64.
With `control`, the reference's own arithmetic in bfloat16 takes the
program's place, and the same numbers are read; the control has to come
out not correct.

Render cells (the first job of the window, captured by capture.py):

- ``hit_mismatch_share``: of the captured closest-hit and shadow queries
  with t_max > 0, the share whose answer differs from the reference's:
  hit against miss, blocked against free, or a closest t more than
  HIT_RTOL apart (relative, against max(t, 1)).
- ``samples_missing``: the sampled pixels whose sample count n, in any
  moment stream, differs from the job's samples a pixel (exact: 0).
- ``moment_gap``: the widest gap between the program's moment buffers at
  the sampled pixels (Radiance: mean and M2 of the Box-Cox values, film
  mean and M2; the albedo and normal means) and the reference's from the
  captured samples, each over the pixel's own scale of that moment
  (mean |y| + s, sum d^2).
- ``m3_gap``: the same for Radiance's M3, over sum |d|^3.  Apart, since
  float32's cancellation in a streamed third moment reads up to 100x the
  other moments' gaps.
- ``film_gap``: the last iteration's film at the sampled pixels against
  the mean of that iteration's captured samples (pbrt's XYZ round trip),
  over |film| + 1% of the mean |film|.
- ``film_f_gap`` (configurations that denoise): the denoised film at the
  sampled pixels against the reference filter, which reads the program's
  moment buffers at the job's end (the stage before it, held above by
  ``moment_gap``), over |film-f| + 1% of the mean |film-f|.

The denoise cell (the last pass over each frame):

- ``filter_gap``, ``mean_corr_gap``, ``disc_gap``: the filtered film mean,
  the corrected mean and the interval half-width at pixels drawn from the
  seed, against the reference filter on the benchmark's own frames, each
  over |value| + 1% of the mean |value|.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import reference as ref

F64, BF16 = torch.float64, torch.bfloat16
HIT_RTOL = 1e-3


def _gap(p, r, scale):
    """max |p - r| / scale, scale per element (broadcast)."""
    return float(((p.to(F64) - r.to(F64)).abs() / scale).max())


def _rel_gap(p, r):
    r = r.to(F64)
    return _gap(p, r, r.abs() + 0.01 * r.abs().mean() + 1e-30)


def _numbers(values: dict, limits: dict):
    return [(k, float(v), float(limits[k])) for k, v in values.items()]


def hit_share(cap, geo, dtype_prog=None, notes=None):
    """hit_mismatch_share of the captured queries; dtype_prog: the
    control's dtype for the reference in the program's place.  notes, a
    list, gets a line for each of the first few queries that differ."""
    tris, centres, radii = (torch.as_tensor(a) for a in geo.arrays())
    bad = total = 0
    for rows, closest in ((cap.hits, True), (cap.shadows, False)):
        if not rows:
            continue
        x = torch.cat(rows)
        x = x[x[:, 6] > 0]
        o, d, tm = x[:, 0:3], x[:, 3:6], x[:, 6]
        t_r, k_r, _ = ref.closest_hits(o, d, tm, tris, centres, radii, F64)
        if dtype_prog is None:
            if closest:
                t_p, hit_p = x[:, 7].to(F64), x[:, 8] > 0
            else:
                hit_p = x[:, 7] > 0.5
        else:
            t_c, k_c, _ = ref.closest_hits(o, d, tm, tris, centres, radii,
                                        dtype_prog)
            t_p, hit_p = t_c.to(F64), k_c > 0
        hit_r = k_r > 0
        wrong = hit_r != hit_p
        if closest:
            both = hit_r & hit_p
            far = (t_p - t_r).abs() > HIT_RTOL * torch.clamp(t_r, min=1.0)
            wrong = wrong | (both & far)
        bad += int(wrong.sum())
        total += int(x.shape[0])
        if notes is not None:
            for k in torch.nonzero(wrong)[:3, 0].tolist():
                notes.append(
                    f"{'closest' if closest else 'shadow'} query differs: "
                    f"o {x[k, 0:3].tolist()} d {x[k, 3:6].tolist()} t_max "
                    f"{float(tm[k])!r}; program "
                    + (f"t {float(t_p[k])!r} kind {float(x[k, 8])!r}"
                       if closest else f"blocked {bool(hit_p[k])}")
                    + f"; reference t {float(t_r[k])!r} kind {int(k_r[k])}")
    return bad / max(total, 1)


PATH_TOL = 1e-3


def _sample_index(before, its, starts):
    """Each captured lane's sample index at each bounce step [N, L]: the
    iteration's first sample plus the samples it began (a step in the
    sample of 0) since that iteration began; -1 before its first."""
    first = (before[..., 16] == 0).long()
    out = torch.full(first.shape, -1, dtype=torch.long)
    for i in sorted(set(its.tolist())):
        rows = its == i
        out[rows] = starts[i] + torch.cumsum(first[rows], 0) - 1
    return out


def _path_differs(out, rr, st):
    """Per row, whether a lane's state after the bounce (out) differs from
    the reference's (rr), and the count of each cause."""
    dr = (rr["ls"] - st["ls"]).to(F64)
    dp = (out["ls"] - st["ls"]).to(F64)
    ls_bad = ((dp - dr).abs() / (dr.abs() + 1e-4 * st["ls"].to(F64).abs()
                                 + 1e-6)).amax(-1) > PATH_TOL
    act_bad = out["active"] != rr["active"]
    both = out["active"] & rr["active"]

    def rel(k, floor=1e-6):
        x, y = out[k].to(F64), rr[k].to(F64)
        g = (x - y).abs() / (y.abs() + floor)
        return (g.amax(-1) if g.dim() > 1 else g) > PATH_TOL

    beta_bad = both & rel("beta")
    d_bad = both & ((out["d"].to(F64) - rr["d"].to(F64)).abs().amax(-1)
                    > PATH_TOL)
    scale = torch.clamp(rr["o"].to(F64).abs().amax(-1), min=1.0)
    o_bad = both & ((out["o"].to(F64) - rr["o"].to(F64)).abs().amax(-1)
                    / scale > PATH_TOL)
    eta_bad = both & rel("eta_scale")
    spec_bad = both & (out["specular"] != rr["specular"])
    g0 = (st["bounce"] == 0) & rr["found"]
    n_bad = g0 & ((out["normal"].to(F64) - rr["normal"].to(F64)).abs()
                  .amax(-1) > PATH_TOL)
    causes = {"radiance": ls_bad, "live": act_bad, "throughput": beta_bad,
              "direction": d_bad, "origin": o_bad, "eta": eta_bad,
              "specular": spec_bad, "normal": n_bad}
    bad = torch.zeros_like(act_bad)
    for v in causes.values():
        bad = bad | v
    return bad, {k: int(v.sum()) for k, v in causes.items()}


def path_share(cap, sc, dist, base_seed, starts, max_depth,
               control: bool = False, notes=None):
    """path_mismatch_share: of the captured lanes' bounces (live before
    it) and of their samples' camera rays, the share where the program's
    state differs from the reference's (pathref.py) by more than
    PATH_TOL (relative; the radiance by its increment)."""
    from . import pathref as PR

    before, after, its = cap.step_tensors()
    before, after = before.cpu(), after.cpu()
    N, L = before.shape[:2]
    sample = _sample_index(before, its, starts)
    lanes = cap.lanes.cpu().numpy()
    live = (before[..., 14] > 0.5) & (sample >= 0)
    ni, li = torch.nonzero(live, as_tuple=True)
    if ni.numel() == 0:
        return 1.0
    b, a = before[ni, li].to(F64), after[ni, li].to(F64)
    pix = lanes[li.numpy()]
    smp = sample[ni, li].numpy()
    stp = b[:, 16].long().numpy()
    draws = PR.Draws(base_seed, smp, pix, stp)
    dev = sc.device

    def dev64(x):
        return x.to(dev, F64)

    st = {"o": dev64(b[:, 0:3]), "d": dev64(b[:, 3:6]),
          "beta": dev64(b[:, 6:9]), "ls": dev64(b[:, 9:12]),
          "eta_scale": dev64(b[:, 12]), "specular": dev64(b[:, 13]) > 0.5,
          "bounce": b[:, 15].long().to(dev)}
    rr = PR.replay(sc, dist, draws, st, max_depth)
    if control:
        sc16 = sc.to(BF16)
        st16 = {k: (v.to(BF16) if v.is_floating_point() else v)
                for k, v in st.items()}
        out = PR.replay(sc16, PR.LightDistribution(sc16), draws, st16,
                        max_depth)
    else:
        out = {"o": dev64(a[:, 0:3]), "d": dev64(a[:, 3:6]),
               "beta": dev64(a[:, 6:9]), "ls": dev64(a[:, 9:12]),
               "eta_scale": dev64(a[:, 12]),
               "specular": dev64(a[:, 13]) > 0.5,
               "active": dev64(a[:, 14]) > 0.5, "normal": dev64(a[:, 15:18])}
    bad, causes = _path_differs(out, rr, st)
    # A hit point on a face of the light grid's voxels (the staircase's
    # step fronts lie on them) reads either voxel in float32: where the
    # other voxel's light selection gives the program's state, the
    # bounce agrees.
    amb = dist.ambiguous(rr["p"])
    rows = torch.nonzero(bad & (amb != 0).any(-1))[:, 0]
    n_voxel = 0
    for mask in ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
                 (0, 1, 1), (1, 1, 1)):
        if rows.numel() == 0:
            break
        shift = amb[rows] * torch.tensor(mask, device=amb.device)
        try_rows = rows[(shift != 0).any(-1)]
        shift = shift[(shift != 0).any(-1)]
        if try_rows.numel() == 0:
            continue
        sub = {k: v[try_rows] for k, v in st.items()}
        r2 = PR.replay(sc, dist, draws.take(try_rows.cpu().numpy()), sub,
                       max_depth, voxel_shift=shift)
        o2 = {k: v[try_rows] for k, v in out.items()}
        b2, _ = _path_differs(o2, r2, sub)
        ok = try_rows[~b2]
        bad[ok] = False
        n_voxel += int(ok.numel())
        rows = rows[bad[rows]]

    # The record: a sample that ends at a bounce (the path no longer
    # live, or its last step) goes to the moment streams with the
    # radiance it holds after that bounce (NaN, infinite or negative
    # radiance as 0), and no other bounce records one.
    # (The control records what it holds.)
    rec_bad = torch.zeros_like(bad)
    samples, _ = cap.sample_tensor()
    rec = samples[-L:].transpose(0, 1).cpu().to(F64)  # [N, L, 10]
    if rec.shape[0] != N:
        rec_bad[:] = True
    elif not control:
        rec = rec[ni, li].to(dev)
        ends = ~out["active"] | (torch.as_tensor(stp, device=dev) + 1
                                 >= max_depth + 1)
        ls_end = out["ls"]
        y = (ls_end * torch.tensor(PR.LUM, dtype=F64, device=dev)).sum(-1)
        scrub = torch.isnan(ls_end.sum(-1)) | (y < -1e-5) | torch.isinf(y)
        ls_end = torch.where(scrub[:, None], 0.0, ls_end)
        rec_bad = ((rec[:, 9] > 0.5) != ends) | (
            ends & ((rec[:, 0:3] - ls_end).abs().amax(-1)
                    > 1e-6 * ls_end.abs().amax(-1) + 1e-30))
    causes["record"] = int(rec_bad.sum())
    bad = bad | rec_bad

    # The camera ray of every sample that began.
    cam = stp == 0
    u = PR.Draws(base_seed, smp[cam], pix[cam],
                 np.zeros(int(cam.sum()), np.int64)).u2(PR.SLOT_CAMERA)
    o_r, d_r = (torch.as_tensor(np.ascontiguousarray(x), dtype=F64,
                                device=dev)
                for x in PR.camera_rays(sc, pix[cam], u))
    if control:
        o_p, d_p = o_r.to(BF16).to(F64), d_r.to(BF16).to(F64)
    else:
        o_p, d_p = st["o"][cam], st["d"][cam]
    cam_bad = (((d_p - d_r).abs().amax(-1) > PATH_TOL)
               | ((o_p - o_r).abs().amax(-1)
                  / torch.clamp(o_r.abs().amax(-1), min=1.0) > PATH_TOL))
    causes["camera"] = int(cam_bad.sum())
    n = int(bad.numel()) + int(cam_bad.numel())
    share = (int(bad.sum()) + int(cam_bad.sum())) / n
    if notes is not None:
        notes.append(f"path replay{' (control)' if control else ''}: "
                     f"{len(smp)} bounces of {L} lanes, {int(cam.sum())} "
                     f"camera rays; {n_voxel} agree on the light grid's "
                     "other voxel; differing before that, by cause: "
                     + ", ".join(f"{k} {v}" for k, v in causes.items()))
    return share


def render_check(kept, geo, cfg, limits, control: bool = False,
                 notes=None):
    from . import cells, pathref as PR

    cap = kept["cap"]
    states = kept["states"]
    dev = cap.pixels.device
    px = cap.pixels
    samples, its = cap.sample_tensor()
    L, alb, nrm = samples[..., 0:3], samples[..., 3:6], samples[..., 6:9]
    m = samples[..., 9] > 0.5
    values = {"hit_mismatch_share": hit_share(
        cap, geo, BF16 if control else None, notes)}

    W = int(cells.setting(cfg, "xresolution")[0])
    H = int(cells.setting(cfg, "yresolution")[0])
    spp = int(cells.setting(cfg, "pixelsamples")[0])
    expo = cells.setting(cfg, "expiterations")[0] == "true"
    n_it = int(cells.setting(cfg, "iterations")[0])
    starts = {i: (0 if i == 1 else (spp << (i - 2)) if expo
                  else (i - 1) * spp) for i in range(1, n_it + 1)}
    sc = PR.Scene(kept["text"], geo, dev, W, H)
    dist = PR.LightDistribution(sc)
    values["path_mismatch_share"] = path_share(
        cap, sc, dist, kept["base_seed"], starts,
        int(cells.setting(cfg, "maxdepth")[0]), control, notes)

    rad_r = ref.moments(L, m, True)
    alb_r, nrm_r = ref.moments(alb, m, False), ref.moments(nrm, m, False)
    streams = _streams()
    st_rad = states[streams["radiance"]]
    st_alb, st_nrm = states[streams["albedo"]], states[streams["normal"]]
    if control:
        rad_p = ref.moments(L, m, True, BF16)
        alb_p, nrm_p = (ref.moments(alb, m, False, BF16),
                        ref.moments(nrm, m, False, BF16))
    else:
        rad_p = {k: v[0, px] for k, v in st_rad.items()}
        rad_p["n"] = rad_p["n"][:, 0]
        alb_p = {"n": st_alb["n"][0, px, 0], "mean": st_alb["mean"][0, px]}
        nrm_p = {"n": st_nrm["n"][0, px, 0], "mean": st_nrm["mean"][0, px]}
    spp_job = kept["spp"]
    missing = torch.zeros_like(px, dtype=torch.bool)
    for p_, r_ in ((rad_p, rad_r), (alb_p, alb_r), (nrm_p, nrm_r)):
        missing |= (p_["n"].to(F64) != r_["n"]) | (r_["n"] != spp_job)
    values["samples_missing"] = int(missing.sum())

    w = m.to(F64)[..., None]
    ns = torch.clamp(w.sum(1), min=1)
    y = ref.box_cox(torch.clamp(L.to(F64), min=0))
    dy = (y - rad_r["mean"][:, None]) * w
    sd = torch.sqrt(rad_r["m2"] / torch.clamp(ns - 1, min=1))
    dx = (L.to(F64) - rad_r["film_mean"][:, None]) * w
    sdx = torch.sqrt(rad_r["film_m2"] / torch.clamp(ns - 1, min=1))

    def floor(s):
        return s + 1e-6 * s.median() + 1e-30

    scales = {
        "mean": floor((w * y.abs()).sum(1) / ns + sd),
        "m2": floor((dy * dy).sum(1)),
        "m3": floor((dy.abs() ** 3).sum(1)),
        "film_mean": floor((w * L.to(F64).abs()).sum(1) / ns + sdx),
        "film_m2": floor((dx * dx).sum(1)),
    }
    gaps = {k: _gap(rad_p[k], rad_r[k], s) for k, s in scales.items()}
    for name, p_, r_, x in (("albedo", alb_p, alb_r, alb),
                            ("normal", nrm_p, nrm_r, nrm)):
        s = floor((w * x.to(F64).abs()).sum(1) / ns)
        gaps[name] = _gap(p_["mean"], r_["mean"], s)
    values["m3_gap"] = gaps.pop("m3")
    values["moment_gap"] = max(gaps.values())
    if notes is not None:
        notes.append("moment gaps: " + ", ".join(
            f"{k} {v:.3g}" for k, v in gaps.items()))

    last = (its == int(its.max())).to(dev)
    ml = m & last[None]
    wl = ml.to(F64)[..., None]
    film_r = ref.film_rgb((wl * L.to(F64)).sum(1)
                          / torch.clamp(wl.sum(1), min=1))
    if control:
        wb = ml.to(BF16)[..., None]
        film_p = ref.film_rgb((wb * L.to(BF16)).sum(1)
                              / torch.clamp(wb.sum(1), min=1))
    else:
        film_p = kept["film"][px]
    values["film_gap"] = _rel_gap(film_p, film_r)

    if kept["film_f"] is not None:
        r = int(cells.setting(cfg, "filterradius")[0])
        fsd = float(cells.setting(cfg, "filtersd")[0])
        names = cells.setting(cfg, "filterbuffers")
        sds = cells.setting(cfg, "filterbuffersds")
        gb_sd = [float(s) for s, nm in zip(sds, names) for _ in range(3)]
        centres = kept["centres"]
        ys, xs = centres // W, centres % W
        planes = {"albedo": (alb_r, alb_p), "normal": (nrm_r, nrm_p)}
        f_r = _window_filter(rad_r, [planes[nm][0] for nm in names], px,
                             H, W, r, fsd, gb_sd, ys, xs, F64)
        if control:
            f_p = _window_filter(rad_p, [planes[nm][1] for nm in names], px,
                                 H, W, r, fsd, gb_sd, ys, xs, BF16)
        else:
            f_p = kept["film_f"].reshape(-1, 3)[centres]
        values["film_f_gap"] = _rel_gap(f_p, f_r)
    return _numbers(values, limits)


def _window_filter(rad, gbufs, px, H, W, r, fsd, gb_sd, ys, xs, dtype):
    """The reference filter at pixels (ys, xs), from moments `rad` and
    G-buffer means of the captured pixels px, which hold every pixel of
    each one's (2r+1)^2 window.  The other pixels are NaN: a window that
    reached one would read NaN."""
    tq = ref.t_quantiles()
    mc, d = ref.corrected_stats(rad["n"], rad["mean"], rad["m2"], rad["m3"],
                                tq, dtype)
    G = 3 * len(gbufs)
    full = torch.full((H * W, 9 + G), float("nan"), dtype=F64,
                      device=px.device)
    full[px] = torch.cat([mc.to(F64), d.to(F64), rad["film_mean"].to(F64)]
                         + [g["mean"].to(F64) for g in gbufs], -1)
    full = full.reshape(H, W, -1)
    return ref.filter_at(ys, xs, full[..., 0:3], full[..., 3:6],
                         full[..., 6:9], full[..., 9:], gb_sd, r, fsd,
                         dtype)[0]


def _streams():
    """The program's moment streams by name: their keys in its state."""
    from statmc_tpu_torch.stats import estimator as E

    return {"radiance": E.RADIANCE, "normal": E.STAT_NORMAL,
            "albedo": E.STAT_ALBEDO}


def denoise_check(frames, kept, H, W, cfg, limits, seed, k,
                  control: bool = False):
    from . import cells

    r = int(cells.setting(cfg, "filterradius")[0])
    fsd = float(cells.setting(cfg, "filtersd")[0])
    names = cells.setting(cfg, "filterbuffers")
    sds = cells.setting(cfg, "filterbuffersds")
    gb_sd = [float(s) for s, nm in zip(sds, names) for _ in range(3)]
    tq = ref.t_quantiles()
    g = np.random.default_rng(int(seed) % (1 << 63))
    gaps = {"filter_gap": 0.0, "mean_corr_gap": 0.0, "disc_gap": 0.0}
    for j, res in sorted(kept.items()):
        f = frames[j]
        dev = f["n"].device
        px = torch.as_tensor(g.choice(H * W, size=min(k, H * W),
                                      replace=False), device=dev)
        ys, xs = px // W, px % W
        gb = torch.cat([f[nm] for nm in names], -1).reshape(H, W, -1)
        out = {}
        for dt in ((F64, BF16) if control else (F64,)):
            mc, d = ref.corrected_stats(f["n"], f["mean"], f["m2"], f["m3"],
                                        tq, dt)
            ff = ref.filter_at(ys, xs, mc.reshape(H, W, 3),
                               d.reshape(H, W, 3),
                               f["film_mean"].reshape(H, W, 3), gb, gb_sd, r,
                               fsd, dt)[0]
            out[dt] = (ff, mc[px], d[px])
        ff_r, mc_r, d_r = out[F64]
        ff_p, mc_p, d_p = (out[BF16] if control else
                           (res["film_mean_f"][0][px],
                            res["mean_corr"][0][px],
                            res["discriminator"][0][px]))
        for key, p_, r_ in (("filter_gap", ff_p, ff_r),
                            ("mean_corr_gap", mc_p, mc_r),
                            ("disc_gap", d_p, d_r)):
            gaps[key] = max(gaps[key], _rel_gap(p_, r_))
    return _numbers(gaps, limits)


def correct(numbers) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in numbers)
