"""Statistics estimator: config compiler, per-(type,bounce) moment
states and the named buffer taxonomy (port of
statmc_tpu/stats/estimator.py).

``derive_config`` is host code, unchanged; the states are dicts of
tensors with a leading bounce axis ([n_bounces, P, C]).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import numpy as np

from .. import spans
from ..core import spectrum as spec
from ..scene.params import ParamSet
from . import moments

# StatTypeIndex (statpath.h:20-36).
RADIANCE = 0
MIS_BSDF_WIN_RATE = 1
MIS_LIGHT_WIN_RATE = 2
STAT_MATERIAL_ID = 3
STAT_DEPTH = 4
STAT_NORMAL = 5
STAT_ALBEDO = 6
IT_RADIANCE = 7
N_STAT_TYPES = 8

TYPE_NAMES = [
    "Radiance", "MISBSDFWinRate", "MISLightWinRate", "StatMaterialID",
    "StatDepth", "StatNormal", "StatAlbedo", "ItRadiance",
]

# Kernel groups (estimator.h:68-72).
DENOISE_GROUP = 0
MEANVAR_GROUP = 1


@dataclass
class StatTypeConfig:
    type: int = 0
    index: int = 0  # consecutive index among enabled types
    enable: bool = False
    n_bounces: int = 0
    bounce_start: int = 0
    bounce_end: int = 0
    n_channels: int = 1
    transform: bool = False
    max_moment: int = 1
    g_buffer: bool = False
    enable_for_filter: bool = False
    filter_sd: float = 0.0
    groups: tuple = ()


@dataclass
class EstimatorConfig:
    configs: list = field(default_factory=list)  # [N_STAT_TYPES]
    n_enabled: int = 0
    # Integrator-level knobs carried along.
    max_depth: int = 5
    iterations: int = 16
    exp_iterations: bool = True
    multichannel: bool = True
    enable_acrr: bool = False
    enable_smis: bool = False
    denoise_image: bool = False
    calc_it_stats: bool = False
    filter_sd: float = 10.0
    filter_radius: int = 20
    rr_threshold: float = 1.0
    light_strategy: str = "spatial"
    output_regex: str = "film.*"
    tracked_bounces: int = 5
    pixel_samples: int = 16


def derive_config(params: ParamSet, extra: ParamSet,
                  pixel_samples: int = 16) -> EstimatorConfig:
    """The config compiler (statpath.cpp:960-1173), semantically exact."""
    # Every integrator knob is overridable through the ExtraParams
    # channel under the "integrator"-prefixed name, matching the
    # reference's scene-level override reads (statpath.cpp:966-1024
    # reads e.g. "integratormaxdepth", "integratoriterations").
    def g(key, default):
        return extra.find_one("integrator" + key,
                              params.find_one(key, default))

    max_depth = int(g("maxdepth", 5))
    n_tracked = int(g("trackedbounces", max_depth))
    multichannel = bool(g("multichannelstats", True))
    enable_acrr = bool(g("acrr", False))
    enable_smis = bool(g("smis", False))
    calc_proden = bool(g("calcprodenstats", False))
    calc_moon = bool(g("calcmoonstats", False))
    calc_gbuffers = bool(g("calcgbuffers", False))
    calc_stats = bool(g("calcstats", False))
    denoise_image = bool(g("denoiseimage", False))
    calc_it_stats = bool(g("calcitstats", False))

    cfg = EstimatorConfig(
        configs=[StatTypeConfig(type=t) for t in range(N_STAT_TYPES)],
        max_depth=max_depth,
        iterations=int(g("iterations", 16)),
        exp_iterations=bool(g("expiterations", True)),
        multichannel=multichannel,
        enable_acrr=enable_acrr,
        enable_smis=enable_smis,
        denoise_image=denoise_image,
        calc_it_stats=calc_it_stats,
        filter_sd=float(g("filtersd", 10.0)),
        filter_radius=int(g("filterradius", 20)),
        rr_threshold=float(g("rrthreshold", 1.0)),
        light_strategy=str(g("lightsamplestrategy", "spatial")),
        output_regex=str(g("outputregex", "film.*")),
        tracked_bounces=n_tracked,
        pixel_samples=pixel_samples,
    )

    n_enabled = 0
    if enable_acrr or calc_proden or denoise_image or calc_stats or calc_moon:
        c = cfg.configs[RADIANCE]
        c.index = n_enabled
        n_enabled += 1
        c.enable = True
        c.bounce_start = 0
        c.bounce_end = n_tracked if enable_acrr else 1
        c.n_bounces = c.bounce_end - c.bounce_start
        c.n_channels = 3 if multichannel else 1
        if calc_proden or calc_moon:
            c.max_moment = 2
        groups = []
        if enable_acrr or denoise_image or calc_stats:
            c.transform = True
            c.max_moment = 3
        if enable_acrr or denoise_image:
            groups.append(DENOISE_GROUP)
        if calc_proden:
            groups.append(MEANVAR_GROUP)
        c.groups = tuple(groups)

    if enable_smis:
        for t in (MIS_BSDF_WIN_RATE, MIS_LIGHT_WIN_RATE):
            c = cfg.configs[t]
            c.index = n_enabled
            n_enabled += 1
            c.enable = True
            c.bounce_start = 0
            c.bounce_end = n_tracked
            c.n_bounces = n_tracked
            c.n_channels = 1
            c.transform = False
            c.max_moment = 3
            c.groups = (DENOISE_GROUP,)

    # G-buffers (filterbuffers selection, statpath.cpp:1083-1159).
    names = params.find_strings("filterbuffers", ["albedo", "normal"])
    sds = params.find_floats("filterbuffersds", np.array([0.02, 0.1]))
    gbuffer_types = {
        "materialid": (STAT_MATERIAL_ID, 1),
        "depth": (STAT_DEPTH, 1),
        "normal": (STAT_NORMAL, 3),
        "albedo": (STAT_ALBEDO, 3),
    }
    any_stats = (enable_acrr or denoise_image or enable_smis or calc_proden
                 or calc_gbuffers or calc_stats or calc_moon)
    if any_stats:
        for gname, (t, ch) in gbuffer_types.items():
            c = cfg.configs[t]
            if gname in names:
                c.enable = True
                if enable_acrr or denoise_image or enable_smis:
                    c.enable_for_filter = True
                    c.filter_sd = float(sds[list(names).index(gname)])
            if c.enable:
                c.index = n_enabled
                n_enabled += 1
                c.bounce_start = 0
                c.bounce_end = 1
                c.n_bounces = 1
                c.n_channels = ch
                c.g_buffer = True
                c.transform = False
                c.max_moment = 2 if calc_proden else 1
                c.groups = (MEANVAR_GROUP,) if calc_proden else ()

    if calc_it_stats:
        c = cfg.configs[IT_RADIANCE]
        c.index = n_enabled
        n_enabled += 1
        c.enable = True
        c.bounce_start = 0
        c.bounce_end = 1
        c.n_bounces = 1
        c.n_channels = 3
        c.transform = False
        c.max_moment = 2

    cfg.n_enabled = n_enabled
    return cfg


# ---------------------------------------------------------------------------
# Estimator state
# ---------------------------------------------------------------------------

def make_states(cfg: EstimatorConfig, n_pixels: int, device="cpu") -> dict:
    """One MomentState per enabled type, bounce axis leading:
    states[type] fields are [n_bounces, P, C]."""
    states = {}
    for c in cfg.configs:
        if not c.enable:
            continue
        states[c.type] = moments.make_state(
            (c.n_bounces, n_pixels), c.n_channels,
            transform=c.transform, max_moment=c.max_moment, device=device,
        )
    return states


def stat_sample(x_rgb, n_channels: int):
    """GetStatSample<T> (statpath.h): rgb for multichannel, luminance else."""
    if n_channels == 3:
        return x_rgb
    return spec.luminance(x_rgb)[..., None]


@spans.spanned("moments.update")
def update_states(states: dict, cfg: EstimatorConfig, out,
                  mask=None):
    """Feed one traced sample batch into all enabled moment streams.

    `out` is a render SampleOutput; mirrors the per-sample adds at
    statpath.cpp:357-371.  `mask` [P] restricts updates to pixels inside
    the integrator's pixelbounds crop (statpath.cpp:263).  Runs in the
    span moments.update (spans.py).
    """
    bmask = None if mask is None else mask[None]  # broadcast bounce axis
    new = dict(states)
    c = cfg.configs[RADIANCE]
    if c.enable:
        # ls: [P, NL, 3] -> [NB, P, C]
        s = stat_sample(out.ls, c.n_channels)  # [P,NL,C]
        s = torch.swapaxes(s, 0, 1)[c.bounce_start:c.bounce_end]
        upd = moments.update_transform if c.transform else moments.update
        new[RADIANCE] = upd(states[RADIANCE], s, bmask)
    c = cfg.configs[IT_RADIANCE]
    if c.enable:
        s = torch.swapaxes(out.ls, 0, 1)[c.bounce_start:c.bounce_end]
        new[IT_RADIANCE] = moments.update(states[IT_RADIANCE], s, bmask)
    cb = cfg.configs[MIS_BSDF_WIN_RATE]
    cl = cfg.configs[MIS_LIGHT_WIN_RATE]
    if cb.enable and cl.enable:
        sb_ = torch.swapaxes(out.mis_bsdf, 0, 1)[..., None]
        sl_ = torch.swapaxes(out.mis_light, 0, 1)[..., None]
        new[MIS_BSDF_WIN_RATE] = moments.update(
            states[MIS_BSDF_WIN_RATE],
            sb_[cb.bounce_start:cb.bounce_end], bmask)
        new[MIS_LIGHT_WIN_RATE] = moments.update(
            states[MIS_LIGHT_WIN_RATE],
            sl_[cl.bounce_start:cl.bounce_end], bmask)
    for t, val in (
        (STAT_MATERIAL_ID, out.mat_id[..., None]),
        (STAT_DEPTH, out.depth[..., None]),
        (STAT_NORMAL, out.normal),
        (STAT_ALBEDO, out.albedo),
    ):
        c = cfg.configs[t]
        if c.enable:
            new[t] = moments.update(states[t], val[None], bmask)
    return new


# ---------------------------------------------------------------------------
# Named buffer export (t{X}-b{Y}-{suffix} taxonomy)
# ---------------------------------------------------------------------------

def export_buffers(states: dict, cfg: EstimatorConfig, width: int,
                   height: int, derived: dict | None = None) -> dict:
    """Flatten all stat buffers to {name: np.ndarray[H,W(,3)]}.

    `derived` optionally supplies filter outputs per type:
    {type: {"mean_corr": [NB,P,C], "discriminator": ...,
            "film_mean_f": ..., "film_mean_var": ...}}.
    """
    out = {}

    def img(a):
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        if a.shape[-1] == 1:
            return a.reshape(height, width)
        return a.reshape(height, width, a.shape[-1])

    for c in cfg.configs:
        if not c.enable:
            continue
        st = states[c.type]
        der = (derived or {}).get(c.type, {})
        for j in range(c.n_bounces):
            pre = f"t{c.index}-b{j + c.bounce_start}-"
            out[pre + "n"] = img(st["n"][j])
            out[pre + "mean"] = img(st["mean"][j])
            if "m2" in st:
                out[pre + "m2"] = img(st["m2"][j])
            if "m3" in st:
                out[pre + "m3"] = img(st["m3"][j])
            # film duals: alias stat buffers when no transform
            # (estimator.cpp:128-137).
            fm = st.get("film_mean", st["mean"])
            fm2 = st.get("film_m2", st.get("m2"))
            out[pre + "film-mean"] = img(fm[j])
            if fm2 is not None:
                out[pre + "film-m2"] = img(fm2[j])
            for key, suffix in (
                ("mean_corr", "mean-corr"),
                ("discriminator", "discriminator"),
                ("film_mean_f", "film-mean-f"),
                ("film_mean_var", "film-mean-var"),
            ):
                if key in der:
                    out[pre + suffix] = img(der[key][j])
    return out
