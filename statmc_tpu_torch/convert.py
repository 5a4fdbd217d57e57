"""Carry the JAX package's objects, once converted to numpy, into the
port's types.  Used to run a JAX module and its counterpart on identical
inputs; imports numpy and torch only (``np.asarray`` accepts JAX arrays).
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.fused import FusedTris
from .accel.kdtree import KdTreeTris
from .accel.twolevel import TwoLevelTris
from .render.fourier import FourierTables
from .render.lightdistrib import LightDistribution
from .render.realistic import LensSystem
from .render.sss import SSSTables
from .scene.build import SceneTables
from .scene.textures import TextureTable


def scene_tables(scene, device="cpu") -> SceneTables:
    """A JAX-package SceneTables -> the port's SceneTables on `device`
    (its texture table, environment-map tables, image-light rows, BSSRDF,
    media and Fourier tables and camera medium included; the JAX
    package's SceneFlags become the port's four flags)."""
    flags = {f: bool(getattr(scene.flags, f))
             for f in ("has_textures", "has_image_lights", "has_hair",
                       "has_sss")}
    tex = TextureTable(*[x if isinstance(x, (bool, tuple, type(None)))
                         else np.asarray(x) for x in scene.textures])
    sss = (None if scene.sss is None
           else SSSTables(*[np.asarray(x) for x in scene.sss]))
    fourier = (None if scene.fourier is None
               else FourierTables(*[np.asarray(x) for x in scene.fourier]))
    fields = {f: np.asarray(getattr(scene, f)) for f in SceneTables._fields
              if f not in ("textures", "sss", "fourier", "cam_medium",
                           *flags)}
    return SceneTables(textures=tex, sss=sss, fourier=fourier,
                       cam_medium=int(scene.cam_medium), **fields,
                       **flags).to_device(device)


def fused_tris(ft, device="cpu") -> FusedTris:
    """A JAX-package FusedTris -> the port's FusedTris on `device`."""
    return FusedTris(
        edge_table=np.asarray(ft.edge_table),
        plane_table=np.asarray(ft.plane_table),
        tile_bounds=np.asarray(ft.tile_bounds),
        perm=None if ft.perm is None else np.asarray(ft.perm),
        n_tris=int(ft.n_tris)).to_device(device)


def twolevel_tris(tl, device="cpu") -> TwoLevelTris:
    """A JAX-package TwoLevelTris -> the port's TwoLevelTris on `device`."""
    return TwoLevelTris(
        table=np.asarray(tl.table), bounds=np.asarray(tl.bounds),
        bounds_planar=np.asarray(tl.bounds_planar),
        perm=None if tl.perm is None else np.asarray(tl.perm),
        n_tris=int(tl.n_tris), n_sub=int(tl.n_sub), fsub=int(tl.fsub),
        world_lo=np.asarray(tl.world_lo),
        world_ext=np.asarray(tl.world_ext)).to_device(device)


def kdtree_tris(kd, device="cpu") -> KdTreeTris:
    """A JAX-package KdTreeTris -> the port's KdTreeTris on `device`."""
    return KdTreeTris(*[x if isinstance(x, int) else np.array(x)
                        for x in kd]).to_device(device)


def lens_system(lens, device="cpu") -> LensSystem:
    """A JAX-package LensSystem -> the port's (its prescription stays a
    tuple of Python floats; the pupil bounds and film extent become
    tensors on `device`)."""
    return lens._replace(
        pupil_bounds=torch.tensor(np.asarray(lens.pupil_bounds),
                                  device=device),
        film_ext=torch.tensor(np.asarray(lens.film_ext), device=device))


def light_distribution(dist, device="cpu") -> LightDistribution:
    """A JAX-package LightDistribution -> the port's on `device`."""
    return LightDistribution(
        cdf=torch.tensor(np.asarray(dist.cdf), device=device),
        pmf=torch.tensor(np.asarray(dist.pmf), device=device),
        grid_res=None if dist.grid_res is None else tuple(dist.grid_res),
        world_lo=torch.tensor(np.asarray(dist.world_lo), device=device),
        world_inv_extent=torch.tensor(np.asarray(dist.world_inv_extent),
                                         device=device))


def albedo_luts(luts, device="cpu"):
    """(lut_d, lut_rest) -> tensors on `device` (None stays None)."""
    if luts is None:
        return None
    return tuple(torch.tensor(np.asarray(x), device=device) for x in luts)


def moment_states(states: dict, device="cpu") -> dict:
    """{type: {n, mean, m2, m3, film_mean, ...}} -> tensors on `device`."""
    return {t: {k: torch.as_tensor(np.array(v), device=device)
                for k, v in st.items()} for t, st in states.items()}


def renderer_state(jr, tr) -> None:
    """Carry a JAX-package Renderer's estimator state into the port's
    Renderer `tr` (same scene): moment states, film, ray total, STAT
    counters and the ACRR/SMIS feedback (avg_ls, win_b, win_l), with the
    JAX package's pixel padding sliced off.  `tr` can then render the
    next iteration from where `jr` stopped."""
    P, dev = tr.P, tr.device

    def t(x):
        return torch.as_tensor(np.array(x), device=dev)

    tr.states = {k: {f: t(v)[:, :P] for f, v in st.items()}
                 for k, st in jr.states.items()}
    for name in ("film_sum", "film_w", "avg_ls", "win_b", "win_l"):
        setattr(tr, name, t(getattr(jr, name))[:P])
    tr.ray_total = t(jr.ray_total)
    tr.stats = {k: t(v) for k, v in jr.stats.items()}


# The estimator state of each alternative integrator (render/ao.py,
# render/sppm.py, render/bdpt.py, render/pssmlt.py): tensors, Python ints,
# Python floats, and tuples of tensors.
_ALT_STATE = {"AORenderer": (("film_sum",), ("n_cam",), (), ()),
              "SPPMRenderer": (("radius", "n_acc", "tau", "Ld"),
                               ("n_iters", "total_photons"), (), ()),
              "BDPTRenderer": (("film_sum", "splat_sum"), ("n_samples",),
                               (), ()),
              "MLTRenderer": (("splat", "key"), ("n_mut",), ("b",),
                              ("_chains",))}


def _tensor(x, device):
    """A JAX array -> a tensor; uint32 (keys) as int64, as core/rng.py
    holds them."""
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def alt_renderer_state(jr, tr) -> None:
    """Carry a JAX-package AO, SPPM, BDPT or MLT renderer's state into the
    port's renderer `tr` of the same kind and scene (AO: film_sum, n_cam;
    SPPM: radius, n_acc, tau, Ld, n_iters, total_photons; BDPT: film_sum,
    splat_sum, n_samples; MLT: the chains (U, y, L, pix), b, splat, key,
    n_mut) and its ray total, so `tr` renders the next iteration from
    where `jr` stopped."""
    tensors, ints, floats, tuples = _ALT_STATE[type(tr).__name__]
    for name in tensors:
        setattr(tr, name, _tensor(getattr(jr, name), tr.device))
    for name in ints:
        setattr(tr, name, int(getattr(jr, name)))
    for name in floats:
        setattr(tr, name, float(getattr(jr, name)))
    for name in tuples:
        setattr(tr, name, tuple(_tensor(x, tr.device)
                                for x in getattr(jr, name)))
    tr.ray_total = torch.as_tensor(np.array(jr.ray_total), device=tr.device)
