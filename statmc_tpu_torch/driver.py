"""Iterative render -> denoise driver (port of statmc_tpu/driver.py).

Per iteration: render a growing sample batch with the path-regeneration
wavefront, merge the per-pixel statistics, denoise every DenoiseGroup
buffer and feed the denoised per-bounce means and MIS win rates back
into the next iteration's ACRR/SMIS decisions
(src/statistics/statpath.cpp:172-440).  Film and moments stay on the
chosen device throughout; the moment states are updated in place, block
by block.

Entry points: ``load(path, device=...).render(iterations=...)`` and the
command line, ``python -m statmc_tpu_torch`` (__main__.py).  Path
regeneration (make_regen_chunk_fn) renders every sampler mode but the
lockstep table, which pins the per-sample driver (make_chunk_fn), as
volpath scenes with media and realistic cameras do; ``ao``, ``sppm``,
``bdpt`` and ``mlt`` have their own drivers behind
``render/alt_integrators.py``, which ``load`` dispatches to;
``Renderer.render_lockstep_exact`` replays the reference's own draw
streams; ``denoise_from_disk`` re-filters a written PFM set; and
``save_checkpoint``/``restore_checkpoint`` resume a render bit for bit.
"""
from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from . import spans
from .accel.fused import FUSED_MAX_TRIS, FusedTris
from .accel.kdtree import KdTreeTris
from .accel.twolevel import TwoLevelTris
from .core import rng as crng
from .core import spectrum as spec
from .denoise.filter import StatDenoiser
from .io.pfm import read_pfm, write_pfm
from .io.progress import ProgressReporter
from .render import camera as CAM
from .render.albedo_lut import precompute_material_curves
from .render.integrator import IntegratorConfig, trace, trace_wavefront
from .render.lightdistrib import make_distribution
from .scene.api import SceneDescription, parse_scene
from .scene.build import SceneTables, build_scene
from .stats import estimator as E
from .stats import moments

# Pixels per trace_wavefront call.  Lanes are independent, so the block
# size changes memory use and launch counts, never results.
PIXEL_BLOCK = 1 << 20


@dataclass
class RenderSetup:
    scene: SceneTables  # tensors on `device`
    bvh: Any  # FusedTris / TwoLevelTris / KdTreeTris, None without triangles
    dist: Any  # LightDistribution
    cam: CAM.CameraParams
    icfg: IntegratorConfig
    ecfg: E.EstimatorConfig
    width: int
    height: int
    filename: str
    device: torch.device
    base_seed: int = 0
    pixel_mask: Any = None  # [P] bool crop (integrator pixelbounds)
    albedo_luts: Any = None  # (lut_d [M,K,3], lut_rest [M,K,3]) or None
    lockstep_tab: Any = None  # [P,S,D] pbrt-stream replay (core/lockstep.py)


def _morton_order_scene(scene_np: SceneTables) -> SceneTables:
    """Reorder the triangle tables into Morton order (copied from
    statmc_tpu/driver.py:59): the fused packer's internal order becomes
    the identity, so hit ids need no remap; area-triangle lights follow
    their triangles through the inverse permutation."""
    from .accel.fused import _morton

    T = scene_np.tri_p0.shape[0]
    if T == 0:
        return scene_np
    lo = np.minimum(np.minimum(scene_np.tri_p0,
                               scene_np.tri_p0 + scene_np.tri_e1),
                    scene_np.tri_p0 + scene_np.tri_e2)
    hi = np.maximum(np.maximum(scene_np.tri_p0,
                               scene_np.tri_p0 + scene_np.tri_e1),
                    scene_np.tri_p0 + scene_np.tri_e2)
    order = np.argsort(_morton(0.5 * (lo + hi)), kind="stable")
    if np.array_equal(order, np.arange(T)):
        return scene_np
    inv = np.empty(T, np.int64)
    inv[order] = np.arange(T)
    fields = {}
    for name in ("tri_p0", "tri_e1", "tri_e2", "tri_n0", "tri_n1",
                 "tri_n2", "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat",
                 "tri_light", "tri_has_normals", "tri_med_in",
                 "tri_med_out"):
        fields[name] = np.asarray(getattr(scene_np, name))[order]
    lp = np.asarray(scene_np.light_prim).copy()
    if lp.size:
        is_tri = np.asarray(scene_np.light_kind) == 0  # LIGHT_AREA_TRI
        lp[is_tri] = inv[lp[is_tri]]
        fields["light_prim"] = lp
    return scene_np._replace(**fields)


def _device(device) -> torch.device:
    """The render device; a CUDA device without CUDA raises (the port
    never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("statmc_tpu_torch: device 'cuda' was asked for "
                           "but torch finds no CUDA device; pass "
                           "device='cpu' to run the plain PyTorch kernels")
    return device


def prepare(desc: SceneDescription, base_seed: int = 0, device="cuda",
            strict_assets: bool | None = None) -> RenderSetup:
    device = _device(device)
    scene_np = _morton_order_scene(build_scene(desc, strict=strict_assets))
    n_tris = scene_np.tri_p0.shape[0]
    width = int(desc.film_params.find_one("xresolution", 640))
    height = int(desc.film_params.find_one("yresolution", 480))
    filename = str(desc.film_params.find_one("filename", "out.pfm"))
    direct_only = desc.integrator_name in ("directlighting", "whitted")
    # volpath runs the media-aware bounce loop (render/volume.py) when the
    # scene declares media; without media it is the surface path tracer.
    volumetric = (desc.integrator_name == "volpath"
                  and len(desc.named_media) > 0)

    pixel_samples = int(desc.sampler_params.find_one("pixelsamples", 16))
    ecfg = E.derive_config(desc.integrator_params, desc.extra_params,
                           pixel_samples)

    sw = desc.camera_params.find_floats("screenwindow")
    if desc.camera_name == "orthographic":
        cam = CAM.make_orthographic(desc.camera_to_world, width, height, sw,
                                    device=device)
    elif desc.camera_name == "environment":
        cam = CAM.make_environment(desc.camera_to_world, width, height,
                                   device=device)
    elif desc.camera_name == "realistic":
        cam = _realistic_camera(desc, width, height, device)
    else:
        fov = float(desc.camera_params.find_one("fov", 90.0))
        cam = CAM.make_perspective(desc.camera_to_world, fov, width, height,
                                   sw, device=device)

    # Ray-cone constants from two adjacent probe rays, scaled by the
    # reference's 1/sqrt(spp) differential factor (statpath.cpp:301-303).
    c = width * height // 2 + width // 2
    probe = torch.tensor([[c % width + 0.5, c // width + 0.5],
                          [c % width + 1.5, c // width + 0.5]],
                         dtype=torch.float32, device=device)
    o_pr, d_pr = (x.cpu().numpy() for x in CAM.generate_rays(cam, probe))
    diff_scale = 1.0 / np.sqrt(max(pixel_samples, 1))
    cone0 = float(np.linalg.norm(o_pr[1] - o_pr[0])) * diff_scale
    cone_spread = float(np.arccos(np.clip(np.dot(d_pr[0], d_pr[1]),
                                          -1.0, 1.0))) * diff_scale

    rad = ecfg.configs[E.RADIANCE]
    has_null = bool(np.any(scene_np.mat_type == 0))  # MAT_NONE
    icfg = IntegratorConfig(
        max_depth=ecfg.max_depth,
        n_ls=max(rad.bounce_end, 1),
        nb_mis=(ecfg.configs[E.MIS_BSDF_WIN_RATE].bounce_end
                if ecfg.enable_smis else 0),
        enable_smis=ecfg.enable_smis,
        enable_acrr=ecfg.enable_acrr,
        rr_threshold=ecfg.rr_threshold,
        sampler_mode=crng.SAMPLER_MODES.get(desc.sampler_name,
                                            crng.MODE_RANDOM),
        cone0=cone0,
        cone_spread=cone_spread,
        direct_only=direct_only,
        null_extra=8 if has_null else 0,
        mat_types=frozenset(np.unique(scene_np.mat_type).tolist()),
        enable_sss=scene_np.sss is not None,
        volumetric=volumetric,
        has_grid_media=volumetric and scene_np.has_grid_media,
    )

    pb = desc.integrator_params.find_ints("pixelbounds")
    pixel_mask = None
    if pb is not None and len(pb) == 4:
        xs = np.arange(width * height) % width
        ys = np.arange(width * height) // width
        pixel_mask = torch.as_tensor(
            (xs >= pb[0]) & (xs < pb[1]) & (ys >= pb[2]) & (ys < pb[3]),
            device=device)

    # Up to FUSED_MAX_TRIS the fused table (kernel B1); above it the
    # two-level traversal (kernels B3 and B4); under `Accelerator
    # "kdtree"` the kd-restart walk (no kernel), as statmc_tpu/driver.py
    # chooses.  The scene is Morton-ordered already, so perm is None.
    bvh = None
    if n_tris > 0:
        if getattr(desc, "accelerator_name", "bvh") == "kdtree":
            acc = KdTreeTris
        else:
            acc = FusedTris if n_tris <= FUSED_MAX_TRIS else TwoLevelTris
        bvh = acc.from_tris(scene_np.tri_p0, scene_np.tri_e1,
                            scene_np.tri_e2).to_device(device)
    dist = make_distribution(scene_np, ecfg.light_strategy, device=device)
    scene = scene_np.to_device(device)
    albedo_luts = (precompute_material_curves(scene)
                   if ecfg.configs[E.STAT_ALBEDO].enable else None)

    # Lockstep sampler: the reference's serial PCG32 draw streams as a
    # (pixel, sample, dim) table (core/lockstep.py), for parity runs.
    lockstep_tab = None
    if desc.sampler_name == "lockstep":
        from .core import lockstep as LS

        total_spp = (pixel_samples << (ecfg.iterations - 1)
                     if ecfg.exp_iterations
                     else pixel_samples * ecfg.iterations)
        D = LS.dims_per_sample(ecfg.max_depth + 1)
        nbytes = width * height * total_spp * D * 4
        if nbytes > 1 << 29:
            raise ValueError(
                "lockstep sampler table would need "
                f"{nbytes / 1e9:.1f} GB; lockstep mode is for parity "
                "runs at reduced resolution/spp")
        lockstep_tab = torch.as_tensor(LS.make_table(
            width, height, total_spp, ecfg.max_depth + 1, base_seed),
            device=device)
    return RenderSetup(
        scene=scene, bvh=bvh, dist=dist, cam=cam, icfg=icfg, ecfg=ecfg,
        width=width, height=height, filename=filename, device=device,
        base_seed=base_seed, pixel_mask=pixel_mask, albedo_luts=albedo_luts,
        lockstep_tab=lockstep_tab)


def _realistic_camera(desc: SceneDescription, width: int, height: int,
                      device) -> CAM.CameraParams:
    """Camera "realistic" (src/cameras/realistic.cpp): the lens file is
    read relative to the scene's directory (statmc_tpu/driver.py:137-156)."""
    lf = str(desc.camera_params.find_one("lensfile", ""))
    if not lf:
        raise ValueError('Camera "realistic" requires "lensfile"')
    if not os.path.isabs(lf):
        lf = os.path.join(desc.cwd, lf)
    rows = []
    with open(lf) as f:
        for line in f:
            rows.extend(float(tok) for tok in line.split("#", 1)[0].split())
    return CAM.make_realistic(
        desc.camera_to_world, np.asarray(rows, np.float64), width, height,
        float(desc.camera_params.find_one("aperturediameter", 1.0)),
        float(desc.camera_params.find_one("focusdistance", 10.0)),
        float(desc.film_params.find_one("diagonal", 35.0)), device=device)


def zero_stats(device) -> dict:
    return {k: torch.zeros((), device=device)
            for k in ("n_camera_rays", "zero_paths", "total_paths",
                      "path_len_sum", "path_len_max")}


def _count_stats(sa: dict, out, df) -> None:
    """STAT counters (core/stats.h; statpath.cpp:29-31) of the samples
    that finished in lanes df [P] float: nCameraRays, zero-radiance
    paths, total paths, path-length sum and maximum."""
    L = out.ls[:, 0, :]
    sa["n_camera_rays"] = sa["n_camera_rays"] + torch.sum(df)
    sa["zero_paths"] = sa["zero_paths"] + torch.sum(
        df * (torch.sum(L, -1) == 0.0))
    sa["total_paths"] = sa["total_paths"] + torch.sum(df)
    sa["path_len_sum"] = sa["path_len_sum"] + torch.sum(out.path_len * df)
    sa["path_len_max"] = torch.maximum(sa["path_len_max"],
                                       torch.max(out.path_len * df))


def make_sample_fn(setup: RenderSetup):
    """One sample on a set of pixel lanes (statmc_tpu/driver.py:297
    make_sample_fn), shared by the per-sample chunk (make_chunk_fn) and
    the mesh's chunk (parallel/shard.py).  It carries the lockstep table,
    the LD samplers, volpath with media, the realistic camera's weight and
    the pixelbounds crop to both."""
    icfg, ecfg, cam = setup.icfg, setup.ecfg, setup.cam
    W = setup.width
    mode = icfg.sampler_mode
    if icfg.volumetric:
        from .render.volume import trace_volpath as trace_fn
    else:
        trace_fn = trace

    def sample_step(states, film_sum, film_w, ray_total, stats_acc, base_key,
                    sample_index: int, pixel_ids, avg_ls, win_b, win_l,
                    feedback_on: bool, valid=None):
        """Traces sample `sample_index` of the pixels `pixel_ids` [n].
        states [NB,n,C], film_sum [n,3], film_w, avg_ls, win_b and win_l
        [n(,.)] hold those lanes (views are fine) and are updated in
        place, as are the STAT counters in stats_acc; returns the new ray
        total.  valid [n] bool marks the real lanes: a mesh's pad lanes
        re-trace an aliased pixel and stay out of the counters (their
        film and moments land in pad rows that nothing reads)."""
        dev = pixel_ids.device
        keys = crng.pixel_keys(base_key, pixel_ids, sample_index)
        ld = None
        if mode == crng.MODE_LOCKSTEP:
            ld = (setup.lockstep_tab[pixel_ids], sample_index)
        elif mode != crng.MODE_RANDOM:
            ld = (crng.pixel_scramble(base_key, pixel_ids), sample_index)
        u_cam = crng.draw_2d(keys, ld, mode, 0, crng.SLOT_CAMERA)
        pxy = torch.stack([(pixel_ids % W).to(torch.float32),
                           (pixel_ids // W).to(torch.float32)], dim=-1)
        if cam.lens is not None:
            # Realistic camera: pupil sample + per-ray We weight
            # (realistic.cpp:GenerateRay), folded into ls.
            u_lens = crng.draw_2d(keys, ld, mode, 0, crng.SLOT_LENS)
            o, d, cam_w = CAM.generate_rays_weighted(cam, pxy + u_cam, u_lens)
        else:
            o, d = CAM.generate_rays(cam, pxy + u_cam)
        out = trace_fn(setup.scene, setup.bvh, setup.dist, icfg, o, d, keys,
                       avg_ls, win_b, win_l, feedback_on,
                       albedo_luts=setup.albedo_luts, ld_stream=ld)
        if cam.lens is not None:
            out = out._replace(ls=out.ls * cam_w[:, None, None])
        L = out.ls[:, 0, :]
        _count_stats(stats_acc, out,
                     torch.ones((pixel_ids.shape[0],), device=dev)
                     if valid is None else valid.to(torch.float32))
        if setup.pixel_mask is not None:
            mask = setup.pixel_mask[pixel_ids]
            mf = mask.to(torch.float32)
            film_sum += L * mf[:, None]
            film_w += mf
        else:
            mask = None
            film_sum += L
            film_w += 1.0
        for t, st in E.update_states(states, ecfg, out, mask).items():
            for k, v in st.items():
                states[t][k].copy_(v)
        return ray_total + torch.sum(out.n_rays)

    return sample_step


def lanes(states: dict, start: int, end: int) -> dict:
    """Views of the moment states' pixel lanes [start, end)."""
    return {t: {k: v[:, start:end] for k, v in st.items()}
            for t, st in states.items()}


def make_chunk_fn(setup: RenderSetup):
    """Per-sample chunk function (statmc_tpu/driver.py:make_chunk_fn): for
    each of `n_samples` samples, every pixel block runs make_sample_fn's
    step.  Same signature and results as make_regen_chunk_fn; the
    lockstep sampler pins it, since its table is addressed by sample, and
    so do volpath scenes with media, whose bounce loop (render/volume.py)
    it calls in place of ``integrator.trace``, and realistic cameras,
    whose per-ray weight scales every statistic of the sample."""
    sample_step = make_sample_fn(setup)
    P = setup.width * setup.height
    dev = setup.device

    def chunk(states, film_sum, film_w, ray_total, stats_acc, base_key,
              sample_start: int, avg_ls, win_b, win_l, feedback_on: bool,
              n_samples: int):
        for s in range(n_samples):
            for start in range(0, P, PIXEL_BLOCK):
                end = min(start + PIXEL_BLOCK, P)
                ids = torch.arange(start, end, dtype=torch.int32, device=dev)
                ray_total = sample_step(
                    lanes(states, start, end), film_sum[start:end],
                    film_w[start:end], ray_total, stats_acc, base_key,
                    sample_start + s, ids, avg_ls[start:end],
                    win_b[start:end], win_l[start:end], feedback_on)
        return ray_total

    return chunk


def make_regen_chunk_fn(setup: RenderSetup):
    """Path-regeneration chunk function: traces `n_samples` samples per
    pixel, a loop over pixel blocks of trace_wavefront.  Updates the
    moment states, film sums and counters in place; returns the new
    ray total."""
    icfg, ecfg = setup.icfg, setup.ecfg
    W, P = setup.width, setup.width * setup.height
    dev = setup.device

    def chunk(states, film_sum, film_w, ray_total, stats_acc, base_key,
              sample_start: int, avg_ls, win_b, win_l, feedback_on: bool,
              n_samples: int):
        for start in range(0, P, PIXEL_BLOCK):
            end = min(start + PIXEL_BLOCK, P)
            ids = torch.arange(start, end, dtype=torch.int32, device=dev)
            blk = {"st": {t: {k: v[:, start:end] for k, v in st.items()}
                          for t, st in states.items()},
                   "rt": ray_total}
            fs_b, fw_b = film_sum[start:end], film_w[start:end]
            crop = (setup.pixel_mask[start:end]
                    if setup.pixel_mask is not None else None)
            pxy = torch.stack([(ids % W).to(torch.float32),
                               (ids // W).to(torch.float32)], dim=-1)

            def gen_ray(u_cam):
                # Box filter, radius 0.5: each sample lands in its pixel.
                return CAM.generate_rays(setup.cam, pxy + u_cam)

            def record(out, done):
                m = done if crop is None else (done & crop)
                mf = m.to(torch.float32)
                L = out.ls[:, 0, :]
                fs_b.copy_(fs_b + L * mf[:, None])
                fw_b.copy_(fw_b + mf)
                blk["st"] = E.update_states(blk["st"], ecfg, out, m)
                blk["rt"] = blk["rt"] + torch.sum(out.n_rays)
                _count_stats(stats_acc, out, done.to(torch.float32))

            trace_wavefront(
                setup.scene, setup.bvh, setup.dist, icfg, gen_ray, ids,
                base_key, sample_start, n_samples, avg_ls[start:end],
                win_b[start:end], win_l[start:end], feedback_on, record,
                albedo_luts=setup.albedo_luts)
            for t, st in blk["st"].items():
                for k, v in st.items():
                    states[t][k][:, start:end] = v
            ray_total = blk["rt"]
        return ray_total

    return chunk


def _adapt_sharded_chunk(sharded_fn, P: int, lo: int, Pl: int, device):
    """Fit the mesh's chunk (parallel/shard.py) to the driver's chunk
    signature (statmc_tpu/driver.py:681): this rank's pixel ids, pad lanes
    aliased to pixel P - 1 and marked invalid, and the chunk's STAT
    counter increment folded into the running counters."""
    ids = torch.arange(lo, lo + Pl, dtype=torch.int32, device=device)
    pixel_ids = torch.clamp(ids, max=P - 1)
    lane_valid = ids < P

    def wrapper(states, film_sum, film_w, ray_total, stats_acc, base_key,
                sample_start: int, avg_ls, win_b, win_l, feedback_on: bool,
                n_samples: int):
        ray_total, delta = sharded_fn(
            states, film_sum, film_w, ray_total, base_key, sample_start,
            pixel_ids, lane_valid, avg_ls, win_b, win_l, feedback_on,
            n_samples)
        for k, v in delta.items():
            stats_acc[k] = (torch.maximum(stats_acc[k], v)
                            if k == "path_len_max" else stats_acc[k] + v)
        return ray_total

    return wrapper


class Renderer:
    """Owns device state across the iteration loop; the analogue of
    StatPathIntegrator::Render (statpath.cpp:118-440).

    With a mesh (parallel/shard.py: one process a rank), each rank holds
    the slab of Pl pixels [lo, lo + Pl) of the image padded to Pp: its
    film, moments and feedback buffers; samples stride over the "spp"
    axis and merge with Chan's combine.  film_mean, buffers,
    write_outputs, save_checkpoint and denoise_from_disk then see the
    whole image (gathered over "px"; collectives that every rank calls),
    and only rank 0 writes or prints.

    denoiser: a StatDenoiser (say, with range_bf16=True) that replaces the
    default one, as statmc_tpu/driver.py:711's; the default is
    StatDenoiser's defaults when a type is in the DenoiseGroup, else
    none."""

    def __init__(self, setup: RenderSetup, denoiser=None, mesh=None):
        self.s = setup
        self.device = setup.device
        self.mesh = mesh
        P = setup.width * setup.height
        self.P = P
        if mesh is not None:
            from .parallel.shard import make_sharded_chunk_fn, pad_pixels

            n_spp, n_px = mesh.shape["spp"], mesh.shape["px"]
            self.Pp = pad_pixels(P, n_px)
            self.Pl = self.Pp // n_px
            self.lo = mesh.px_index * self.Pl
            self.chunk_fn = _adapt_sharded_chunk(
                make_sharded_chunk_fn(setup, mesh), P, self.lo, self.Pl,
                self.device)
            # Each dispatch strides its samples over "spp".
            self.max_samples_per_dispatch = max(4, n_spp) // n_spp * n_spp
        else:
            self.Pp = self.Pl = P
            self.lo = 0
            # Path regeneration is the product path; the lockstep table,
            # volpath with media and realistic cameras (whose per-ray
            # weight the regeneration carry does not thread) pin the
            # per-sample driver (statmc_tpu/driver.py:733-744).
            self.chunk_fn = (make_chunk_fn(setup)
                             if (setup.icfg.sampler_mode == crng.MODE_LOCKSTEP
                                 or setup.icfg.volumetric
                                 or setup.cam.lens is not None)
                             else make_regen_chunk_fn(setup))
            self.max_samples_per_dispatch = 4  # samples per chunk call
        if denoiser is None and any(c.enable and E.DENOISE_GROUP in c.groups
                                    for c in setup.ecfg.configs):
            denoiser = StatDenoiser(setup.ecfg, setup.width, setup.height,
                                    device=setup.device)
        self.denoiser = denoiser
        self.lead = mesh is None or mesh.rank == 0  # prints and writes
        self.progress = self.lead  # terminal progress bar (TTY only)
        self._slabs = None  # the mesh's denoise: row slabs or replicated
        self.reset()

    def reset(self):
        s, Pl, dev = self.s, self.Pl, self.device
        self.states = E.make_states(s.ecfg, Pl, device=dev)
        self.film_sum = torch.zeros((Pl, 3), device=dev)
        self.film_w = torch.zeros((Pl,), device=dev)
        self.ray_total = torch.zeros((), device=dev)
        self.stats = zero_stats(dev)
        NB = max(s.icfg.nb_mis, 1)
        self.avg_ls = torch.ones((Pl, s.icfg.n_ls), device=dev)
        self.win_b = torch.zeros((Pl, NB), device=dev)
        self.win_l = torch.zeros((Pl, NB), device=dev)
        self.derived = {}
        self.film_f = None
        self.base_key = crng.base_key(s.base_seed, device=dev)

    def render_lockstep_exact(self, spp: int | None = None):
        """Exact serial-consumption lockstep replay: every draw site reads
        the reference's per-tile PCG32 stream at its serial position
        (render/lockstep_exact.py).  A parity instrument."""
        from .render.lockstep_exact import render_exact

        s = self.s
        cfg = s.icfg._replace(sampler_mode=crng.MODE_LOCKSTEP_EXACT)
        return render_exact(
            s.scene, s.bvh, s.dist, cfg, s.cam, s.width, s.height,
            spp if spp is not None else s.ecfg.pixel_samples,
            s.base_seed, albedo_luts=s.albedo_luts)

    def _sync(self):
        with spans.span("sync.iteration"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # -- the mesh's slabs -------------------------------------------------

    def _full(self, x, dim: int = 0):
        """x's pixel axis `dim` over the whole image: under a mesh, the
        "px" slabs gathered (onto every rank) with the pad cut off."""
        if self.mesh is None:
            return x
        from .parallel import comm

        with self.mesh.timed("gather", self.mesh.px_ranks):
            parts = comm.all_gather(x, self.mesh.px_group)
        return torch.cat(parts, dim).narrow(dim, 0, self.P)

    def _full_states(self) -> dict:
        return {t: {k: self._full(v, 1) for k, v in st.items()}
                for t, st in self.states.items()}

    def _slab(self, x, dim: int = 0):
        """This rank's slab of a whole-image tensor (pixel axis `dim`),
        zero-padded to Pl; x itself without a mesh."""
        if self.mesh is None:
            return x
        n = max(0, min(self.Pl, self.P - self.lo))
        part = x.narrow(dim, min(self.lo, self.P), n)
        if n < self.Pl:
            shape = list(x.shape)
            shape[dim] = self.Pl - n
            part = torch.cat([part, x.new_zeros(shape)], dim)
        return part.contiguous()

    @property
    def film_mean(self):
        """Mean film image with pbrt's XYZ round trip (core/film.cpp)."""
        return self._film_rgb(self._full(self.film_sum),
                              self._full(self.film_w))

    @staticmethod
    def _film_rgb(film_sum, film_w):
        rgb = film_sum / torch.clamp(film_w, min=1.0)[..., None]
        return spec.xyz_to_rgb(spec.rgb_to_xyz(rgb))

    def iteration_spp(self, i: int) -> tuple[int, int]:
        """(sample_start, n_samples) for iteration i (1-based);
        statpath.cpp:269-290."""
        spp = self.s.ecfg.pixel_samples
        if i == 1:
            return 0, spp
        if self.s.ecfg.exp_iterations:
            n = spp << (i - 2)
            return n, n
        return (i - 1) * spp, spp

    def total_spp(self, i: int) -> int:
        spp = self.s.ecfg.pixel_samples
        return spp << (i - 1) if self.s.ecfg.exp_iterations else i * spp

    def run_iteration(self, i: int) -> dict:
        """One render(+denoise) iteration; returns a timing dict (under a
        mesh also `comm_s` and `comm_bytes`: the collectives' seconds and
        bytes by kind).  It runs in the span `iteration`, its render in
        `render` (the interval of `render_s`), its denoise in `denoise`."""
        start, n = self.iteration_spp(i)
        with spans.span("iteration", i=i, n_samples=n):
            if self.mesh is not None:
                self.mesh.comm_s.clear()
                self.mesh.comm_bytes.clear()
            # The film restarts every iteration while the moments
            # accumulate; per-iteration radiance stats restart too
            # (statpath.cpp:193-216).
            self.film_sum.zero_()
            self.film_w.zero_()
            if E.IT_RADIANCE in self.states:
                for v in self.states[E.IT_RADIANCE].values():
                    v.zero_()
            self._sync()
            t0 = time.perf_counter()
            with spans.span("render"):
                prog = ProgressReporter(
                    -(-n // self.max_samples_per_dispatch),
                    f"Rendering it {i}", quiet=not self.progress)
                done = 0
                while done < n:
                    step = min(self.max_samples_per_dispatch, n - done)
                    with spans.span("chunk"):
                        self.ray_total = self.chunk_fn(
                            self.states, self.film_sum, self.film_w,
                            self.ray_total, self.stats, self.base_key,
                            start + done, self.avg_ls, self.win_b,
                            self.win_l, i > 1, step)
                    done += step
                    prog.update()
                self._sync()
                prog.finish()
                t_render = time.perf_counter() - t0

            t0 = time.perf_counter()
            t_denoise = 0.0
            if self.denoiser is not None:
                with spans.span("denoise"):
                    self._denoise()
                    self._sync()
                t_denoise = time.perf_counter() - t0
        log = {"iteration": i, "spp": self.total_spp(i),
               "render_s": t_render, "denoise_s": t_denoise,
               "rays_total": float(self.ray_total)}
        if self.mesh is not None:
            log["comm_s"] = dict(self.mesh.comm_s)
            log["comm_bytes"] = dict(self.mesh.comm_bytes)
        return log

    def _sharded_denoise(self) -> bool:
        """Under a mesh: filter row slabs with a halo exchange when the
        rows divide over "px" and a slab is at least the radius tall,
        else the whole image on every rank; says which, once, as
        statmc_tpu/driver.py:919-935 does."""
        if self._slabs is None:
            n_px, H = self.mesh.shape["px"], self.s.height
            r = self.s.ecfg.filter_radius
            self._slabs = n_px > 1 and H % n_px == 0 and H // n_px >= r
            if self._slabs:
                assert self.Pp == self.P, "sharded denoise needs unpadded pixels"
                msg = (f"denoise: sharded over px={n_px} "
                       "(halo-exchange row slabs)")
            elif n_px > 1:
                msg = ("denoise: falling back to the REPLICATED filter — "
                       f"height {H} is "
                       + (f"not divisible by px={n_px}" if H % n_px
                          else f"too short per device for radius {r}"))
            if n_px > 1 and self.lead:
                print(msg, flush=True)
        return self._slabs

    def _denoise(self):
        """Filter every DenoiseGroup buffer and refresh the ACRR/SMIS
        feedback (estimator.cpp:427-489).  Under a mesh either each rank
        filters its row slab, halo-extended by the "px" neighbours' rows
        (statmc_tpu/driver.py:1001 _build_denoise_fn_sharded), or every
        rank filters the gathered image and keeps its slab."""
        s = self.s
        W, H = s.width, s.height
        if self.mesh is not None and self._sharded_denoise():
            from .parallel import comm

            mesh, r = self.mesh, self.denoiser.radius
            hl = H // mesh.shape["px"]
            peers = [mesh.rank] + [q for q in (mesh.prev, mesh.next)
                                   if q is not None]

            def halo(x):
                with mesh.timed("halo", peers):
                    return comm.halo_rows(x, r, mesh.px_group, mesh.prev,
                                          mesh.next)

            film = self._film_rgb(self.film_sum, self.film_w)
            derived, film_f = self._filter(self.states,
                                           film.reshape(hl, W, 3), hl, halo)
        else:
            derived, film_f = self._filter(
                self._full_states(), self.film_mean.reshape(H, W, 3), H)
            if self.mesh is not None:
                derived = {t: {k: self._slab(res[k], 1) for k in
                               ("mean_corr", "discriminator", "film_mean_f")}
                           for t, res in derived.items()}
                if film_f is not None:
                    film_f = self._slab(film_f.reshape(-1, 3))
        self.derived = derived
        self.film_f = film_f
        avg, wins = self._feedback(derived)
        if avg is not None:
            self.avg_ls = avg
        if wins is not None:
            self.win_b, self.win_l = wins

    @spans.spanned("feedback")
    def _feedback(self, derived):
        """(avg_ls, (win_b, win_l)) of the derived buffers, None where a
        type is off: the denoised per-bounce mean luminance feeds ACRR
        (statpath.cpp:306-313), the win rates SMIS."""
        s = self.s
        NL = s.icfg.n_ls
        rad = s.ecfg.configs[E.RADIANCE]
        avg = wins = None
        if rad.enable and E.RADIANCE in derived:
            fmf = derived[E.RADIANCE]["film_mean_f"]  # [NB,P,C]
            lum = spec.luminance(fmf) if rad.n_channels == 3 else fmf[..., 0]
            avg = torch.swapaxes(lum, 0, 1)  # [P,NB]
            if avg.shape[1] < NL:
                avg = torch.nn.functional.pad(avg, (0, NL - avg.shape[1]))
            avg = avg[:, :NL].contiguous()
        if s.ecfg.enable_smis and E.MIS_BSDF_WIN_RATE in derived:
            wins = tuple(torch.swapaxes(derived[t]["film_mean_f"][..., 0], 0,
                                        1).contiguous()
                         for t in (E.MIS_BSDF_WIN_RATE, E.MIS_LIGHT_WIN_RATE))
        return avg, wins

    def _filter(self, states, film, height: int, halo=None):
        """The denoiser over every DenoiseGroup type of `states` (an image
        or a slab `height` rows tall): (derived buffers by type, film-f)."""
        s = self.s
        gbufs = self.denoiser._gbuffers(states, height)
        derived = {}
        film_f = None
        for c in s.ecfg.configs:
            if not c.enable or E.DENOISE_GROUP not in c.groups:
                continue
            res = self.denoiser(states[c.type],
                                film if c.type == E.RADIANCE else None, gbufs,
                                halo=halo)
            if c.type == E.RADIANCE and s.ecfg.denoise_image:
                film_f = res["film_f"]
                if c.n_channels == 3:
                    # With denoiseFilm on, Radiance b0's film-mean-f IS
                    # the filtered film (estimator.cpp:143-146).
                    fmf = res["film_mean_f"].clone()
                    fmf[0] = film_f.reshape(-1, 3)
                    res = dict(res, film_mean_f=fmf)
            derived[c.type] = res
        return derived, film_f

    # -- output -----------------------------------------------------------

    def buffers(self) -> dict:
        """Every named buffer as a numpy array [H,W(,C)] (under a mesh, of
        the whole image on every rank)."""
        s = self.s
        W, H = s.width, s.height
        states = self._full_states()
        named = {"film": self.film_mean.cpu().numpy().reshape(H, W, 3)}
        if self.film_f is not None:
            named["film-f"] = self._full(self.film_f.reshape(-1, 3)).cpu(
            ).numpy().reshape(H, W, 3)
        derived_named = {}
        for t, res in self.derived.items():
            derived_named[t] = {k: self._full(res[k], 1) for k in
                                ("mean_corr", "discriminator", "film_mean_f")
                                if res.get(k) is not None}
        # mean-variance buffers (ProDen group; estimator.cpp:491-569).
        for c in s.ecfg.configs:
            if c.enable and E.MEANVAR_GROUP in c.groups:
                d = derived_named.setdefault(c.type, {})
                d["film_mean_var"] = moments.mean_variance(
                    states[c.type], film=True)
        named.update(E.export_buffers(states, s.ecfg, W, H, derived_named))
        return named

    def write_outputs(self, out_dir: str, iteration: int) -> list[str]:
        """Write regex-selected buffers as <stem>-<spp>-<name>.pfm
        (buffer.cpp:40-53 naming); under a mesh rank 0 writes."""
        s = self.s
        named = self.buffers()
        if not self.lead:
            return []
        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(s.filename))[0]
        spp = self.total_spp(iteration)
        rx = re.compile(s.ecfg.output_regex)
        written = []
        for name, arr in named.items():
            if rx.fullmatch(name):
                path = os.path.join(out_dir, f"{stem}-{spp}-{name}.pfm")
                write_pfm(path, arr)
                written.append(path)
        return written

    def print_stats(self, file=None):
        """PrintStats(stdout) (core/stats.cpp; the counters statpath
        registers at statpath.cpp:29-31), in the JAX package's text.  The
        mesh's counters are summed over every rank already."""
        import sys

        if not self.lead:
            return
        f = file or sys.stdout
        st = {k: float(v) for k, v in self.stats.items()}
        total = max(st["total_paths"], 1.0)
        print("Statistics:", file=f)
        print("  Integrator", file=f)
        print(f"    Camera rays traced {int(st['n_camera_rays'])}", file=f)
        print(f"    Zero-radiance paths {int(st['zero_paths'])} / "
              f"{int(st['total_paths'])} "
              f"({100.0 * st['zero_paths'] / total:.2f}%)", file=f)
        print(f"    Path length: avg {st['path_len_sum'] / total:.3f}, "
              f"max {int(st['path_len_max'])}", file=f)

    def denoise_from_disk(self, out_dir: str, iteration: int) -> list[str]:
        """--denoise mode: read a written buffer set back by its file names
        and run only the filter (statpath.cpp:456-550); the sufficient
        statistics on disk are a complete checkpoint of the estimator.
        Returns the files written."""
        import glob as globmod

        s = self.s
        stem = os.path.splitext(os.path.basename(s.filename))[0]
        prefix = os.path.join(out_dir,
                              f"{stem}-{self.total_spp(iteration)}-")
        dev = self.device

        film_path = prefix + "film.pfm"
        if os.path.exists(film_path):
            img = torch.as_tensor(read_pfm(film_path).reshape(-1, 3),
                                  device=dev)
            self.film_sum = self._slab(img).clone()
            self.film_w = torch.ones((self.Pl,), device=dev)

        suffix_field = {"n": "n", "mean": "mean", "m2": "m2", "m3": "m3",
                        "film-mean": "film_mean", "film-m2": "film_m2"}
        pat = re.compile(r"t(\d+)-b(\d+)-(.+)$")
        index_to_type = {c.index: c.type for c in s.ecfg.configs if c.enable}
        for path in sorted(globmod.glob(prefix + "*.pfm")):
            name = os.path.basename(path)[len(os.path.basename(prefix)):-4]
            m = pat.match(name)
            if not m:
                continue
            t_idx, b_idx, suffix = int(m.group(1)), int(m.group(2)), m.group(3)
            field = suffix_field.get(suffix)
            if field is None or t_idx not in index_to_type:
                continue
            st = self.states[index_to_type[t_idx]]
            if field not in st:
                continue
            arr = torch.as_tensor(read_pfm(path), device=dev)
            st[field][b_idx] = self._slab(
                arr.reshape(self.P, st[field].shape[-1]))
        self._denoise()
        return self.write_outputs(out_dir, iteration)

    # -- Device-state checkpoints -------------------------------------------
    # torch.save of a plain dict of tensors, read back with weights_only:
    # the estimator's sufficient statistics, the film, the counters and
    # the ACRR/SMIS feedback, so a resumed render equals an uninterrupted
    # one bit for bit (counter-addressed draws).  A mesh writes the whole
    # image in the same format (rank 0 writes), so either kind of
    # Renderer restores either kind of checkpoint.

    _CHECKPOINTED = ("states", "film_sum", "film_w", "ray_total", "stats",
                     "avg_ls", "win_b", "win_l")
    _PER_PIXEL = ("film_sum", "film_w", "avg_ls", "win_b", "win_l")

    def save_checkpoint(self, path: str, next_iteration: int):
        tree = {k: getattr(self, k) for k in self._CHECKPOINTED}
        tree["states"] = self._full_states()
        for k in self._PER_PIXEL:
            tree[k] = self._full(tree[k])
        tree["next_iteration"] = next_iteration
        if self.lead:
            torch.save(tree, path)
        if self.mesh is not None:
            self.mesh.barrier()

    def restore_checkpoint(self, path: str) -> int:
        """Restores the estimator's state; returns the next iteration.
        Under a mesh every rank reads `path`."""
        tree = torch.load(path, map_location=self.device, weights_only=True)
        for k in self._CHECKPOINTED:
            v = tree[k]
            if k == "states":
                v = {t: {f: self._slab(x, 1) for f, x in st.items()}
                     for t, st in v.items()}
            elif k in self._PER_PIXEL:
                v = self._slab(v)
            setattr(self, k, v)
        return int(tree["next_iteration"])

    def render(self, iterations: int | None = None,
               out_dir: str | None = None, verbose: bool = True,
               start_iteration: int = 1) -> list[dict]:
        n_it = iterations or self.s.ecfg.iterations
        logs = []
        for i in range(start_iteration, n_it + 1):
            log = self.run_iteration(i)
            if out_dir is not None:
                t0 = time.perf_counter()
                log["written"] = self.write_outputs(out_dir, i)
                log["output_s"] = time.perf_counter() - t0
            logs.append(log)
            if verbose and self.lead:
                print(f"Iteration: {log['iteration']}\n"
                      f"SPP: {log['spp']}\n"
                      f"Rendering time [ns]: {int(log['render_s'] * 1e9)}\n"
                      f"Denoise time [ns]: {int(log['denoise_s'] * 1e9)}")
        return logs


def load(scene_path: str, base_seed: int = 0, device="cuda",
         strict_assets: bool | None = None, mesh=None):
    """Parse a pbrt scene and build its Renderer on `device` (the card by
    default; "cpu" runs the kernels' plain PyTorch versions).  ``ao``,
    ``sppm``, ``bdpt`` and ``mlt`` get their own drivers
    (render/alt_integrators.py, as statmc_tpu/driver.py:1311-1322
    dispatches), which render on one device and ignore a mesh.

    mesh: None (one device), a parallel.shard.Mesh (this rank's place in
    a torch.distributed world; the scene is built on the mesh's device),
    or "auto": 1 x torch.cuda.device_count() when there is more than one
    card (then inside a world of that many ranks), else no mesh."""
    desc = parse_scene(scene_path)
    if desc.integrator_name in ("ao", "sppm", "bdpt", "mlt"):
        from .render.alt_integrators import make_alt_renderer

        if mesh is not None and mesh != "auto":
            if mesh.rank == 0:
                print(f"mesh: Integrator \"{desc.integrator_name}\" renders "
                      "on one device; the mesh is ignored", flush=True)
            device = mesh.device
        return make_alt_renderer(desc.integrator_name, desc, base_seed,
                                 device=device, strict_assets=strict_assets)
    if mesh == "auto":
        from .parallel.shard import make_mesh

        n = torch.cuda.device_count()
        mesh = make_mesh(1, n) if n > 1 else None
    if mesh is not None:
        from .parallel.shard import replicate_scene

        return Renderer(replicate_scene(desc, mesh, base_seed,
                                        strict_assets), mesh=mesh)
    return Renderer(prepare(desc, base_seed, device=device,
                            strict_assets=strict_assets))
