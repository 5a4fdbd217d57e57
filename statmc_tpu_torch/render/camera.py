"""Perspective / orthographic / environment / realistic camera rays (port
of statmc_tpu/render/camera.py).  The raster->camera chain is built on
the host in numpy exactly as the JAX package builds it; per-ray work runs
on tensors.  The realistic camera traces its lens system
(render/realistic.py) and weights each ray (generate_rays_weighted)."""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import math as cm


class CameraParams(NamedTuple):
    raster_to_camera: Any  # [4,4] tensor
    camera_to_world: Any  # [4,4] tensor
    dx_camera: Any  # [3]
    dy_camera: Any  # [3]
    orthographic: bool
    environment: bool = False
    inv_res: Any = None  # [2] 1/xres, 1/yres (environment mapping)
    lens: Any = None  # realistic.LensSystem (Camera "realistic") or None
    res: Any = None  # (xres, yres) Python floats, realistic cameras only


def _screen_to_raster(screen, xres, yres):
    return (
        cm.scale_mat([xres, yres, 1.0]).astype(np.float64)
        @ cm.scale_mat(
            [1.0 / (screen[1] - screen[0]),
             1.0 / (screen[2] - screen[3]), 1.0]
        ).astype(np.float64)
        @ cm.translate([-screen[0], -screen[3], 0.0]).astype(np.float64)
    )


def _default_screen(xres, yres, screen_window):
    frame = xres / yres
    if screen_window is not None:
        return np.asarray(screen_window, np.float64)
    if frame > 1.0:
        return np.array([-frame, frame, -1.0, 1.0])
    return np.array([-1.0, 1.0, -1.0 / frame, 1.0 / frame])


def _params(raster_to_camera, camera_to_world, device, **kw):
    p0 = cm.np_transform_point(raster_to_camera, np.zeros(3, np.float32))
    px = cm.np_transform_point(raster_to_camera,
                               np.array([1, 0, 0], np.float32))
    py = cm.np_transform_point(raster_to_camera,
                               np.array([0, 1, 0], np.float32))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return CameraParams(
        raster_to_camera=t(raster_to_camera),
        camera_to_world=t(camera_to_world),
        dx_camera=t(px - p0), dy_camera=t(py - p0), **kw)


def make_orthographic(camera_to_world: np.ndarray, xres: int, yres: int,
                      screen_window=None, device="cpu") -> CameraParams:
    """src/cameras/orthographic.cpp: parallel rays along +z."""
    screen = _default_screen(xres, yres, screen_window)
    raster_to_camera = np.linalg.inv(
        _screen_to_raster(screen, xres, yres)).astype(np.float32)
    return _params(raster_to_camera, camera_to_world, device,
                   orthographic=True)


def make_environment(camera_to_world: np.ndarray, xres: int, yres: int,
                     device="cpu") -> CameraParams:
    """src/cameras/environment.cpp: latitude-longitude ray directions."""
    return CameraParams(
        raster_to_camera=torch.eye(4, device=device),
        camera_to_world=torch.as_tensor(
            camera_to_world.astype(np.float32), device=device),
        dx_camera=torch.zeros(3, device=device),
        dy_camera=torch.zeros(3, device=device),
        orthographic=False,
        environment=True,
        inv_res=torch.tensor([1.0 / xres, 1.0 / yres], dtype=torch.float32,
                             device=device),
    )


def make_perspective(camera_to_world: np.ndarray, fov_deg: float,
                     xres: int, yres: int, screen_window=None,
                     device="cpu") -> CameraParams:
    screen = _default_screen(xres, yres, screen_window)
    camera_to_screen = cm.perspective(fov_deg, 1e-2, 1000.0).astype(np.float64)
    raster_to_screen = np.linalg.inv(_screen_to_raster(screen, xres, yres))
    raster_to_camera = (
        np.linalg.inv(camera_to_screen) @ raster_to_screen
    ).astype(np.float32)
    return _params(raster_to_camera, camera_to_world, device,
                   orthographic=False)


def generate_rays(cam: CameraParams, p_film):
    """p_film: [R,2] raster coords. Returns world (o, d)."""
    if cam.environment:
        theta = math.pi * p_film[..., 1] * cam.inv_res[1]
        phi = 2.0 * math.pi * p_film[..., 0] * cam.inv_res[0]
        st, ct = torch.sin(theta), torch.cos(theta)
        d_cam = torch.stack([st * torch.cos(phi), ct, st * torch.sin(phi)],
                            dim=-1)
        o = cm.transform_point(cam.camera_to_world, torch.zeros_like(d_cam))
        d = cm.normalize_fused(
            cm.transform_vector(cam.camera_to_world, d_cam))
        return o, d
    p_raster = torch.cat(
        [p_film, torch.zeros_like(p_film[..., :1])], dim=-1)
    p_cam = cm.transform_point(cam.raster_to_camera, p_raster)
    if cam.orthographic:
        o_cam = p_cam
        d_cam = torch.zeros_like(p_cam)
        d_cam[..., 2] = 1.0
    else:
        o_cam = torch.zeros_like(p_cam)
        d_cam = cm.normalize_fused(p_cam)
    o = cm.transform_point(cam.camera_to_world, o_cam)
    d = cm.normalize_fused(cm.transform_vector(cam.camera_to_world, d_cam))
    return o, d


def generate_rays_weighted(cam: CameraParams, p_film, u_lens):
    """(o, d, weight): realistic cameras trace the lens system with the
    given pupil sample (realistic.cpp:GenerateRay); other models return
    weight 1 (their We is folded into the projective mapping)."""
    if cam.lens is not None:
        from .realistic import generate_rays_realistic

        return generate_rays_realistic(cam.lens, cam.camera_to_world,
                                       float(cam.res[0]), float(cam.res[1]),
                                       p_film, u_lens)
    o, d = generate_rays(cam, p_film)
    return o, d, torch.ones(p_film.shape[:-1], device=p_film.device)


def make_realistic(camera_to_world: np.ndarray, lens_rows, xres: int,
                   yres: int, aperture_diameter_mm: float,
                   focus_distance: float, film_diag_mm: float,
                   device="cpu") -> CameraParams:
    """Camera "realistic" (src/cameras/realistic.cpp): lens prescription
    + thick-lens autofocus + exit-pupil tables (render/realistic.py)."""
    from .realistic import make_lens_system

    lens = make_lens_system(
        np.asarray(lens_rows, np.float64), aperture_diameter_mm,
        focus_distance, film_diag_mm * 1e-3, xres, yres, device=device)
    return CameraParams(
        raster_to_camera=torch.eye(4, device=device),
        camera_to_world=torch.as_tensor(
            np.asarray(camera_to_world, np.float32), device=device),
        dx_camera=torch.zeros(3, device=device),
        dy_camera=torch.zeros(3, device=device),
        orthographic=False,
        lens=lens,
        res=(float(xres), float(yres)),
    )
