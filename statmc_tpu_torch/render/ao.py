"""Ambient-occlusion integrator (port of statmc_tpu/render/ao.py).

pbrt's AOIntegrator (src/integrators/ao.cpp:57-102): at the first hit,
average visibility over ``nsamples`` hemisphere directions around the
face-forwarded GEOMETRIC normal (ao.cpp:77), cosine-weighted by default
(``"bool cossample"``), uniform otherwise; a null-material first hit
re-spawns once through the surface (ao.cpp:67-71).  One lane per pixel;
each probe is one occlusion call on the lanes whose camera ray found a
surface (the JAX package masks the others with t_max = 0, which gives
the same visibility).
"""
from __future__ import annotations

import math

import torch

from ..core import math as cm
from ..core import rng as crng
from ..scene import build as sb
from . import bsdf as B
from . import camera as CAM
from .alt_integrators import AltRenderer
from .integrator import _offset_origin
from .intersect import intersect_scene, occluded_scene


class AORenderer(AltRenderer):
    """integrator "ao": each driver iteration adds `pixelsamples` camera
    samples (doubling under expiterations), each probing `nsamples`
    occlusion directions."""

    def __init__(self, desc, base_seed: int = 0, device="cuda",
                 strict_assets: bool | None = None):
        ip = desc.integrator_params
        self.cos_sample = bool(ip.find_one("cossample", True)) if ip \
            else True
        self.n_samples_ao = int(ip.find_one("nsamples", 64)) if ip else 64
        super().__init__(desc, base_seed, device, strict_assets)

    def _reset_state(self):
        self.film_sum = torch.zeros((self.P, 3), device=self.device)
        self.n_cam = 0

    @property
    def film_mean(self):
        return self.film_sum / max(self.n_cam, 1)

    def one_sample(self, key, sample_index: int):
        """[P] visibility of one camera sample per pixel."""
        s, P, dev = self.s, self.P, self.device
        scene, bvh = s.scene, s.bvh
        ids = torch.arange(P, dtype=torch.int32, device=dev)
        keys = crng.pixel_keys(key, ids, sample_index)
        pxy = torch.stack([(ids % s.width).to(torch.float32),
                           (ids // s.width).to(torch.float32)], -1)
        u_cam = crng.uniform_2d(keys, 0, crng.SLOT_CAMERA)
        o, d = CAM.generate_rays(s.cam, pxy + u_cam)

        # First hit; one null-material pass-through (ao.cpp:67).
        hit = intersect_scene(scene, o, d, torch.full((P,), cm.INF,
                                                      device=dev), bvh)
        m = B.gather_materials(scene, hit.mat_id, hit.uv, hit.p)
        p, ng, found = hit.p, hit.ng, hit.found
        null = torch.nonzero(found & (m.mat_type == sb.MAT_NONE))[:, 0]
        if null.numel():
            dn = d[null]
            hit2 = intersect_scene(
                scene, _offset_origin(hit.p[null], -hit.ng[null], dn), dn,
                torch.full((null.numel(),), cm.INF, device=dev), bvh)
            use2 = hit2.found[:, None]
            p, ng, found = p.clone(), ng.clone(), found.clone()
            p[null] = torch.where(use2, hit2.p, p[null])
            ng[null] = torch.where(use2, hit2.ng, ng[null])
            found[null] = hit2.found

        # Frame on the face-forwarded geometric normal (ao.cpp:77), on
        # the lanes that found a surface.
        f = torch.nonzero(found)[:, 0]
        keys_f, d_f, p_f, ng_f = keys[f], d[f], p[f], ng[f]
        n = torch.where(cm.dot(ng_f, -d_f)[:, None] < 0, -ng_f, ng_f)
        frame = B.ShadingFrame.from_normal(torch.where(
            torch.any(n != 0, -1, keepdim=True), n,
            torch.tensor([0.0, 0.0, 1.0], device=dev)))
        acc = torch.zeros((f.numel(),), device=dev)
        t_max = torch.full((f.numel(),), cm.INF, device=dev)
        for k in range(self.n_samples_ao):
            acc = acc + self._probe(keys_f, k, frame, p_f, n, t_max)
        vis = torch.zeros((P,), device=dev)
        vis[f] = acc
        return vis / self.n_samples_ao

    def _probe(self, keys, k: int, frame, p, n, t_max):
        """Probe k of the lanes' hemispheres: its weight where the probe
        escapes, 0 where it is occluded."""
        u = crng.uniform_2d(keys, k, crng.SLOT_BSDF)
        if self.cos_sample:
            wi_l = B.cosine_sample_hemisphere(u)
            # dot(wi, n) / pdf = pi; 1/nsamples folds in later
            # (ao.cpp:97 L += dot / (pdf * n)).
            wgt = torch.full_like(t_max, math.pi)
        else:
            z = u[:, 0]
            r_ = cm.sqrt(torch.clamp(1.0 - z * z, min=0.0))
            phi = 2.0 * math.pi * u[:, 1]
            wi_l = torch.stack([r_ * torch.cos(phi), r_ * torch.sin(phi), z],
                               -1)
            wgt = z * (2.0 * math.pi)  # dot / (1 / 2pi)
        wi = frame.to_world(wi_l)
        occ = occluded_scene(self.s.scene, _offset_origin(p, n, wi), wi, t_max,
                             self.s.bvh)
        return torch.where(occ, 0.0, wgt)

    def _render_iteration(self, i: int) -> float:
        s = self.s
        n = (s.ecfg.pixel_samples if not s.ecfg.exp_iterations or i == 1
             else s.ecfg.pixel_samples << (i - 2))
        key = crng.fold_in(crng.base_key(s.base_seed, device=self.device), i)
        film = torch.zeros((self.P, 3), device=self.device)
        for j in range(n):
            film = film + self.one_sample(key, i * n + j)[:, None]
        self.film_sum = self.film_sum + film
        self.n_cam += n
        return float(n * self.P * (1 + self.n_samples_ao))
