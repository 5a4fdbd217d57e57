"""What the check reads of the timed path while it runs.

``Capture`` wraps four functions of the port for the length of one job
of the window, and leaves them as they were afterwards:

- ``render.integrator.intersect_scene`` and ``occluded_scene`` (every
  closest-hit and shadow query of the integrator, through B1 or B3 + B4
  and the dense spheres): of each call it keeps `rays_per_call` rays,
  drawn from the seed, with their origin, direction, t_max and the
  program's answer (t and kind, or blocked);
- ``stats.estimator.update_states`` (every traced sample's way into the
  moment streams): it keeps, for a fixed set of pixels drawn from the
  seed, each sample's radiance, albedo and normal and whether it counted,
  tagged with the iteration;
- ``render.integrator._bounce_step`` (one bounce of every lane): for a
  fixed set of lanes (one lane a pixel) drawn from the seed, each lane's
  state before and after every bounce of the job: origin, direction,
  throughput, radiance so far, eta scale, whether the last bounce was
  specular, whether the path is live, its bounce count and its step in
  the sample; after it, also the G-buffer's normal and albedo.

It keeps copies of a few lanes a call, and changes no argument and no
result.  Without a call to ``install`` nothing is wrapped.
"""
from __future__ import annotations

import torch


class Capture:
    def __init__(self, n_pixels: int, pixels, seed: int, device,
                 rays_per_call: int = 64, lanes=None):
        self.P = n_pixels
        self.pixels = pixels  # [K] long, on device
        self.lanes = lanes  # [L] long, on device, or None
        self.k = rays_per_call
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device = device
        self.iteration = 0
        self.hits = []  # [k, 9]: o, d, t_max, t, kind
        self.shadows = []  # [k, 8]: o, d, t_max, blocked
        self.samples = []  # (iteration, [K, 10]: L, albedo, normal, mask)
        self.steps = []  # (iteration, [L, 17] before, [L, 21] after)
        self._saved = None

    def _pick(self, R: int):
        return torch.randint(R, (min(self.k, R),), generator=self.gen,
                             device=self.device)

    @staticmethod
    def _tmax(t_max, o):
        if torch.is_tensor(t_max) and t_max.dim() == 1:
            return t_max
        return torch.full(o.shape[:1], float(t_max), device=o.device)

    def install(self):
        from statmc_tpu_torch.render import integrator as INT
        from statmc_tpu_torch.stats import estimator as E

        isect, occl, upd, bounce = (INT.intersect_scene,
                                    INT.occluded_scene, E.update_states,
                                    INT._bounce_step)
        self._saved = (INT, E, isect, occl, upd, bounce)

        def intersect_scene(scene, o, d, t_max, bvh, *a, **kw):
            hit = isect(scene, o, d, t_max, bvh, *a, **kw)
            if o.shape[0]:
                i = self._pick(o.shape[0])
                self.hits.append(torch.cat(
                    [o[i], d[i], self._tmax(t_max, o)[i, None],
                     hit.t[i, None].float(),
                     hit.prim_kind[i, None].float()], 1).float())
            return hit

        def occluded_scene(scene, o, d, t_max, bvh, *a, **kw):
            blocked = occl(scene, o, d, t_max, bvh, *a, **kw)
            if o.shape[0]:
                i = self._pick(o.shape[0])
                self.shadows.append(torch.cat(
                    [o[i], d[i], self._tmax(t_max, o)[i, None],
                     blocked[i, None].float()], 1).float())
            return blocked

        def update_states(states, cfg, out, mask=None):
            new = upd(states, cfg, out, mask)
            if out.ls.shape[0] != self.P:
                raise RuntimeError(
                    f"a sample batch of {out.ls.shape[0]} lanes, not one "
                    f"lane a pixel of the {self.P}: the check cannot "
                    "place its samples")
            px = self.pixels
            m = (torch.ones_like(px, dtype=torch.float32) if mask is None
                 else mask[px].float())
            self.samples.append((self.iteration, torch.cat(
                [out.ls[px, 0, :], out.albedo[px], out.normal[px],
                 m[:, None]], 1).float()))
            return new

        def bounce_step(scene, bvh, dist, cfg, carry, step, keys, *a, **kw):
            new = bounce(scene, bvh, dist, cfg, carry, step, keys, *a, **kw)
            if self.lanes is not None:
                ln = self.lanes
                stp = (step[ln] if torch.is_tensor(step)
                       else torch.full_like(ln, int(step)))
                before = torch.cat(
                    [carry["o"][ln], carry["d"][ln], carry["betas"][ln, 0],
                     carry["ls"][ln, 0], carry["eta_scale"][ln, None],
                     carry["specular"][ln, None].float(),
                     carry["active"][ln, None].float(),
                     carry["bounce"][ln, None].float(),
                     stp[:, None].float()], 1).float()
                after = torch.cat(
                    [new["o"][ln], new["d"][ln], new["betas"][ln, 0],
                     new["ls"][ln, 0], new["eta_scale"][ln, None],
                     new["specular"][ln, None].float(),
                     new["active"][ln, None].float(),
                     new["normal"][ln], new["albedo"][ln]], 1).float()
                self.steps.append((self.iteration, before, after))
            return new

        INT.intersect_scene = intersect_scene
        INT.occluded_scene = occluded_scene
        E.update_states = update_states
        INT._bounce_step = bounce_step

    def remove(self):
        if self._saved is None:
            return
        INT, E, isect, occl, upd, bounce = self._saved
        INT.intersect_scene, INT.occluded_scene = isect, occl
        E.update_states = upd
        INT._bounce_step = bounce
        self._saved = None

    def sample_tensor(self):
        """(samples [K,S,10] in the order traced, iteration [S])."""
        its = torch.tensor([i for i, _ in self.samples])
        return torch.stack([s for _, s in self.samples], 1), its

    def step_tensors(self):
        """(before [N,L,17], after [N,L,21], iteration [N]) of the N
        bounce steps in the order run."""
        its = torch.tensor([i for i, _, _ in self.steps])
        return (torch.stack([b for _, b, _ in self.steps]),
                torch.stack([a for _, _, a in self.steps]), its)
