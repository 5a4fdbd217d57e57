"""Primary-sample-space Metropolis light transport over many parallel
chains (port of statmc_tpu/render/pssmlt.py).

pbrt's MLTIntegrator (src/integrators/mlt.cpp), as the JAX package
re-derives it: Kelemen-style Metropolis over the primary sample space U
in [0, 1]^D, large steps (a fresh uniform U) and small steps (a wrapped
Gaussian perturbation), the two-sample splat of the current and the
proposed state, and the bootstrap normalisation b = E[y].

* The contribution f(U) is bidirectional by default: render/bdpt.py's
  make_contribution, the full t >= 2 BDPT strategy sum of the path U
  names.  `"bool bidirectional" ["false"]` mutates the unidirectional
  path tracer (render/integrator.py:trace) under the lockstep draw-table
  mode, U being the table.
* N_CHAINS independent chains advance in lockstep, each mutation one
  evaluation of f over all chains; the JAX package's lax.scan over the
  steps is a Python loop.
* The random numbers are the JAX package's jax.random draws (split,
  uniform, normal, categorical), bit for bit (core/rng.py).
* The splats, many chains into one pixel, are summed by
  bdpt.serial_scatter_add in chain order, as the JAX package's serial
  scatter sums them: no atomics, so the card repeats itself bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import lockstep as LS
from ..core import math as cm
from ..core import rng as crng
from ..core import spectrum as spec
from .alt_integrators import AltRenderer
from .bdpt import camera_rays, serial_scatter_add
from .integrator import trace

N_CHAINS = 8192
SIGMA = 0.01  # pbrt's MLTSampler default
P_LARGE = 0.3  # pbrt's "largestepprobability" default
N_BOOTSTRAP = 65536
# Set to a list to record, per mutation step, the chains' large steps,
# accepts and proposals with y > 0.
step_stats = None


class MLTRenderer(AltRenderer):
    """integrator "mlt": iteration i brings the mutations up to total_spp(i)
    a pixel on average."""

    def __init__(self, desc, base_seed: int = 0, device="cuda",
                 strict_assets: bool | None = None):
        ip = desc.integrator_params
        self.bidirectional = bool(ip.find_one("bidirectional", True)) \
            if ip else True
        self._desc = desc
        self._strict_assets = strict_assets
        super().__init__(desc, base_seed, device, strict_assets)

    def _reset_state(self):
        s, dev = self.s, self.device
        self.cfg = s.icfg._replace(sampler_mode=crng.MODE_LOCKSTEP)
        if self.bidirectional:
            from .bdpt import BDPTRenderer

            self._bdpt = BDPTRenderer(self._desc, self.base_seed, dev,
                                      self._strict_assets)
            self._f_bdpt, self.D = self._bdpt.make_contribution(N_CHAINS)
        else:
            self._bdpt = None
            n_steps = s.icfg.max_depth + 1 + s.icfg.null_extra
            self.D = LS.dims_per_sample(n_steps)
        self.splat = torch.zeros((self.P, 3), device=dev)
        self.n_mut = 0
        self.key = crng.base_key(self.base_seed, device=dev)
        self._chains = None
        self.b = None

    # -- f(U): luminance, rgb and pixel of the path U names ----------------
    def _f(self, U):
        if self._bdpt is not None:
            return self._f_bdpt(U)
        s = self.s
        C = U.shape[0]
        dev = U.device
        px = torch.clamp(U[:, 0] * s.width, 0.0, s.width - 1e-3)
        py = torch.clamp(U[:, 1] * s.height, 0.0, s.height - 1e-3)
        o, d = camera_rays(s.cam, torch.stack([px, py], -1))
        NL = max(s.icfg.n_ls, 1)
        NB = max(s.icfg.nb_mis, 1)
        out = trace(s.scene, s.bvh, s.dist, self.cfg, o, d,
                    torch.zeros((C, 2), dtype=torch.int64, device=dev),
                    torch.ones((C, NL), device=dev),
                    torch.zeros((C, NB), device=dev),
                    torch.zeros((C, NB), device=dev), False,
                    ld_stream=(U[:, None, :], 0))
        L = out.ls[:, 0, :]
        pix = py.to(torch.int32) * s.width + px.to(torch.int32)
        return spec.luminance(L), L, pix

    def _bootstrap(self):
        """b = E[y] over uniform U; the chains seeded by resampling the
        bootstrap population in proportion to y (mlt.cpp's bootstrap)."""
        k1, k2, self.key = crng.split(self.key, 3)
        rows, ys = [], []
        per = N_CHAINS  # evaluated in chain-sized batches
        for i in range(N_BOOTSTRAP // per):
            U = crng.uniform(crng.fold_in(k1, i), (per, self.D))
            rows.append(U)
            ys.append(self._f(U)[0])
        U_all = torch.cat(rows)
        y_all = torch.cat(ys)
        self.b = float(torch.mean(y_all))
        if self.b <= 0:
            self.b = 1e-9  # a black scene; the chains splat nothing anyway
        idx = crng.categorical(
            k2, crng.xla_log(torch.clamp(y_all, min=1e-20)), N_CHAINS)
        U0 = U_all[idx]
        self._chains = (U0, *self._f(U0))

    def step(self, chains, key):
        """One mutation of every chain under `key`: the new chains; adds
        the two-sample splat to self.splat."""
        U, y, L, pix = chains
        C = U.shape[0]
        k1, k2, k3, k4 = crng.split(key, 4)
        large = crng.uniform(k1, (C,)) < P_LARGE
        # Small step: a wrapped Gaussian of fixed sigma per dim (mlt.cpp's
        # EnsureReady mutation, simplified), U + normal(k2) SIGMA as the JAX
        # package's compiled step rounds it (XLA folds sqrt(2) SIGMA into
        # one constant and fuses the product into the sum); large step:
        # fresh uniforms.
        u = crng.uniform_range(k2, tuple(U.shape), crng.NORMAL_LO, 1.0)
        scale = np.float32(np.sqrt(2.0)) * np.float32(SIGMA)
        U_small = torch.remainder(cm.fma(crng.erf_inv(u), torch.tensor(
            scale, device=U.device), U), 1.0)
        U_large = crng.uniform(k3, tuple(U.shape))
        U_new = torch.where(large[:, None], U_large, U_small)
        y_new, L_new, pix_new = self._f(U_new)

        a = torch.clamp(y_new / torch.clamp(y, min=1e-20), max=1.0)
        a = torch.where(y <= 0, 1.0, a)
        # The two-sample splat (mlt.cpp's main loop): both states add their
        # unit-luminance colour weighted by the acceptance probability.
        new_on = y_new > 0
        cur_on = y > 0
        lanes = torch.nonzero(new_on)[:, 0]
        serial_scatter_add(
            self.splat, pix_new[lanes].long(),
            ((a / torch.clamp(y_new, min=1e-20))[:, None] * L_new)[lanes])
        lanes = torch.nonzero(cur_on)[:, 0]
        serial_scatter_add(
            self.splat, pix[lanes].long(),
            (((1.0 - a) / torch.clamp(y, min=1e-20))[:, None] * L)[lanes])

        acc = crng.uniform(k4, (C,)) < a
        if step_stats is not None:
            step_stats.append({"large": int(large.sum()),
                               "accepted": int(acc.sum()),
                               "proposed_nonzero": int(new_on.sum())})
        return (torch.where(acc[:, None], U_new, U),
                torch.where(acc, y_new, y),
                torch.where(acc[:, None], L_new, L),
                torch.where(acc, pix_new, pix))

    def _render_iteration(self, i: int) -> float:
        if self.b is None:
            self._bootstrap()
        spp_prev = self.total_spp(i - 1) if i > 1 else 0
        target = self.total_spp(i) * self.P
        n_steps = max(1, -(-(target - spp_prev * self.P) // N_CHAINS))
        self.key, k = crng.split(self.key, 2)
        for kk in crng.split(k, n_steps):
            self._chains = self.step(self._chains, kk)
        self.n_mut += n_steps * N_CHAINS
        return float(n_steps * N_CHAINS)

    @property
    def film_mean(self):
        # b splat / (mutations a pixel) (mlt.cpp's Render tail).
        scale = self.b * self.s.width * self.s.height / max(self.n_mut, 1)
        return self.splat * scale
