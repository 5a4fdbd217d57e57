"""Driver of the non-statpath light-transport algorithms (port of
statmc_tpu/render/alt_integrators.py).

``AltRenderer`` gives them the surface of ``driver.Renderer`` -- the
iteration loop, ``render``, ``run_iteration`` (``render_s`` read after a
synchronize), ``total_spp``, ``buffers``, ``write_outputs`` and
``print_stats`` -- so the command line and the PFM outputs work
unchanged; a subclass supplies the transport in ``_render_iteration``.
The transports: ``ao`` (render/ao.py), ``sppm`` (render/sppm.py),
``bdpt`` (render/bdpt.py) and ``mlt`` (render/pssmlt.py); none is aliased
onto path tracing.
"""
from __future__ import annotations

import os
import re
import sys
import time

import torch


class AltRenderer:
    """Driver-compatible surface for the non-statpath integrators."""

    def __init__(self, desc, base_seed: int = 0, device="cuda",
                 strict_assets: bool | None = None):
        from ..driver import prepare

        self.s = prepare(desc, base_seed, device=device,
                         strict_assets=strict_assets)
        self.device = self.s.device
        self.base_seed = base_seed
        self.P = self.s.width * self.s.height
        self.reset()

    # -- subclass hooks ----------------------------------------------------
    def _reset_state(self):
        raise NotImplementedError

    def _render_iteration(self, i: int) -> float:
        """Advance the estimator by one iteration; returns rays traced."""
        raise NotImplementedError

    @property
    def film_mean(self):
        raise NotImplementedError

    # -- shared driver surface ----------------------------------------------
    def reset(self):
        self.ray_total = torch.zeros((), device=self.device)
        self._reset_state()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def total_spp(self, i: int) -> int:
        spp = self.s.ecfg.pixel_samples
        return spp << (i - 1) if self.s.ecfg.exp_iterations else i * spp

    def run_iteration(self, i: int) -> dict:
        self._sync()
        t0 = time.perf_counter()
        rays = self._render_iteration(i)
        self._sync()
        self.ray_total = self.ray_total + rays
        return {"iteration": i, "spp": self.total_spp(i),
                "render_s": time.perf_counter() - t0, "denoise_s": 0.0,
                "rays_total": float(self.ray_total)}

    def render(self, iterations: int | None = None,
               out_dir: str | None = None, verbose: bool = True,
               start_iteration: int = 1) -> list[dict]:
        n_it = iterations or self.s.ecfg.iterations
        logs = []
        for i in range(start_iteration, n_it + 1):
            log = self.run_iteration(i)
            if out_dir is not None:
                log["written"] = self.write_outputs(out_dir, i)
            logs.append(log)
            if verbose:
                print(f"Iteration: {log['iteration']}\n"
                      f"SPP: {log['spp']}\n"
                      f"Rendering time [ns]: {int(log['render_s'] * 1e9)}")
        return logs

    def buffers(self) -> dict:
        H, W = self.s.height, self.s.width
        return {"film": self.film_mean.cpu().numpy().reshape(H, W, 3)}

    def write_outputs(self, out_dir: str, iteration: int) -> list[str]:
        from ..io.pfm import write_pfm

        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(self.s.filename))[0]
        spp = self.total_spp(iteration)
        rx = re.compile(self.s.ecfg.output_regex)
        written = []
        for name, arr in self.buffers().items():
            if rx.fullmatch(name):
                path = os.path.join(out_dir, f"{stem}-{spp}-{name}.pfm")
                write_pfm(path, arr)
                written.append(path)
        return written

    def print_stats(self, file=None):
        f = file or sys.stdout
        print("Statistics:", file=f)
        print("  Integrator", file=f)
        print(f"    Rays traced {int(float(self.ray_total))}", file=f)


def make_alt_renderer(name: str, desc, base_seed: int = 0, device="cuda",
                      strict_assets: bool | None = None) -> AltRenderer:
    if name == "ao":
        from .ao import AORenderer

        return AORenderer(desc, base_seed, device, strict_assets)
    if name == "sppm":
        from .sppm import SPPMRenderer

        return SPPMRenderer(desc, base_seed, device, strict_assets)
    if name == "bdpt":
        from .bdpt import BDPTRenderer

        return BDPTRenderer(desc, base_seed, device, strict_assets)
    if name == "mlt":
        from .pssmlt import MLTRenderer

        return MLTRenderer(desc, base_seed, device, strict_assets)
    raise ValueError(f"unknown alternative integrator {name!r}")
