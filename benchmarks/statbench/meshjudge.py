"""The check of the loop ``mesh_render``: the ranks' shares of one
captured job (mesh_rank.py) laid out as one device's capture, then
``judge.render_check`` unchanged.

Under a mesh the program traces its samples with the per-sample driver
(``driver.make_sample_fn`` inside ``parallel/shard.py``'s chunk): every
sample of a lane runs all ``n_steps`` bounce steps, and the moment
streams record it once, after the last.  Rank k of an "spp" column
traces samples start + c * n_spp + k of each iteration (c = 0, 1, ...;
the mesh's documented sample stride, restated here, not imported), so
sample c of that rank in iteration i is the job's sample
``starts[i] + c * n_spp + k``.  ``merge`` puts every rank's samples and
bounces in that place, so that judge.py reads one job in the order of
its samples, as it reads a device's:

- the bounces of each sample, ``n_steps`` rows, in the job's sample
  order, the lanes of both px slabs side by side;
- each recorded sample at the row of its lane's last bounce (the first
  after which the path is not live, or the last step), as the
  path-regeneration driver records it, and at the sample's last row for
  the pixels that are not lanes: the moments read only the recorded
  samples, and the record check holds the recorded radiance to the
  radiance the lane held after that bounce;
- the moment states and the last film at the drawn pixels, and film-f at
  the filter centres, from the spp index 0 rank of each slab (both ranks
  of a px column hold the same merged states), in whole-image tensors
  that are NaN elsewhere.

The two-pass float64 moments of the reference do not depend on the order
of the samples, so the program's merge (Chan's combine over "spp", then
into the running states) is held to the one-device limits.
"""
from __future__ import annotations

import torch

from . import judge


class MergedCapture:
    """A Capture's reading surface (capture.py) for the whole job."""

    def __init__(self, pixels, lanes, hits, shadows, samples, steps, its):
        self.pixels, self.lanes = pixels, lanes
        self.hits, self.shadows = hits, shadows
        self._samples, self._steps, self._its = samples, steps, its

    def sample_tensor(self):
        return self._samples, self._its

    def step_tensors(self):
        return (*self._steps, self._its)


def starts_of(spp: int, expo: bool, n_iter: int) -> dict:
    """Each iteration's first sample in the job (as judge.render_check
    counts them)."""
    return {i: (0 if i == 1 else (spp << (i - 2)) if expo else (i - 1) * spp)
            for i in range(1, n_iter + 1)}


def merge(shares, pixels, lanes, centres, starts, n_spp, P, device):
    """The kept job of judge.render_check from every rank's share:
    pixels, lanes and centres are the drawn global ids (mesh_rank.draws);
    starts each iteration's first sample; P the image's pixels."""
    spp = shares[0]["spp"]
    K, L = pixels.shape[0], lanes.shape[0]
    slot_it = torch.zeros(spp, dtype=torch.long)
    for i, s0 in starts.items():
        slot_it[s0:] = i
    n_steps = None
    slots = []
    for sh in shares:
        its = sh["sample_its"]
        count = {}
        slot = []
        for i in its.tolist():
            c = count.get(i, 0)
            count[i] = c + 1
            slot.append(starts[i] + c * n_spp + sh["spp_index"])
        slot = torch.tensor(slot, dtype=torch.long)
        if bool((slot >= spp).any()) or bool((slot_it[slot] != its).any()):
            raise RuntimeError(
                f"mesh check: rank {sh['rank']} traced samples beyond the "
                "job's (its sample stride is not the mesh's)")
        steps = sh["before"].shape[0]
        if steps % its.numel():
            raise RuntimeError(f"mesh check: rank {sh['rank']}: {steps} "
                               f"bounce steps for {its.numel()} samples")
        if n_steps is None:
            n_steps = steps // its.numel()
        if steps != n_steps * its.numel():
            raise RuntimeError("mesh check: the ranks ran different "
                               "numbers of bounce steps a sample")
        slots.append(slot)
    for p in {sh["px_index"] for sh in shares}:
        mine = [sl for sh, sl in zip(shares, slots) if sh["px_index"] == p]
        if sorted(torch.cat(mine).tolist()) != list(range(spp)):
            raise RuntimeError(f"mesh check: the samples of px slab {p} do "
                               "not cover the job's once")

    N = spp * n_steps
    d_b, d_a = shares[0]["before"].shape[-1], shares[0]["after"].shape[-1]
    before = torch.zeros((N, L, d_b))
    after = torch.zeros((N, L, d_a))
    step = torch.arange(n_steps)
    for sh, slot in zip(shares, slots):
        rows = (slot[:, None] * n_steps + step).reshape(-1)
        lp = sh["lane_pos"]
        before[rows[:, None], lp[None, :]] = sh["before"]
        after[rows[:, None], lp[None, :]] = sh["after"]
    # Each lane's last bounce in each sample: the number of steps after
    # which the path is live (column 14 of `after`), at most the last.
    t_end = torch.full((K, spp), n_steps - 1, dtype=torch.long)
    live = (after[..., 14] > 0.5).reshape(spp, n_steps, L).sum(1)
    t_end[K - L:] = torch.clamp(live, max=n_steps - 1).T
    samples = torch.zeros((K, N, shares[0]["samples"].shape[-1]))
    for sh, slot in zip(shares, slots):
        pos = sh["pos"]
        cols = slot[None, :] * n_steps + t_end[pos[:, None], slot[None, :]]
        samples[pos[:, None], cols] = sh["samples"]
    its = slot_it.repeat_interleave(n_steps)

    def dev(x):
        return x.to(device)

    cap = MergedCapture(
        dev(pixels), dev(lanes),
        [dev(x) for sh in shares for x in sh["hits"]],
        [dev(x) for sh in shares for x in sh["shadows"]],
        dev(samples), (dev(before), dev(after)), its)
    states = {}
    film = torch.full((P, 3), float("nan"), device=device)
    film_f = torch.full((P, 3), float("nan"), device=device)
    leads = [sh for sh in shares if sh["spp_index"] == 0]
    for sh in leads:
        ids = dev(pixels[sh["pos"]])
        for t, st in sh["states"].items():
            full = states.setdefault(t, {})
            for k, v in st.items():
                if k not in full:
                    full[k] = torch.full((v.shape[0], P, *v.shape[2:]),
                                         float("nan"), device=device)
                full[k][:, ids] = dev(v)
        film[ids] = dev(sh["film"])
        if sh["film_f"] is not None:
            film_f[dev(centres[sh["centre_pos"]])] = dev(sh["film_f"])
    denoised = all(sh["film_f"] is not None for sh in leads)
    return {"cap": cap, "states": states, "film": film,
            "film_f": film_f if denoised else None, "spp": spp,
            "base_seed": shares[0]["base_seed"], "centres": dev(centres)}


def render_check(shares, draws, text, geo, cfg, limits, n_spp, device,
                 control: bool = False, notes=None):
    """judge.render_check of the merged job, on `device`; draws: (pixels,
    lanes, centres) of mesh_rank.draws."""
    from . import cells

    W = int(cells.setting(cfg, "xresolution")[0])
    H = int(cells.setting(cfg, "yresolution")[0])
    starts = starts_of(int(cells.setting(cfg, "pixelsamples")[0]),
                       cells.setting(cfg, "expiterations")[0] == "true",
                       int(cells.setting(cfg, "iterations")[0]))
    kept = merge(shares, *draws, starts, n_spp, W * H, device)
    kept["text"] = text
    return judge.render_check(kept, geo, cfg, limits, control, notes)
