"""Rendering on a ("spp", "px") mesh of ranks (port of
statmc_tpu/parallel/shard.py to torch.distributed).

The JAX package runs one program over a device mesh under shard_map; the
port runs one process a rank (SPMD).  Rank k sits at (spp, px) =
divmod(k, n_px), as np.array(devices).reshape(n_spp, n_px) orders JAX's
mesh.  Each rank holds its "px" slab of the film, the moment states and
the ACRR/SMIS feedback, and the scene tables whole; samples stride over
"spp".  Per chunk each rank streams its samples into fresh local states
(serial Meng updates; M3 set to its exact 0 after the first sample, see
make_sharded_chunk_fn; with one spp rank, into the running states), then
the "spp" members' states merge with Chan's pairwise combine
(stats/moments.combine_across) and join the running states through one
more combine; film sums add over "spp", the ray total
and the STAT counters over both axes (path_len_max takes the maximum).
The denoise filters row slabs with a halo exchange (make_sharded_filter;
driver.Renderer._denoise).  Every draw is addressed by (pixel, sample)
(core/rng.py), so a mesh render equals the one-device render up to the
order of the moment merge (Chan against serial Meng), which the tests
hold.

Collectives (parallel/comm.py): NCCL on CUDA devices, one card a rank;
gloo on the CPU and when several ranks share a card (the counterpart of
the JAX tests' virtual CPU mesh).  parallel/launch.py starts the ranks.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import time
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

from .. import spans
from ..stats import moments
from . import comm

# How long a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


@dataclass(eq=False)
class Mesh:
    """This rank's place in the ("spp", "px") mesh."""
    shape: dict  # {"spp": n_spp, "px": n_px}
    rank: int  # global rank = spp_index * n_px + px_index
    spp_index: int
    px_index: int
    device: torch.device
    backend: str  # of the groups: "nccl" or "gloo"
    spp_group: Any  # the ranks of this px column, spp = 0..n_spp-1
    px_group: Any  # the ranks of this spp row, px = 0..n_px-1
    prev: int | None  # global rank of the px neighbour above (None at 0)
    next: int | None  # and below
    comm_s: dict = field(default_factory=dict)  # seconds by collective
    comm_bytes: dict = field(default_factory=dict)  # bytes by collective

    @property
    def spp_ranks(self) -> list:
        """Global ranks of this rank's "spp" group (its px column)."""
        n_spp, n_px = self.shape["spp"], self.shape["px"]
        return [s * n_px + self.px_index for s in range(n_spp)]

    @property
    def px_ranks(self) -> list:
        """Global ranks of this rank's "px" group (its spp row)."""
        n_px = self.shape["px"]
        return [self.spp_index * n_px + p for p in range(n_px)]

    @contextlib.contextmanager
    def timed(self, name: str, ranks):
        """Adds the host seconds of the block and the device synchronize
        after it to comm_s[name], and the bytes that this rank handed to
        its collectives (the counter mesh.bytes of comm.py) to
        comm_bytes[name] and to the counter mesh.bytes.<name>; both run
        in the span mesh.<name>.  The synchronize before the block runs
        in the span mesh.arrive.<name>, whose attribute `ranks` holds the
        global ranks that take part in the block with this one: the span
        ends when this rank arrives at the collective, and the latest end
        among those ranks' spans less its own is its wait for slower
        peers, inside mesh.<name> (read from every rank's spans
        afterwards, so measuring the wait adds no collective)."""
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda *a: None))
        with spans.span("mesh.arrive." + name, ranks=tuple(ranks)):
            sync(self.device)
        t0 = time.perf_counter()
        b0 = spans.counted("mesh.bytes")
        with spans.span("mesh." + name):
            try:
                yield
            finally:
                sync(self.device)
                self.comm_s[name] = (self.comm_s.get(name, 0.0)
                                     + time.perf_counter() - t0)
                nbytes = spans.counted("mesh.bytes") - b0
                self.comm_bytes[name] = (self.comm_bytes.get(name, 0)
                                         + nbytes)
                spans.count("mesh.bytes." + name, nbytes)

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def as_device(d) -> torch.device:
    """torch.device(d), with "cuda" read as cuda:0."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


def backend_for(devices) -> str:
    """gloo for the CPU or for ranks that share a card, else NCCL."""
    devices = [as_device(d) for d in devices]
    if any(d.type != "cuda" for d in devices) or len(set(devices)) < len(
            devices):
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError("statmc_tpu_torch: the mesh needs NCCL on CUDA "
                           "devices, and this torch has none")
    return "nccl"


def make_mesh(n_spp: int, n_px: int, devices=None) -> Mesh:
    """This rank's Mesh in the initialised world of n_spp * n_px ranks
    (distributed_init).  devices: one per rank, in rank order; by default
    cuda:LOCAL_RANK, one card a rank.  A list that names one device for
    several ranks (or the CPU) makes gloo groups: NCCL refuses two ranks
    on one card.  Every rank creates every group, in the same order."""
    n = n_spp * n_px
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed world "
                           "(parallel.shard.distributed_init)")
    if dist.get_world_size() != n:
        raise ValueError(f"a {n_spp}x{n_px} mesh needs {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    rank = dist.get_rank()
    if devices is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise ValueError(f"not enough devices: local rank {local}, "
                             f"{torch.cuda.device_count()} CUDA devices")
        device = torch.device("cuda", local)
        backend = backend_for([device])
    else:
        devices = [as_device(d) for d in devices]
        if len(devices) < n:
            raise ValueError(f"not enough devices: {len(devices)} for "
                             f"{n} ranks")
        devices = devices[:n]
        cards = torch.cuda.device_count()
        if any(d.type == "cuda" and d.index >= cards
               for d in devices):
            raise ValueError(f"not enough devices: {devices} named, "
                             f"{cards} CUDA devices")
        device = devices[rank]
        backend = backend_for(devices)
    spp_groups = [dist.new_group([s * n_px + p for s in range(n_spp)],
                                 backend=backend) for p in range(n_px)]
    px_groups = [dist.new_group([s * n_px + p for p in range(n_px)],
                                backend=backend) for s in range(n_spp)]
    s, p = divmod(rank, n_px)
    return Mesh(shape={"spp": n_spp, "px": n_px}, rank=rank, spp_index=s,
                px_index=p, device=device, backend=backend,
                spp_group=spp_groups[p], px_group=px_groups[s],
                prev=rank - 1 if p > 0 else None,
                next=rank + 1 if p < n_px - 1 else None)


def pad_pixels(P_total: int, n_px: int) -> int:
    return ((P_total + n_px - 1) // n_px) * n_px


def distributed_init(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str = "nccl", timeout=DEFAULT_TIMEOUT) -> None:
    """Join a torch.distributed world (statmc_tpu/parallel/shard.py:266
    distributed_init).  Without arguments it reads torchrun's WORLD_SIZE
    and RANK, and MASTER_ADDR and MASTER_PORT through ``env://``; a single
    process with no init_method is a no-op.  backend: "nccl" for CUDA
    devices (a torch without NCCL raises; nothing falls back quietly) or
    "gloo" for the CPU and ranks that share a card."""
    world_size = (world_size if world_size is not None
                  else int(os.environ.get("WORLD_SIZE", "1")))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if init_method is None:
        if world_size == 1:
            return
        if "MASTER_ADDR" not in os.environ:
            raise RuntimeError("distributed_init: WORLD_SIZE > 1 but no "
                               "MASTER_ADDR (run under torchrun)")
        init_method = "env://"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("statmc_tpu_torch: backend 'nccl' was asked for "
                           "and this torch has no NCCL")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def replicate_scene(desc, mesh: Mesh, base_seed: int = 0,
                    strict_assets: bool | None = None):
    """The scene on every rank (statmc_tpu/parallel/shard.py:252): each
    rank runs the host build of the same scene description and moves the
    tables to its own device."""
    from ..driver import prepare

    return prepare(desc, base_seed, device=mesh.device,
                   strict_assets=strict_assets)


def make_sharded_chunk_fn(setup, mesh: Mesh):
    """The mesh's render chunk (statmc_tpu/parallel/shard.py:55).  Call
    it on every rank with that rank's slab: states [NB,Pl,C], film_sum
    [Pl,3], film_w [Pl], pixel_ids [Pl] (pad lanes aliased to a real
    pixel), lane_valid [Pl] bool, avg_ls, win_b, win_l [Pl,.].  Updates
    states, film_sum and film_w in place; returns (ray_total, this
    chunk's STAT counter increment, summed over the mesh)."""
    from ..driver import PIXEL_BLOCK, lanes, make_sample_fn, zero_stats

    sample_step = make_sample_fn(setup)
    n_spp, k = mesh.shape["spp"], mesh.spp_index
    dev = setup.device

    def chunk(states, film_sum, film_w, ray_total, base_key,
              sample_start: int, pixel_ids, lane_valid, avg_ls, win_b,
              win_l, feedback_on: bool, n_samples: int):
        # Rank k takes samples sample_start + s n_spp + k: a remainder
        # gives the low spp indices one sample more.
        n_local = (n_samples - k + n_spp - 1) // n_spp
        # With one spp rank there is nothing to merge: the samples stream
        # into the running states, as on one device.
        fresh = n_spp > 1
        local = ({t: {f: torch.zeros_like(v) for f, v in st.items()}
                  for t, st in states.items()} if fresh else states)
        local_film = torch.zeros_like(film_sum)
        local_w = torch.zeros_like(film_w)
        local_rays = torch.zeros((), device=dev)
        local_stats = zero_stats(dev)
        Pl = pixel_ids.shape[0]
        for s in range(n_local):
            for start in range(0, Pl, PIXEL_BLOCK):
                end = min(start + PIXEL_BLOCK, Pl)
                local_rays = sample_step(
                    lanes(local, start, end), local_film[start:end],
                    local_w[start:end], local_rays, local_stats, base_key,
                    sample_start + s * n_spp + k, pixel_ids[start:end],
                    avg_ls[start:end], win_b[start:end], win_l[start:end],
                    feedback_on, valid=lane_valid[start:end])
            if fresh and s == 0:
                # One sample's third central moment is 0.  The streamed
                # update leaves the sample times the rounding residual of
                # its square there (moments._meng_update's fma), ~|y|^3
                # 2^-24, which fresh states would carry into the merge
                # once a rank and chunk: on bright pixels of small spread,
                # up to 4% of M3's scale.
                for st in local.values():
                    if "m3" in st:
                        st["m3"].zero_()
        if fresh:
            with mesh.timed("spp_merge", mesh.spp_ranks):
                for t, st in states.items():
                    merged = moments.combine_across(local[t], mesh.spp_group)
                    for f, v in moments.combine(st, merged).items():
                        st[f].copy_(v)
        with mesh.timed("film_sums", mesh.spp_ranks):
            sums = comm.all_reduce(torch.cat([local_film.reshape(-1),
                                              local_w]), "sum",
                                   mesh.spp_group)
            film_sum += sums[:local_film.numel()].reshape(film_sum.shape)
            film_w += sums[local_film.numel():]
        with mesh.timed("counters", range(n_spp * mesh.shape["px"])):
            keys = [k for k in local_stats if k != "path_len_max"]
            v = torch.stack([local_rays] + [local_stats[k] for k in keys])
            v = comm.all_reduce(v, "sum")
            mx = comm.all_reduce(local_stats["path_len_max"], "max")
        delta = dict(zip(keys, v[1:]))
        delta["path_len_max"] = mx
        return ray_total + v[0], delta

    return chunk


def make_sharded_filter(mesh: Mesh, height: int, radius: int, ds_factor,
                        gb_factors, alpha: float = 0.005):
    """The row-sharded statistical filter with a halo exchange
    (statmc_tpu/parallel/shard.py:169), on the functions the mesh's
    denoise runs (denoise/filter.py halo_extend, stat_filter_slab).  The
    returned function takes this rank's row slab of the image, height /
    n_px rows: n [hl,W], mean, m2, m3, film_mean [hl,W,C], gb_planes
    [hl,W,G] (one factor a plane in gb_factors), film [hl,W,3]; it fetches
    `radius` rows from each "px" neighbour (zeros and valid = 0 past the
    image's edges), filters the extended slab and returns its centre rows
    of (mean_corr, discriminator, film_mean_f, film_f)."""
    from ..denoise.filter import halo_extend, stat_filter_slab
    from ..denoise.ttest import quantile_table

    n_px = mesh.shape["px"]
    if height % n_px:
        raise ValueError("height must divide the px axis")
    if height // n_px < radius:
        raise ValueError("local slab shorter than the filter radius")
    tq = torch.as_tensor(quantile_table(alpha), device=mesh.device)

    def exchange(x):
        return comm.halo_rows(x, radius, mesh.px_group, mesh.prev, mesh.next)

    def local_filter(n_img, mean, m2, m3, fm, gb_planes, film):
        valid, gb_e = halo_extend(exchange, gb_planes)
        res = stat_filter_slab(exchange, valid, n_img, mean, m2, m3, fm,
                               gb_e, gb_factors, ds_factor, tq, radius,
                               film_img=film)
        return tuple(res[k] for k in (
            "mean_corr", "discriminator", "film_mean_f", "film_f"))

    return local_filter
