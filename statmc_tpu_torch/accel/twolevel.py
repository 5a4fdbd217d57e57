"""Two-level worklist traversal for large scenes (port of
statmc_tpu/accel/twolevel.py), with kernels B3 (cull) and B4 (walk).

Scenes above FUSED_MAX_TRIS triangles are packed Morton-ordered into
ST = 128-triangle subtiles.  Each subtile's five forms (three Plucker
edge products, the plane numerator and denominator) of all 128
triangles are one [16, 5*ST] table block whose rows pair with the ray
features [d, o x d, o, 1, 0...] (``ray_features16``).  Bounds are kept
per fine STF = 32-triangle subgroup (fsub = 4 subgroups per subtile up
to FINE_MAX_TRIS, else one).  One intersect call:

1. partitions the rays (``_morton_partition`` / ``_octant_partition``,
   dead lanes last) so that RT_WALK = 512-ray blocks are coherent;
2. B3, ``cull``: per block, a 0/1 vote per fine subgroup AABB -- does
   any ray of the block enter it within (0, t_max]?
3. glue: the votes OR into per-subtile votes, compact into an ascending
   worklist per block (``_compact``; a block of more than MAXS subtiles
   walks densely) and pack into per-block submask words
   (``_pack_submask``);
4. B4, ``walk``: each block walks its worklist; per subtile the five
   forms, and the closest-hit epilogue per 32-triangle subgroup that the
   submask lets through.  Ties keep the smallest packed id (strict <
   in ascending id order).

``TwoLevelTris.from_tris`` is host numpy copied from the JAX package;
``to_device`` adds ``packed``, the table without the rows its layout
leaves zero (``accel/plucker.py``), which is what B4 reads.
``cull``/``walk`` are the kernel wrappers; ``cull_plain``/``walk_plain``
beside them are the same functions in plain PyTorch, used for tensors on
the CPU and as the kernels' references on the card.  ``cull_reject`` and
``cull_two_stage`` are plain twins of the exact per-sub-block reject that
kernel B3 runs before its per-ray test; the tests hold them to
``cull_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import cuda_build, spans
from . import plucker
from .fused import _morton

ST = plucker.ST  # triangles per subtile (walk granularity): 128
STF = 32        # triangles per fine subgroup (cull/gating granularity)
RT_WALK = 512   # rays per block (cull/worklist granularity)
MAXS = 384      # worklist slots per block before the dense walk
FINE_MAX_TRIS = 300_000  # beyond: cull cost is rays*n_fine, gate off
_NCOLS = 5 * ST  # table columns: [w0|w1|w2|num|den] * ST
_ROWS = 10  # feature rows that can be non-zero
_CULL_CHUNK = 1 << 25  # (ray, subgroup) pairs per plain-cull step
SUB_RAYS = 128  # rays per sub-block of kernel B3's reject, at most


class TwoLevelTris(NamedTuple):
    """Packed K16 subtile tables + bounds (see statmc_tpu/accel/twolevel.py).

    table:  [nst, 16, 5*ST] f32; rows [d(0:3), o x d(3:6), o(6:9), 1(9),
            0(10:16)]; columns [w0|w1|w2|num|den] per triangle.
    bounds: [nf, 8] fine subgroup AABBs (lo3, hi3, pad2), nf = nst*fsub.
    bounds_planar: [8, nfp] the same transposed and lane-padded (the TPU
            cull's layout, kept for table parity).
    perm:   packed id -> original id, or None when already Morton-ordered.
    packed: [nst, 25, ST] the rows of `table` that can be non-zero
            (plucker.pack_subtiles); set by to_device.
    """
    table: Any
    bounds: Any
    bounds_planar: Any
    perm: Any
    n_tris: int
    n_sub: int
    fsub: int
    world_lo: Any  # [3] scene AABB (ray-sort quantization)
    world_ext: Any  # [3]
    packed: Any = None

    @staticmethod
    def from_tris(p0, e1, e2, fsub: int | None = None) -> "TwoLevelTris":
        """Host numpy tables, copied from
        statmc_tpu/accel/twolevel.py:110-187."""
        p0 = np.asarray(p0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        T = p0.shape[0]
        if fsub is None:
            fsub = ST // STF if T <= FINE_MAX_TRIS else 1
        stf = ST // fsub
        if T > 0:
            v0, v1, v2 = p0, p0 + e1, p0 + e2
            tlo = np.minimum(np.minimum(v0, v1), v2)
            thi = np.maximum(np.maximum(v0, v1), v2)
            order = np.argsort(_morton(0.5 * (tlo + thi)), kind="stable")
            p0, e1, e2 = p0[order], e1[order], e2[order]
            tlo, thi = tlo[order], thi[order]
        else:
            order = np.zeros((0,), np.int64)
            tlo = thi = np.zeros((0, 3), np.float32)
        nst = max(1, -(-T // ST))
        nf = nst * fsub
        Tp = nst * ST
        v0, v1, v2 = p0, p0 + e1, p0 + e2
        n = np.cross(e1, e2)

        tab = np.zeros((nst, 16, 5 * ST), np.float32)
        sub = np.arange(T) // ST
        col = np.arange(T) % ST
        for k, (a, b) in enumerate(((v0, v1), (v1, v2), (v2, v0))):
            tab[sub, 0:3, k * ST + col] = np.cross(a, b)
            tab[sub, 3:6, k * ST + col] = b - a
        tab[sub, 6:9, 3 * ST + col] = -n
        tab[sub, 9, 3 * ST + col] = np.sum(n * v0, axis=-1)
        tab[sub, 0:3, 4 * ST + col] = n
        # Padded triangle columns are all-zero: every w = 0 ("inside")
        # but den = 0 -> t = 1e30, so they can never win.

        bounds = np.zeros((nf, 8), np.float32)
        for j in range(nf):
            a, b = j * stf, min((j + 1) * stf, T)
            if a >= T:
                bounds[j, 0:3] = 1e30
                bounds[j, 3:6] = 1e30
                continue
            lo = tlo[a:b].min(axis=0)
            hi = thi[a:b].max(axis=0)
            eps = 1e-4 * max(1.0, float(np.abs(np.stack([lo, hi])).max()))
            bounds[j, 0:3] = lo - eps
            bounds[j, 3:6] = hi + eps

        real = bounds[:, 0] < 1e29
        wlo = (bounds[real, 0:3].min(axis=0) if real.any()
               else np.zeros(3, np.float32))
        whi = (bounds[real, 3:6].max(axis=0) if real.any()
               else np.ones(3, np.float32))
        nfp = (nf + 127) // 128 * 128
        bp = np.full((8, nfp), 1e30, np.float32)
        bp[0:3, :nf] = bounds[:, 0:3].T
        bp[3:6, :nf] = bounds[:, 3:6].T

        if np.array_equal(order, np.arange(T)):
            perm = None
        else:
            perm = np.full((Tp,), -1, np.int32)
            perm[:T] = order.astype(np.int32)
        return TwoLevelTris(
            table=tab, bounds=bounds, bounds_planar=bp, perm=perm,
            n_tris=T, n_sub=nst, fsub=fsub,
            world_lo=wlo.astype(np.float32),
            world_ext=np.maximum(whi - wlo, 1e-6).astype(np.float32))

    def to_device(self, device) -> "TwoLevelTris":
        def t(x):
            return None if x is None else torch.tensor(
                np.asarray(x), device=device)

        table = t(self.table)
        return self._replace(table=table, bounds=t(self.bounds),
                             bounds_planar=t(self.bounds_planar),
                             perm=t(self.perm), world_lo=t(self.world_lo),
                             world_ext=t(self.world_ext),
                             packed=plucker.pack_subtiles(table))


def ray_features16(o, d):
    """[R, 16] features [d, o x d, o, 1, 0...] pairing with the table rows."""
    m = torch.linalg.cross(o, d, dim=-1)
    one = torch.ones_like(o[..., :1])
    pad = torch.zeros(o.shape[:-1] + (6,), dtype=o.dtype, device=o.device)
    return torch.cat([d, m, o, one, pad], dim=-1)


# ---------------------------------------------------------------------------
# Ray partition and blocking (torch glue).


def _spread5(x):
    """Interleave 5-bit ints with 2-bit gaps (Morton, 15-bit total)."""
    x = x & 0x1F
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    x = (x | (x << 2)) & 0x1249
    return x


def _octant(d):
    return ((d[:, 0] > 0).to(torch.int32) * 4
            + (d[:, 1] > 0).to(torch.int32) * 2
            + (d[:, 2] > 0).to(torch.int32))


def _perm_pos(key):
    """Stable sort of key: (perm, pos), pos the destination lane of each
    input lane and perm its inverse."""
    perm = torch.argsort(key, stable=True)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, pos


def _morton_partition(tl, o, d, t_max):
    """Order by (direction octant, 15-bit origin Morton cell), dead lanes
    (t_max <= 0) last."""
    # Clamped before the cast (the JAX package clips after it): the same
    # cell for every finite origin, and no out-of-range float-to-int cast.
    q = torch.clamp((o - tl.world_lo) / tl.world_ext * 32.0, 0.0, 31.0
                    ).to(torch.int32)
    morton = (_spread5(q[:, 0]) | (_spread5(q[:, 1]) << 1)
              | (_spread5(q[:, 2]) << 2))
    key = (_octant(d) << 15) | morton
    return _perm_pos(torch.where(t_max > 0, key, 1 << 20))


def _octant_partition(o, d, t_max):
    """Stable 9-bucket partition by direction octant, dead lanes last."""
    return _perm_pos(torch.where(t_max > 0, _octant(d), 8))


def blocks(tl, o, d, t_max, sort: bool = True):
    """Rays [R] -> (pos or None, o [Rp,3], d [Rp,3], t_max [Rp]), padded
    to whole RT_WALK blocks (pad rays are dead).  sort=True partitions
    them first, by the JAX package's rule: the Morton key up to
    FINE_MAX_TRIS triangles and 1.1M rays, the octant partition beyond."""
    R = o.shape[0]
    pos = None
    if sort:
        if tl.n_tris <= FINE_MAX_TRIS and R <= 1_100_000:
            perm, pos = _morton_partition(tl, o, d, t_max)
        else:
            perm, pos = _octant_partition(o, d, t_max)
        o, d, t_max = o[perm], d[perm], t_max[perm]
    Rp = max(1, -(-R // RT_WALK)) * RT_WALK
    o = torch.nn.functional.pad(o, (0, 0, 0, Rp - R))
    d = torch.nn.functional.pad(d, (0, 0, 0, Rp - R), value=1.0)
    t_max = torch.nn.functional.pad(t_max, (0, Rp - R))
    return pos, o, d, t_max


def slab_rays(o, d, t_max):
    """Padded rays -> [G, RT_WALK, 8] (o, inverse d, t_max, 0), the cull's
    input.  The inverse is IEEE 1/d where |d| > 1e-12, else +-1e12."""
    inv = torch.where(d.abs() > 1e-12, 1.0 / torch.where(d == 0, 1.0, d),
                      torch.where(d < 0, -1e12, 1e12))
    rays = torch.cat([o, inv, t_max[:, None],
                      torch.zeros_like(t_max[:, None])], dim=-1)
    return rays.reshape(-1, RT_WALK, 8).contiguous()


def block_features(o, d):
    """Padded rays -> [G, 16, RT_WALK] features, the walk's input."""
    return ray_features16(o, d).reshape(-1, RT_WALK, 16).transpose(
        1, 2).contiguous()


# ---------------------------------------------------------------------------
# B3: per-block fine-subgroup votes.


def slab_votes(bounds, rays):
    """bounds [nf, 8], rays [g, RT, 8] -> [g, RT, nf] bool: does ray r of
    block g enter box j within (0, t_max]?  Slab test with tf * 1.0001."""
    r = rays[:, :, None, :]
    tn = torch.full((), -1e30, device=rays.device)
    tf = r[..., 6]
    for a in range(3):
        t0 = (bounds[:, a] - r[..., a]) * r[..., 3 + a]
        t1 = (bounds[:, 3 + a] - r[..., a]) * r[..., 3 + a]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    c = torch.tensor(1.0001, dtype=torch.float32, device=rays.device)
    return (tn <= tf * c) & (tf > 0)


def cull_plain(bounds, rays):
    """Plain PyTorch version of kernel B3: bounds [nf, 8], rays
    [G, RT_WALK, 8] -> vote [G, nf] bool, the OR of `slab_votes` over each
    block's rays.  Elementwise, so the kernel gives the same bits."""
    G, RT = rays.shape[0], rays.shape[1]
    nf = bounds.shape[0]
    vote = torch.zeros((G, nf), dtype=torch.bool, device=rays.device)
    step = max(1, _CULL_CHUNK // (RT * max(nf, 1)))
    for g0 in range(0, G, step):
        vote[g0:g0 + step] = slab_votes(bounds, rays[g0:g0 + step]).any(1)
    return vote


def _sub_blocks(rays):
    """rays [G, RT, 8] -> [G, RT] int64: each live ray's sub-block in
    kernel B3's reject, -1 for dead rays (t_max <= 0 or NaN).  A block's
    live rays are grouped by the octant of their inverse direction, in
    block order, and each octant's run is cut into pieces of SUB_RAYS:
    sub-block = octant * (RT // SUB_RAYS) + rank in the octant // SUB_RAYS."""
    RT = rays.shape[1]
    live = rays[..., 6] > 0
    inv = rays[..., 3:6] > 0
    octant = inv[..., 0].long() * 4 + inv[..., 1].long() * 2 + inv[
        ..., 2].long()
    key = torch.where(live, octant, 8)
    rank = torch.cumsum(torch.nn.functional.one_hot(key, 9), 1).gather(
        2, key[..., None])[..., 0] - 1
    return torch.where(live, octant * (RT // SUB_RAYS) + rank // SUB_RAYS, -1)


def cull_reject(bounds, rays):
    """Plain PyTorch twin of kernel B3's reject, for the tests: bounds
    [nf, 8], rays [G, RT, 8] -> (sub [G, RT] from `_sub_blocks`, keep
    [G, 8 * RT // SUB_RAYS, nf] bool).  keep[g, s, j] is False where
    sub-block s of block g is empty, or where the intervals of its rays'
    origin and inverse-direction components (all finite) bound every
    ray's slab times so that none can vote for box j: the least corner
    product fl(fl(lo - o) * inv) bounds tn from below, the greatest
    bounds tf from above (rounding is monotone in each argument), and
    the pair is dropped if tf_up <= 0 or tn_lo > tf_up * 1.0001.  NaN
    propagates and drops nothing."""
    G, RT = rays.shape[0], rays.shape[1]
    ns = 8 * RT // SUB_RAYS
    sub = _sub_blocks(rays)
    member = torch.nn.functional.one_hot(sub + 1, ns + 1)[..., 1:].bool()
    inf = torch.tensor(float("inf"), device=rays.device)

    def red(x, lo: bool):  # [G, RT] -> [G, ns], NaN-propagating
        if lo:
            return torch.where(member, x[..., None], inf).amin(1)
        return torch.where(member, x[..., None], -inf).amax(1)

    omin = [red(rays[..., a], True) for a in range(3)]
    omax = [red(rays[..., a], False) for a in range(3)]
    imin = [red(rays[..., 3 + a], True) for a in range(3)]
    imax = [red(rays[..., 3 + a], False) for a in range(3)]
    finite = torch.stack(omin + omax + imin + imax).isfinite().all(0)
    tn = torch.full((), -1e30, device=rays.device)
    tf = red(rays[..., 6], False)[..., None]  # [G, ns, 1]
    for a in range(3):
        xs = [(bounds[:, k] - o[..., None]) for k in (a, 3 + a)
              for o in (omax[a], omin[a])]  # [G, ns, nf] each
        ps = [x * i[..., None] for x in xs for i in (imin[a], imax[a])]
        lower, upper = ps[0], ps[0]
        for p in ps[1:]:
            lower = torch.minimum(lower, p)
            upper = torch.maximum(upper, p)
        tn = torch.maximum(tn, lower)
        tf = torch.minimum(tf, upper)
    c = torch.tensor(1.0001, dtype=torch.float32, device=rays.device)
    drop = finite[..., None] & ((tf <= 0) | (tn > tf * c))
    return sub, member.any(1)[..., None] & ~drop


def cull_two_stage(bounds, rays):
    """`cull_plain` through the reject, for the tests: the per-ray slab
    test counts only on the (sub-block, box) pairs that `cull_reject`
    keeps.  Equal to `cull_plain` bit for bit when the reject is exact."""
    G, RT = rays.shape[0], rays.shape[1]
    nf = bounds.shape[0]
    vote = torch.zeros((G, nf), dtype=torch.bool, device=rays.device)
    step = max(1, _CULL_CHUNK // (RT * max(nf, 1)))
    for g0 in range(0, G, step):
        r = rays[g0:g0 + step]
        sub, keep = cull_reject(bounds, r)
        ok = keep.gather(1, sub.clamp(min=0)[..., None].expand(-1, -1, nf))
        vote[g0:g0 + step] = (slab_votes(bounds, r) & ok
                              & (sub >= 0)[..., None]).any(1)
    return vote


def cull(bounds, rays):
    """Kernel B3 wrapper: same contract as `cull_plain`.  CPU tensors
    take the plain version; CUDA tensors launch the kernel, and the
    counter kernel.B3 (spans.py) counts the launches."""
    if not rays.is_cuda:
        return cull_plain(bounds, rays)
    G, nf = rays.shape[0], bounds.shape[0]
    _check("cull", rays, (("bounds", bounds, (nf, 8), torch.float32),
                          ("rays", rays, (G, RT_WALK, 8), torch.float32)))
    vote = torch.empty((G, nf), dtype=torch.bool, device=rays.device)
    rc = cuda_build.library().statmc_twolevel_cull(
        bounds.data_ptr(), rays.data_ptr(), G, nf, vote.data_ptr(),
        _stream(rays))
    cuda_build.check(rc, "statmc_twolevel_cull")
    spans.count("kernel.B3", 1)
    return vote


# ---------------------------------------------------------------------------
# Worklists (torch glue).


def _compact(vote, maxs: int = MAXS):
    """vote [G, nst] bool -> (order [G, maxs] int32, n_eff [G] int32).

    order[g, j] is the id of block g's (j+1)-th voting subtile, in
    ascending id order (the walk's tie rule depends on it), and nst in
    unused slots.  Each voting subtile is scattered to its rank (vote
    cumsum - 1).  Blocks of more than maxs votes walk densely: order
    becomes iota and n_eff = nst, which the walk detects by n_eff > maxs.
    """
    G, nst = vote.shape
    cs = torch.cumsum(vote, dim=1)  # int64
    count = cs[:, -1]
    over = count > maxs
    slot = torch.where(vote & (cs <= maxs), cs - 1, maxs)
    sid = torch.arange(nst, dtype=torch.int32, device=vote.device)
    order = torch.full((G, maxs + 1), nst, dtype=torch.int32,
                       device=vote.device)
    order.scatter_(1, slot, sid.expand(G, nst))
    order = torch.where(over[:, None],
                        torch.arange(maxs, dtype=torch.int32,
                                     device=vote.device), order[:, :maxs])
    n_eff = torch.where(over, nst, count).to(torch.int32)
    return order.contiguous(), n_eff


def _pack_submask(vote_f):
    """Fine votes [G, nf] bool -> bit words [G, nw] int32 (bit i of word w
    = vote for subgroup w*32+i).  Summed in int64, then wrapped to int32
    on purpose: bit 31 is the sign bit."""
    G, nf = vote_f.shape
    nw = max(1, -(-nf // 32))
    v = torch.nn.functional.pad(vote_f, (0, nw * 32 - nf)).to(torch.int64)
    bits = torch.ones((), dtype=torch.int64, device=vote_f.device) << \
        torch.arange(32, device=vote_f.device)
    words = (v.reshape(G, nw, 32) * bits).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32).contiguous()


def worklists(tl, vote_f):
    """Fine votes [G, nf] -> (order [G, MAXS], n_eff [G], mask [G, nw])."""
    G = vote_f.shape[0]
    if tl.fsub > 1:
        vote = vote_f.reshape(G, tl.n_sub, tl.fsub).any(-1)
        mask = _pack_submask(vote_f)
    else:
        vote = vote_f
        mask = torch.zeros((G, 1), dtype=torch.int32, device=vote_f.device)
    order, n_eff = _compact(vote)
    return order, n_eff, mask


# ---------------------------------------------------------------------------
# B4: the worklist walk.


def walk_plain(table, order, n_eff, mask, feat, t_max, fsub: int):
    """Plain PyTorch version of kernel B4.  table [nst, 16, 5*ST], order
    [G, MAXS] i32, n_eff [G] i32, mask [G, nw] i32, feat [G, 16, RT_WALK],
    t_max [G, RT_WALK] -> (t, id) [G, RT_WALK], id packed (-1: no hit, t
    keeps t_max).  Block g walks subtiles order[g, :n_eff[g]] (all
    subtiles in id order when n_eff > MAXS, ignoring the mask), and in
    each the subgroups whose submask bit is set."""
    G, RT = t_max.shape
    dev = t_max.device
    stf = ST // fsub
    best_t = t_max.clone()
    best_id = torch.full((G, RT), -1, dtype=torch.int32, device=dev)
    # Dead lanes (t_max <= 0) can never improve: only the columns live in
    # some block are evaluated.
    cols = torch.nonzero((t_max > 0).any(0))[:, 0]
    if G == 0 or cols.numel() == 0:
        return best_t, best_id
    fr = feat[:, :_ROWS, cols]  # [G, 10, Rl]
    bt, bid = best_t[:, cols], best_id[:, cols]
    n_eff = n_eff.long()
    dense = n_eff > MAXS
    iota = torch.arange(stf, dtype=torch.int32, device=dev)[None, :, None]
    big = torch.tensor(2 ** 30, dtype=torch.int32, device=dev)
    gi = torch.arange(G, device=dev)
    for k in range(int(n_eff.max())):
        active = k < n_eff
        tid = torch.where(dense, k, order[:, min(k, MAXS - 1)].long())
        tid = torch.where(active, tid, 0)
        tab = table[tid]  # [G, 16, 5*ST]
        f = [plucker.chain(tab[:, a:b, i * ST:(i + 1) * ST], fr[:, a:b])
             for i, (a, b) in enumerate(plucker.FORM_ROWS)]  # 5 x [G, ST, Rl]
        w0, w1, w2, num, den = (x.reshape(G, fsub, stf, -1) for x in f)
        wmin = torch.minimum(torch.minimum(w0, w1), w2)
        wmax = torch.maximum(torch.maximum(w0, w1), w2)
        inside = (wmin >= 0) | (wmax <= 0)
        safe = den.abs() > 1e-12
        t = torch.where(safe, num / torch.where(safe, den, 1.0), 1e30)
        tc = torch.where(inside & (t > 1e-4), t, 1e30)  # [G, fsub, stf, Rl]
        tmin = tc.min(2).values  # [G, fsub, Rl]
        ids = (iota + (tid[:, None, None, None].to(torch.int32) * ST
                       + torch.arange(fsub, device=dev, dtype=torch.int32)
                       [None, :, None, None] * stf))
        amin = torch.where(tc <= tmin[:, :, None], ids, big).min(2).values
        if fsub > 1:
            fid = tid[:, None] * fsub + torch.arange(fsub, device=dev)
            word = mask[gi[:, None], fid >> 5]
            go = dense[:, None] | (((word >> (fid & 31)) & 1) > 0)
        else:
            go = torch.ones((G, 1), dtype=torch.bool, device=dev)
        go = go & active[:, None]
        for jj in range(fsub):  # ascending subgroups, strict <
            better = go[:, jj, None] & (tmin[:, jj] < bt)
            bt = torch.where(better, tmin[:, jj], bt)
            bid = torch.where(better, amin[:, jj], bid)
    best_t[:, cols] = bt
    best_id[:, cols] = bid
    return best_t, best_id


def walk(table, order, n_eff, mask, feat, t_max, fsub: int, packed=None):
    """Kernel B4 wrapper: same contract as `walk_plain`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel, and the counter
    kernel.B4 (spans.py) counts the launches.  The kernel reads `packed`
    (TwoLevelTris.packed); a caller that holds only `table` leaves it
    None and it is packed here."""
    if not t_max.is_cuda:
        return walk_plain(table, order, n_eff, mask, feat, t_max, fsub)
    G = t_max.shape[0]
    nst, nw = table.shape[0], mask.shape[1]
    if 32 % fsub or (fsub > 1 and nw * 32 < nst * fsub):
        raise ValueError(f"walk: fsub {fsub} with {nw} mask words for "
                         f"{nst} subtiles")
    if packed is None:
        packed = plucker.pack_subtiles(table)
    _check("walk", t_max, (
        ("table", table, (nst, 16, _NCOLS), torch.float32),
        ("packed", packed, (nst, plucker.PACKED_ROWS, ST), torch.float32),
        ("order", order, (G, MAXS), torch.int32),
        ("n_eff", n_eff, (G,), torch.int32),
        ("mask", mask, (G, nw), torch.int32),
        ("feat", feat, (G, 16, RT_WALK), torch.float32),
        ("t_max", t_max, (G, RT_WALK), torch.float32)))
    t_out = torch.empty((G, RT_WALK), dtype=torch.float32, device=t_max.device)
    id_out = torch.empty((G, RT_WALK), dtype=torch.int32, device=t_max.device)
    rc = cuda_build.library().statmc_twolevel_walk(
        packed.data_ptr(), order.data_ptr(), n_eff.data_ptr(),
        mask.data_ptr(), nw, feat.data_ptr(), t_max.data_ptr(), G, nst,
        fsub, t_out.data_ptr(), id_out.data_ptr(), _stream(t_max))
    cuda_build.check(rc, "statmc_twolevel_walk")
    spans.count("kernel.B4", 1)
    return t_out, id_out


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _check(fn, ref, specs):
    for name, x, shape, dtype in specs:
        if (not x.is_cuda or x.device != ref.device or x.dtype != dtype
                or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} "
                             f"CUDA tensor of shape {tuple(shape)} on "
                             f"{ref.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def intersect_twolevel(tl: TwoLevelTris, o, d, t_max, sort: bool = True):
    """Closest hit: (t, tri_id, hit), the contract of
    fused.intersect_fused.  sort=True partitions the rays into coherent
    blocks first and restores the caller's lane order after; results are
    the same either way (the cull is conservative).  Each stage runs in a
    ``twolevel.*`` span (spans.py), so a torch.profiler trace shows where
    a call's host and device time go."""
    R = o.shape[0]
    with spans.span("twolevel.partition"):
        pos, o_p, d_p, tm_p = blocks(tl, o, d, t_max, sort)
    with spans.span("twolevel.slab_rays"):
        rays = slab_rays(o_p, d_p, tm_p)
    with spans.span("twolevel.cull"):
        vote_f = cull(tl.bounds, rays)
    with spans.span("twolevel.worklists"):
        order, n_eff, mask = worklists(tl, vote_f)
    with spans.span("twolevel.features"):
        feat = block_features(o_p, d_p)
    with spans.span("twolevel.walk"):
        t, idx = walk(tl.table, order, n_eff, mask, feat,
                      tm_p.reshape(-1, RT_WALK), tl.fsub, tl.packed)
    with spans.span("twolevel.unsort"):
        t, idx = t.reshape(-1)[:R], idx.reshape(-1)[:R]
        if tl.perm is not None:
            idx = torch.where(idx >= 0,
                              tl.perm[torch.clamp(idx, min=0).long()], -1)
        else:
            idx = torch.where(idx >= tl.n_tris, -1, idx)
        if pos is not None:
            # Two plain gathers restore the lane order; the JAX package
            # moves t as int32 bits here only because the TPU canonicalises
            # NaN patterns in float lanes, which PyTorch does not.
            t, idx = t[pos], idx[pos]
    return t, idx, idx >= 0
