"""kd-tree accelerator: pbrt's SAH build and the kd-restart walk (port of
statmc_tpu/accel/kdtree.py).

The build (``build_kdtree``) is host numpy, copied from
statmc_tpu/accel/kdtree.py:59-185 (that module imports jax, so it is not
imported): the exact SAH sweep over sorted bound edges, the empty bonus,
the max-extent axis with two retries, the bad-refine counter and the
depth bound 8 + 1.3 log2 N (kdtreeaccel.cpp:140-270).

The walk (``intersect_kdtree``) is plain PyTorch: the JAX package walks
outside any Pallas kernel, and so does the port.  It is the kd-restart
scheme of :190-296 there -- descend from the root clipping [t_lo, t_hi]
to the near child, test the reached leaf, advance t_lo past the leaf and
restart -- run on the live lanes only: a lane's result depends only on
its own step count, so finished lanes are dropped after every step and
the loop stops when none is left or at the JAX package's cap,
8 * n_nodes + 64 steps.  A leaf is tested on its (lane, triangle) pairs,
flattened, instead of padded to the widest leaf.  Both reference defects
are mirrored: the ``inv_d`` fallback gives 0 for direction components in
(-1e-12, 0) (:195-196), and the advance band ``eps * max(1, |t_hi|)``
can step over thin cells (:270).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import math as cm

# Leaf flag in the packed node row.
_LEAF = 3

# Set to a list to record, per intersect call, the rays, the loop's steps,
# the lane-steps (live lanes summed over steps) and the cap.
walk_stats = None


class KdTreeTris(NamedTuple):
    """Flat tables for the kd-restart walk (numpy on the host, tensors
    after ``to_device``)."""
    node_f: Any   # [N, 1] f32: split position
    node_i: Any   # [N, 4] i32: axis/flags (3 = leaf), above_child,
    #                           leaf_offset, leaf_count
    leaf_prims: Any  # [P] i32 flat triangle ids for all leaves
    tri_p0: Any   # [T, 3] triangle tables (the walk is self-contained)
    tri_e1: Any
    tri_e2: Any
    world_lo: Any  # [3] scene bound
    world_hi: Any  # [3]
    n_nodes: int
    max_leaf: int  # most primitives in any leaf
    tri_table: Any = None  # [T, 9] (p0, e1, e2) per triangle, on the device

    @staticmethod
    def from_tris(tri_p0, tri_e1, tri_e2, **kw) -> "KdTreeTris":
        return build_kdtree(tri_p0, tri_e1, tri_e2, **kw)

    def to_device(self, device) -> "KdTreeTris":
        def t(x):
            return torch.as_tensor(np.asarray(x), device=device)

        tris = [t(x) for x in (self.tri_p0, self.tri_e1, self.tri_e2)]
        return self._replace(
            node_f=t(self.node_f), node_i=t(self.node_i).long(),
            leaf_prims=t(self.leaf_prims), tri_p0=tris[0], tri_e1=tris[1],
            tri_e2=tris[2], world_lo=t(self.world_lo),
            world_hi=t(self.world_hi), tri_table=torch.cat(tris, 1))

    def depth(self) -> int:
        """Depth of the deepest leaf (the root at 0)."""
        node_i = np.asarray(self.node_i.cpu() if torch.is_tensor(self.node_i)
                            else self.node_i)
        depth = np.zeros(len(node_i), np.int64)
        for n in range(len(node_i)):  # children follow their parent
            if node_i[n, 0] != _LEAF:
                depth[n + 1] = depth[n] + 1
                depth[node_i[n, 1]] = depth[n] + 1
        return int(depth.max())


def build_kdtree(tri_p0, tri_e1, tri_e2, isect_cost: int = 80,
                 trav_cost: int = 1, empty_bonus: float = 0.5,
                 max_prims: int = 1, max_depth: int = -1) -> KdTreeTris:
    """SAH kd-tree over triangles (kdtreeaccel.cpp:84-270 semantics,
    iterative instead of recursive; numpy edge sweeps)."""
    p0 = np.asarray(tri_p0, np.float64)
    e1 = np.asarray(tri_e1, np.float64)
    e2 = np.asarray(tri_e2, np.float64)
    T = p0.shape[0]
    v1, v2 = p0 + e1, p0 + e2
    blo = np.minimum(np.minimum(p0, v1), v2)
    bhi = np.maximum(np.maximum(p0, v1), v2)
    wlo = blo.min(0) if T else np.zeros(3)
    whi = bhi.max(0) if T else np.ones(3)
    if max_depth <= 0:
        max_depth = int(round(8 + 1.3 * np.log2(max(T, 1))))

    node_f: list[float] = []
    node_i: list[tuple] = []
    leaf_prims: list[int] = []
    max_leaf = 1

    def make_leaf(prims):
        nonlocal max_leaf
        off = len(leaf_prims)
        leaf_prims.extend(int(p) for p in prims)
        max_leaf = max(max_leaf, len(prims))
        node_f.append(0.0)
        node_i.append((_LEAF, -1, off, len(prims)))

    # Iterative depth-first build; the second-child link patches in
    # after the below subtree emits (pbrt's AboveChild pointer,
    # kdtreeaccel.cpp:246-266).
    stack = [(np.arange(T), wlo.copy(), whi.copy(), max_depth, 0, -1)]
    while stack:
        prims, nlo, nhi, depth, bad, patch = stack.pop()
        node_id = len(node_i)
        if patch >= 0:  # we are the above-child of node `patch`
            f, _, lo_, lc_ = node_i[patch]
            node_i[patch] = (f, node_id, lo_, lc_)
        n = len(prims)
        if n <= max_prims or depth == 0:
            make_leaf(prims)
            continue
        d = nhi - nlo
        inv_sa = 1.0 / max(
            2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]), 1e-30)
        old_cost = isect_cost * n
        best = (np.inf, -1, -1.0, None, None)  # cost, axis, t, below, above
        axis = int(np.argmax(d))
        for retry in range(3):
            ax = (axis + retry) % 3
            lo_e = blo[prims, ax]
            hi_e = bhi[prims, ax]
            # Edge list: (t, type) with starts before ends at equal t
            # (the sort predicate at kdtreeaccel.cpp:191-197).
            ts = np.concatenate([lo_e, hi_e])
            typ = np.concatenate([np.zeros(n, np.int8),
                                  np.ones(n, np.int8)])
            order = np.lexsort((typ, ts))
            ts_s, typ_s = ts[order], typ[order]
            ends_before = np.cumsum(typ_s) - typ_s  # ends strictly before i
            starts_before = np.arange(2 * n) - ends_before
            n_above = n - ends_before - typ_s  # end at i decrements first
            n_below = starts_before
            oa0, oa1 = (ax + 1) % 3, (ax + 2) % 3
            inside = (ts_s > nlo[ax]) & (ts_s < nhi[ax])
            below_sa = 2 * (d[oa0] * d[oa1]
                            + (ts_s - nlo[ax]) * (d[oa0] + d[oa1]))
            above_sa = 2 * (d[oa0] * d[oa1]
                            + (nhi[ax] - ts_s) * (d[oa0] + d[oa1]))
            eb = np.where((n_above == 0) | (n_below == 0), empty_bonus,
                          0.0)
            cost = trav_cost + isect_cost * (1 - eb) * inv_sa * (
                below_sa * n_below + above_sa * n_above)
            cost = np.where(inside, cost, np.inf)
            j = int(np.argmin(cost)) if len(cost) else 0
            if len(cost) and np.isfinite(cost[j]) and cost[j] < best[0]:
                t_split = float(ts_s[j])
                below = prims[lo_e < t_split]
                above = prims[hi_e > t_split]
                # Edge-exact membership (pbrt classifies by the sorted
                # edge index, :246-252): prims whose lo == t_split and
                # are flat at the plane go above for start edges.
                flat = prims[(lo_e == t_split) & (hi_e == t_split)]
                if typ_s[j] == 0:  # start edge: flat prims go above
                    above = np.union1d(above, flat)
                else:
                    below = np.union1d(below, flat)
                best = (float(cost[j]), ax, t_split, below, above)
            if best[1] >= 0:
                break
        bcost, bax, bt, below, above = best
        if bcost > old_cost:
            bad += 1
        if (bax < 0 or bad == 3
                or (bcost > 4 * old_cost and n < 16)):
            make_leaf(prims)
            continue
        node_f.append(bt)
        node_i.append((bax, -1, 0, 0))  # above_child patched later
        lo_b, hi_b = nlo.copy(), nhi.copy()
        hi_b[bax] = bt
        lo_a, hi_a = nlo.copy(), nhi.copy()
        lo_a[bax] = bt
        # Push above first so below (node_id + 1) emits next (pbrt's
        # children-contiguous-below layout).
        stack.append((above, lo_a, hi_a, depth - 1, bad, node_id))
        stack.append((below, lo_b, hi_b, depth - 1, bad, -1))

    if not node_i:
        make_leaf(np.arange(T))
    if not leaf_prims:
        leaf_prims.append(-1)
    return KdTreeTris(
        node_f=np.asarray(node_f, np.float32)[:, None],
        node_i=np.asarray(node_i, np.int32),
        leaf_prims=np.asarray(leaf_prims, np.int32),
        tri_p0=np.asarray(tri_p0, np.float32),
        tri_e1=np.asarray(tri_e1, np.float32),
        tri_e2=np.asarray(tri_e2, np.float32),
        world_lo=wlo.astype(np.float32),
        world_hi=whi.astype(np.float32),
        n_nodes=len(node_i),
        max_leaf=int(max_leaf),
    )


def _leaf_test(kd: KdTreeTris, ray, off, cnt, total: int, t_best):
    """Moller-Trumbore over the cnt triangles of each lane's leaf from
    offset off (statmc_tpu/accel/kdtree.py:220-250); ray [n, 9] holds
    each lane's o, d and inv_d.  Returns the closest valid t below t_best
    per lane, INF where none, and its triangle id (the first in leaf
    order among equal t).  total = cnt.sum()."""
    n = ray.shape[0]
    dev = ray.device
    eps = 1e-4
    lane = torch.repeat_interleave(torch.arange(n, device=dev), cnt,
                                   output_size=total)
    pos = torch.arange(total, device=dev) - (torch.cumsum(cnt, 0) - cnt)[lane]
    ids = kd.leaf_prims[(off[lane] + pos).long()]
    tri = kd.tri_table[torch.clamp(ids, min=0).long()]
    p0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    r = ray[lane]
    oo, dd = r[:, 0:3], r[:, 3:6]
    pvec = cm.cross(dd, e2)
    tvec = oo - p0
    qvec = cm.cross(tvec, e1)
    # The four dots in one go, rounded as XLA's compiled code rounds them
    # (dot_fused): on rays through a shared edge they decide which
    # triangle is hit.
    det, du, dv, dt = cm.dot_fused(torch.stack([e1, tvec, dd, e2]),
                                   torch.stack([pvec, pvec, qvec, qvec]))
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    u, v, t = du * inv_det, dv * inv_det, dt * inv_det
    ok = ((ids >= 0) & ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > eps) & (t < t_best[lane]))
    t = torch.where(ok, t, cm.INF)
    tj = torch.full((n,), cm.INF, device=dev).scatter_reduce(
        0, lane, t, "amin")
    first = torch.where(ok & (t == tj[lane]), pos, total)
    j = torch.full((n,), total, dtype=pos.dtype, device=dev).scatter_reduce(
        0, lane, first, "amin")
    idj = kd.leaf_prims[torch.clamp(off + j, max=kd.leaf_prims.shape[0] - 1)
                        .long()]
    return tj, idj


def intersect_kdtree(kd: KdTreeTris, o, d, t_max, any_hit: bool = False):
    """Closest hit (or any hit) through the kd-restart walk.
    Returns (t [R], tri_id [R] (-1 miss), hit [R])."""
    R = o.shape[0]
    dev = o.device
    eps = 1e-4
    inv_d = torch.where(torch.abs(d) > 1e-12, 1.0 / d,
                        torch.sign(d) * 1e12 + 1e12)
    b0 = (kd.world_lo[None, :] - o) * inv_d
    b1 = (kd.world_hi[None, :] - o) * inv_d
    t_enter = torch.clamp(torch.amax(torch.minimum(b0, b1), -1), min=0.0)
    t_exit = torch.amin(torch.maximum(b0, b1), -1)
    miss_scene = t_enter > torch.minimum(t_exit, t_max)
    n_steps = 8 * kd.n_nodes + 64

    t_out = t_max.clone()
    id_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    # The live lanes' state, stacked so that dropping lanes is one gather
    # a table: ray = (o, d, inv_d); tf = (t_lo, t_hi, t_best, t_exit,
    # t_max); ti = (node, best id, lane).
    lanes = torch.nonzero(~(miss_scene | (t_max <= 0)))[:, 0]
    ray = torch.cat([o, d, inv_d], 1)[lanes]
    tf = torch.stack([t_enter, torch.minimum(t_exit, t_max), t_max, t_exit,
                      t_max], 1)[lanes]
    ti = torch.stack([torch.zeros_like(lanes), torch.full_like(lanes, -1),
                      lanes], 1)
    cols = torch.tensor([0, 3, 6], device=dev)
    it = 0
    lane_steps = 0
    while it < n_steps and ti.shape[0] > 0:
        lane_steps += ti.shape[0]
        node, t_lo, t_hi, t_best = ti[:, 0], tf[:, 0], tf[:, 1], tf[:, 2]
        row_i = kd.node_i[node]
        split = kd.node_f[node, 0]
        is_leaf = row_i[:, 0] == _LEAF

        # Interior descent: clip [t_lo, t_hi] to the child containing
        # the interval (or its near part when it crosses the split).
        g = torch.gather(ray, 1, torch.clamp(row_i[:, :1], max=2).long()
                         + cols)
        o_ax, d_ax, inv_ax = g[:, 0], g[:, 1], g[:, 2]
        t_split = (split - o_ax) * inv_ax
        crosses = (t_split > t_lo) & (t_split < t_hi)
        p_mid = o_ax + 0.5 * (t_lo + t_hi) * d_ax
        near_below = torch.where(crosses, d_ax > 0, p_mid < split)
        node_desc = torch.where(near_below, node + 1, row_i[:, 1].long())
        t_hi_desc = torch.where(crosses, t_split, t_hi)

        # Leaf test on the pairs of the lanes that stand in a leaf (the
        # other lanes have none), skipped when no lane has a pair.
        best_id = ti[:, 1]
        cnt = torch.where(is_leaf, row_i[:, 3], 0)
        total = int(cnt.sum())
        if total:
            tj, idj = _leaf_test(kd, ray, row_i[:, 2], cnt, total, t_best)
            found = tj < t_best
            t_best = torch.where(found, tj, t_best)
            best_id = torch.where(found, idj.long(), best_id)

        # Leaf epilogue: restart from the root past this pass's t_hi.
        new_lo = t_hi + eps * torch.clamp(torch.abs(t_hi), min=1.0)
        lim = torch.minimum(tf[:, 3], torch.minimum(t_best, tf[:, 4]))
        done = is_leaf & (new_lo >= lim)
        if any_hit:
            done |= is_leaf & (best_id >= 0)
        tf = torch.stack([torch.where(is_leaf, new_lo, t_lo),
                          torch.where(is_leaf, lim, t_hi_desc), t_best,
                          tf[:, 3], tf[:, 4]], 1)
        ti = torch.stack([torch.where(is_leaf, 0, node_desc), best_id,
                          ti[:, 2]], 1)
        it += 1

        # Record every live lane's result (a lane's last record is its
        # answer, also at the cap) and drop the finished lanes: one host
        # synchronisation here, one for the leaf test's pair count.
        t_out[ti[:, 2]] = tf[:, 2]
        id_out[ti[:, 2]] = ti[:, 1].to(torch.int32)
        keep = torch.nonzero(~done)[:, 0]
        ray, tf, ti = ray[keep], tf[keep], ti[keep]
    if walk_stats is not None:
        walk_stats.append({"rays": R, "steps": it, "lane_steps": lane_steps,
                           "cap": n_steps})
    return t_out, id_out, id_out >= 0
