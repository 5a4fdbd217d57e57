"""Fused dense intersection over a packed, Morton-ordered triangle table
(port of statmc_tpu/accel/fused.py), with kernel B1.

A ray-triangle test is a bilinear form in Plucker coordinates: per
(ray, triangle) three edge side products decide inside/outside and one
plane equation gives t

    w_k = edge_k . [d, o x d, 0, 0],   num/den = plane . [d, o, 1, 0].

``FusedTris.from_tris`` (host numpy, copied from the JAX package) packs
the rows in 256-triangle tiles; ``to_device`` adds ``packed``, the same
coefficients without the columns the layout leaves zero, as 128-triangle
subtiles (``accel/plucker.py``), which is what the kernel reads.
``intersect_tiles`` is the wrapper of the CUDA kernel
``csrc/fused_intersect.cu``; ``intersect_plain`` beside it is the same
function in plain PyTorch, used for tensors on the CPU and as the
kernel's reference on the card.  Both evaluate each dot as the same
fused multiply-add chain over its non-zero columns, which is also how
the JAX package's CPU dot rounds, so all three agree bit for bit on
finite rays.  The TPU kernel's per-tile AABB cull and lane compaction
are not ported: both were exact, so results are unchanged.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import cuda_build, spans
from . import plucker

TRI_TILE = 256  # triangles per tile
FUSED_MAX_TRIS = 16384  # the fused path's cap; larger scenes are two-level
_K = 8  # ray feature columns per dot


def _morton(cent: np.ndarray) -> np.ndarray:
    """30-bit Morton codes from [T,3] centroids (10 bits/axis)."""
    lo = cent.min(axis=0)
    ext = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.minimum(((cent - lo) / ext * 1024.0).astype(np.uint64), 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << 1)
            | (spread(q[:, 2]) << 2))


class FusedTris(NamedTuple):
    """Packed per-triangle row tables (see statmc_tpu/accel/fused.py).

    edge_table:  [Ntt, 3, TRI_TILE, 8] f32, rows [a x b, b - a, 0, 0].
    plane_table: [Ntt, 2, TRI_TILE, 8] f32, numerator [0,0,0, -n, n.v0, 0]
                 and denominator [n, 0...].
    tile_bounds: [Ntt, 8] per-tile AABB (kept for layout parity).
    perm:        [Ntt*TRI_TILE] packed id -> original id, or None when
                 the input was already Morton-ordered.
    packed:      [2*Ntt, 25, 128] the non-zero coefficient rows as
                 subtiles (plucker.pack_fused); set by to_device.
    """

    edge_table: Any
    plane_table: Any
    tile_bounds: Any
    perm: Any
    n_tris: int
    packed: Any = None

    @staticmethod
    def from_tris(p0, e1, e2) -> "FusedTris":
        """Host numpy tables, copied from statmc_tpu/accel/fused.py:105-162."""
        p0 = np.asarray(p0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        T = p0.shape[0]
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
        ntt = max(1, -(-T // TRI_TILE))
        Tp = ntt * TRI_TILE
        v0, v1, v2 = p0, p0 + e1, p0 + e2
        n = np.cross(e1, e2)
        er = np.zeros((3, Tp, _K), np.float32)
        for k, (a, b) in enumerate(((v0, v1), (v1, v2), (v2, v0))):
            er[k, :T, 0:3] = np.cross(a, b)
            er[k, :T, 3:6] = b - a
        pr = np.zeros((2, Tp, _K), np.float32)
        pr[0, :T, 3:6] = -n
        pr[0, :T, 6] = np.sum(n * v0, axis=-1)
        pr[1, :T, 0:3] = n
        bounds = np.zeros((ntt, 8), np.float32)
        for j in range(ntt):
            a, b = j * TRI_TILE, min((j + 1) * TRI_TILE, T)
            if a >= T:
                bounds[j, 0:3] = 1e30
                bounds[j, 3:6] = 1e30
                continue
            lo = tlo[a:b].min(axis=0)
            hi = thi[a:b].max(axis=0)
            eps = 1e-4 * max(1.0, float(np.abs(np.stack([lo, hi])).max()))
            bounds[j, 0:3] = lo - eps
            bounds[j, 3:6] = hi + eps
        if np.array_equal(order, np.arange(T)):
            perm = None
        else:
            perm_np = np.full((Tp,), -1, np.int32)
            perm_np[:T] = order.astype(np.int32)
            perm = perm_np
        return FusedTris(
            edge_table=np.ascontiguousarray(
                er.reshape(3, ntt, TRI_TILE, _K).transpose(1, 0, 2, 3)),
            plane_table=np.ascontiguousarray(
                pr.reshape(2, ntt, TRI_TILE, _K).transpose(1, 0, 2, 3)),
            tile_bounds=bounds,
            perm=perm,
            n_tris=T,
        )

    def to_device(self, device) -> "FusedTris":
        def t(x):
            return None if x is None else torch.tensor(x, device=device)

        edge, plane = t(self.edge_table), t(self.plane_table)
        return self._replace(edge_table=edge, plane_table=plane,
                             tile_bounds=t(self.tile_bounds),
                             perm=t(self.perm),
                             packed=plucker.pack_fused(edge, plane))


def ray_features(o, d):
    """[R,3] origins/directions -> ([R,8] edge rows [d, o x d, 0, 0],
    [R,8] plane rows [d, o, 1, 0])."""
    m = torch.linalg.cross(o, d, dim=-1)
    one = torch.ones_like(o[..., :1])
    zero1 = torch.zeros_like(o[..., :1])
    ray_e = torch.cat([d, m, zero1, zero1], dim=-1)
    ray_p = torch.cat([d, o, one, zero1], dim=-1)
    return ray_e, ray_p


def _dot8(rows, ray, lo: int, hi: int):
    """rows [N, 8] x ray [R, 8] -> [N, R] over columns lo:hi, the columns
    the table layout leaves non-zero in `rows`, as a fused multiply-add
    chain in column order from 0 (plucker.chain): the kernel's order, and
    the rounding of the JAX package's CPU dot."""
    return plucker.chain(rows[:, lo:hi].T, ray[:, lo:hi].T)


def intersect_plain(edge_table, plane_table, raye, rayp, t_max,
                    n_tris=None):
    """Plain PyTorch version of kernel B1: closest hit of every ray over
    all tiles.  raye/rayp [R,8], t_max [R] -> (t [R], id [R] int32) in
    packed order; a miss keeps t_max and id -1.  n_tris, as for the
    kernel, says that the rows from n_tris on are all-zero padding, which
    can hit nothing and are skipped."""
    R = raye.shape[0]
    dev = raye.device
    best_t = t_max.clone()
    best_id = torch.full((R,), -1, dtype=torch.int32, device=dev)
    iota = torch.arange(TRI_TILE, dtype=torch.int32, device=dev)[:, None]
    big = torch.tensor(2 ** 30, dtype=torch.int32, device=dev)
    ntt = edge_table.shape[0]
    if n_tris is not None:
        ntt = min(ntt, -(-n_tris // TRI_TILE))
    for j in range(ntt):
        rows = slice(0, TRI_TILE if n_tris is None
                     else min(TRI_TILE, n_tris - j * TRI_TILE))
        w0, w1, w2 = (_dot8(edge_table[j, k, rows], raye, 0, 6)
                      for k in range(3))
        num = _dot8(plane_table[j, 0, rows], rayp, 3, 7)
        den = _dot8(plane_table[j, 1, rows], rayp, 0, 3)
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
                  | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
        safe = torch.abs(den) > 1e-12
        t = torch.where(safe, num / torch.where(safe, den, 1.0), 1e30)
        tc = torch.where(inside & (t > 1e-4), t, 1e30)  # [Tt, R]
        tmin = torch.min(tc, dim=0).values
        amin = torch.min(torch.where(tc <= tmin, iota[:tc.shape[0]], big),
                         dim=0).values
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_id = torch.where(better, amin + j * TRI_TILE, best_id)
    return best_t, best_id


def intersect_tiles(edge_table, plane_table, raye, rayp, t_max, packed=None,
                    n_tris=None):
    """Kernel B1 wrapper: same contract as `intersect_plain`.  CPU tensors
    take the plain version; CUDA tensors launch the kernel, and the
    counter kernel.B1 (spans.py) counts the launches.  The kernel reads
    `packed` (FusedTris.packed); a caller that holds only the two tables
    leaves it None and it is packed from them here.  n_tris
    (FusedTris.n_tris) says that the rows from n_tris on are padding, all
    zero, which the kernel then does not walk; None: every row is
    tested."""
    if not raye.is_cuda:
        return intersect_plain(edge_table, plane_table, raye, rayp, t_max,
                               n_tris)
    R = raye.shape[0]
    ntt = edge_table.shape[0]
    nsub = ntt * (TRI_TILE // plucker.ST)
    if packed is None:
        packed = plucker.pack_fused(edge_table, plane_table)
    if n_tris is None:
        n_tris = ntt * TRI_TILE
    if not 0 <= n_tris <= ntt * TRI_TILE:
        raise ValueError(f"intersect_tiles: n_tris {n_tris} for {ntt} tiles")
    for name, x, shape in (
            ("edge_table", edge_table, (ntt, 3, TRI_TILE, _K)),
            ("plane_table", plane_table, (ntt, 2, TRI_TILE, _K)),
            ("raye", raye, (R, _K)), ("rayp", rayp, (R, _K)),
            ("t_max", t_max, (R,)),
            ("packed", packed, (nsub, plucker.PACKED_ROWS, plucker.ST))):
        if (not x.is_cuda or x.device != raye.device
                or x.dtype != torch.float32 or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"intersect_tiles: {name} must be a contiguous "
                             f"float32 CUDA tensor of shape {shape} on "
                             f"{raye.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    t_out = torch.empty((R,), dtype=torch.float32, device=raye.device)
    id_out = torch.empty((R,), dtype=torch.int32, device=raye.device)
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(raye.device).cuda_stream
    rc = lib.statmc_fused_intersect(
        raye.data_ptr(), rayp.data_ptr(), t_max.data_ptr(),
        packed.data_ptr(), R, nsub, n_tris,
        t_out.data_ptr(), id_out.data_ptr(), ctypes.c_void_p(stream))
    cuda_build.check(rc, "statmc_fused_intersect")
    spans.count("kernel.B1", 1)
    return t_out, id_out


def intersect_fused(ft: FusedTris, o, d, t_max):
    """Closest hit against all triangles: (t, tri_id, hit).  t keeps the
    incoming t_max on a miss; ids are original triangle ids."""
    raye, rayp = ray_features(o, d)
    t, idx = intersect_tiles(ft.edge_table, ft.plane_table,
                             raye.contiguous(), rayp.contiguous(),
                             t_max.contiguous(), ft.packed, ft.n_tris)
    if ft.perm is not None:
        idx = torch.where(idx >= 0, ft.perm[torch.clamp(idx, min=0).long()],
                          -1)
    else:
        idx = torch.where(idx >= ft.n_tris, -1, idx)
    return t, idx, idx >= 0
