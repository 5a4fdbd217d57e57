"""What kernels B1 (accel/fused.py) and B4 (accel/twolevel.py) share.

Both test a ray against a triangle through five bilinear forms in Plucker
coordinates: three edge side products w0, w1, w2, the plane numerator and
the denominator.  A *subtile* is 128 triangles as a [16, 5*128] block
whose rows pair with the ray features [d, o x d, o, 1, 0...] and whose
columns are [w0|w1|w2|num|den] per triangle (the two-level table's
layout).  Of its 16 x 5 (row, form) blocks only 25 rows can be non-zero:
rows 0:6 of each w, rows 6:10 of num, rows 0:3 of den (``FORM_ROWS``).
``pack_subtiles`` keeps exactly those, as the [nst, 25, 128] table the
CUDA core ``csrc/plucker.cuh`` streams; ``fused_subtiles`` lays the fused
intersector's 256-triangle tiles out as subtiles, so that both kernels
read one format.  ``chain`` is the fused multiply-add chain in which the
kernels and their plain versions evaluate every form.
"""
from __future__ import annotations

import torch

ST = 128  # triangles per subtile
# Feature rows each form [w0, w1, w2, num, den] reads; the table layouts
# leave every other row of the form's columns zero.  A zero row adds
# fma(0, x, acc) = acc up to the sign of a zero, which no comparison of
# the epilogue reads, so the kernels and the plain versions skip them.
FORM_ROWS = ((0, 6), (0, 6), (0, 6), (6, 10), (0, 3))
PACKED_ROWS = sum(b - a for a, b in FORM_ROWS)  # 25


def chain(tab_rows, feat_rows):
    """sum_k tab[k] * feat[k] as a fused multiply-add chain in row order
    from 0, the kernels' __fmaf_rn chain (and the rounding of the JAX
    package's CPU dot): each product is exact in float64 and each step
    rounds to float32 (one rounding but for exact float32 ties).
    tab_rows [..., K, C], feat_rows [..., K, R] -> [..., C, R]."""
    acc = torch.zeros((), dtype=torch.float64, device=feat_rows.device)
    for k in range(tab_rows.shape[-2]):
        acc = (tab_rows[..., k, :, None].double()
               * feat_rows[..., k, None, :].double() + acc).float().double()
    return acc.float()


def pack_subtiles(table):
    """table [nst, 16, 5*ST] -> packed [nst, 25, ST]: rows 0:6 w0, 6:12
    w1, 12:18 w2 (feature rows 0:6 each), 18:22 num (feature rows 6:10),
    22:25 den (feature rows 0:3).  Drops only rows the layout leaves
    zero."""
    return torch.cat([table[:, a:b, i * ST:(i + 1) * ST]
                      for i, (a, b) in enumerate(FORM_ROWS)],
                     dim=1).contiguous()


def fused_subtiles(edge_table, plane_table):
    """The fused tables (edge [ntt, 3, 256, 8], rows against [d, o x d,
    0, 0]; plane [ntt, 2, 256, 8], rows against [d, o, 1, 0]) as two
    subtiles per tile, [2*ntt, 16, 5*ST]: packed triangle id tile*256 + k
    becomes column k % 128 of subtile id // 128.  The plane numerator's
    columns 3:7 ([-n, n.v0] against [o, 1]) move to feature rows 6:10."""
    ntt, _, tt, _ = edge_table.shape
    h = tt // ST
    tab = torch.zeros((ntt, h, 16, 5, ST), dtype=edge_table.dtype,
                      device=edge_table.device)
    e = edge_table.reshape(ntt, 3, h, ST, 8).permute(0, 2, 4, 1, 3)
    p = plane_table.reshape(ntt, 2, h, ST, 8).permute(0, 2, 4, 1, 3)
    tab[:, :, 0:6, 0:3] = e[:, :, 0:6]         # [ntt, h, col, edge, k]
    tab[:, :, 6:10, 3] = p[:, :, 3:7, 0]
    tab[:, :, 0:3, 4] = p[:, :, 0:3, 1]
    return tab.reshape(ntt * h, 16, 5 * ST)


def pack_fused(edge_table, plane_table):
    """The fused tables as kernel B1 reads them: [2*ntt, 25, ST]."""
    return pack_subtiles(fused_subtiles(edge_table, plane_table))
