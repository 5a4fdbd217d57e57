# Copied from statmc_tpu/core/sobol.py:37-150 (numpy host code); sobol_bits
# and sobol_1d are rewritten for torch.
"""True Sobol' sampler: generator matrices + per-site XOR scrambling.

The generator matrices are generated from primitive polynomials over
GF(2) (dimension 0 the van der Corput identity, dimension 1 the classic
x+1 recurrence, higher dimensions seeded from 0x5EED), exactly as the
JAX package generates them; no table is downloaded.  A draw is a 32-step
XOR fold of the matrix columns over the sample index bits, on int64
tensors holding uint32 values.
"""
from __future__ import annotations

import numpy as np
import torch

N_DIMS = 160  # camera(4) + lens + 8 slots x 2 x ~9 bounces, with slack


def _poly_mulmod(a: int, b: int, mod: int, deg: int) -> int:
    """GF(2)[x] multiply a*b mod `mod` (mod has degree `deg`)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> deg & 1:
            a ^= mod
    return r


def _is_primitive(poly: int, deg: int) -> bool:
    """Is the degree-`deg` polynomial (bitmask incl. leading term)
    primitive over GF(2)?  x must have multiplicative order 2^deg - 1
    in GF(2)[x]/poly."""
    order = (1 << deg) - 1

    def powx(e: int) -> int:
        result, base = 1, 2  # 1, x
        while e:
            if e & 1:
                result = _poly_mulmod(result, base, poly, deg)
            base = _poly_mulmod(base, base, poly, deg)
            e >>= 1
        return result

    if powx(order) != 1:
        return False
    # order must be exactly 2^deg-1: check all maximal proper divisors.
    n, fac, d = order, [], 2
    while d * d <= n:
        if n % d == 0:
            fac.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fac.append(n)
    return all(powx(order // f) != 1 for f in fac)


def _primitive_polys(count: int) -> list[tuple[int, int]]:
    """First `count` primitive polynomials as (degree, coeff-bitmask of
    a_1..a_{deg-1}), in degree order then numeric order -- the ordering
    Sobol' constructions conventionally use."""
    out = []
    deg = 1
    while len(out) < count:
        # candidates: x^deg + (inner bits) + 1
        for inner in range(1 << max(deg - 1, 0)):
            poly = (1 << deg) | (inner << 1) | 1
            if deg == 1:
                poly = 0b11  # x + 1
                ok = True
            else:
                ok = _is_primitive(poly, deg)
            if ok:
                out.append((deg, inner))
                if len(out) >= count:
                    break
            if deg == 1:
                break
        deg += 1
    return out


def generate_matrices(n_dims: int = N_DIMS, seed: int = 0x5EED) -> np.ndarray:
    """[n_dims, 32] uint32 direction-number matrices (column j holds
    v_j scaled so the MSB is bit 31)."""
    mats = np.zeros((n_dims, 32), np.uint64)
    # Dim 0: identity (van der Corput).
    for j in range(32):
        mats[0, j] = 1 << (31 - j)
    rng = np.random.default_rng(seed)
    polys = _primitive_polys(n_dims)  # dim d uses polys[d-1]
    for d in range(1, n_dims):
        deg, inner = polys[d - 1]
        a = [(inner >> (deg - 1 - k)) & 1 for k in range(deg - 1)]
        # Initial odd direction numbers m_1..m_deg (m_i < 2^i, odd).
        if d == 1:
            m = [1]  # the classic second dimension (v ^= v >> 1)
        else:
            m = [int(rng.integers(0, 1 << max(i, 1)) * 2 + 1) % (1 << (i + 1))
                 for i in range(deg)]
        # Recurrence (Bratley-Fox): m_k = XOR_{i<deg} 2^{i+1} a_{i+1}
        # m_{k-i-1}  ^  2^deg m_{k-deg} ^ m_{k-deg}.
        for k in range(deg, 32):
            val = (m[k - deg] << deg) ^ m[k - deg]
            for i in range(deg - 1):
                if a[i]:
                    val ^= m[k - 1 - i] << (i + 1)
            m.append(val)
        for j in range(32):
            mats[d, j] = (np.uint64(m[j]) << np.uint64(31 - j)) \
                & np.uint64(0xFFFFFFFF)
    return mats.astype(np.uint32)


_MATS = None


def matrices() -> np.ndarray:
    """Host-side cached matrix table (numpy)."""
    global _MATS
    if _MATS is None:
        _MATS = generate_matrices()
    return _MATS


_TAB = {}  # device -> matrices() as int64, made once per device


def sobol_bits(dim, index):
    """uint32 Sobol' sample bits (int64 tensor) for dimension(s) `dim` and
    sample index `index` (int tensors, broadcast)."""
    dev = dim.device
    tab = _TAB.get(dev)
    if tab is None:
        tab = _TAB[dev] = torch.as_tensor(matrices().astype(np.int64),
                                          device=dev)
    rows = tab[torch.clamp(dim.to(torch.int64), 0, N_DIMS - 1)]  # [..., 32]
    idx = torch.broadcast_to(index.to(torch.int64) & 0xFFFFFFFF,
                             rows.shape[:-1])
    out = torch.zeros(rows.shape[:-1], dtype=torch.int64, device=dev)
    for j in range(32):
        out = torch.where((idx >> j) & 1 == 1, out ^ rows[..., j], out)
    return out


def sobol_1d(dim, index, scramble=None):
    """float32 in [0, 1]: scrambled Sobol' value (XOR digit scrambling)."""
    bits = sobol_bits(dim, index)
    if scramble is not None:
        bits = bits ^ scramble
    return bits.to(torch.float32) * (1.0 / 4294967296.0)
