"""Counter-based per-(pixel, sample, bounce, slot) random streams.

Port of statmc_tpu/core/rng.py, random mode only.  Every draw is
addressed by coordinates and hashed with threefry2x32, bit-exact with
``jax.random`` under ``jax_threefry_partitionable=True`` (the JAX
package's setting): ``fold_in(key, d)`` is threefry(key, (0, d)), and
``uniform(key, shape)`` hashes the row-major element index as the
counter (0, i), xors the two output words and keeps the top 23 bits as
the mantissa of a float in [1, 2).

uint32 arithmetic is emulated in int64 and masked to 32 bits, so keys
are int64 tensors [..., 2] holding uint32 values.
"""
from __future__ import annotations

import torch

# Draw-site slot numbers (statmc_tpu/core/rng.py).
SLOT_CAMERA = 0
SLOT_LIGHT_SELECT = 1
SLOT_LIGHT_SAMPLE = 2
SLOT_BSDF_NEE = 3
SLOT_BSDF = 4
SLOT_RR = 5
SLOT_BSDF_COMPONENT = 6
SLOT_BSDF_COMPONENT_PC = 7

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (jax/_src/prng.py:_threefry2x32_lowering).
    All arguments int64 tensors of uint32 values, broadcastable."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def fold_in(key, data):
    """jax.random.fold_in: key [..., 2], data int tensor broadcastable to
    key[..., 0] (or a Python int)."""
    a, b = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([a, b], dim=-1)


def uniform(key, shape):
    """jax.random.uniform(k, shape) for every key k of `key` [..., 2]:
    returns key.shape[:-1] + shape in [0, 1)."""
    n = 1
    for s in shape:
        n *= int(s)
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., None, 0], key[..., None, 1], 0, counts)
    f = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0).reshape(key.shape[:-1]
                                                 + tuple(shape))


def base_key(base_seed: int, device=None):
    """Root key: jax.random.PRNGKey(uint32(seed)) = (0, seed)."""
    return torch.tensor([0, int(base_seed) & _MASK], dtype=torch.int64,
                        device=device)


def pixel_keys(key, pixel_ids, sample_index):
    """Per-pixel keys for one sample index (scalar or [P])."""
    pid = pixel_ids.to(torch.int64)
    if not torch.is_tensor(sample_index) or sample_index.dim() == 0:
        k = fold_in(key, int(sample_index))
        return fold_in(k.expand(pid.shape[0], 2), pid)
    s = sample_index.to(torch.int64)
    return fold_in(fold_in(key.expand(pid.shape[0], 2), s), pid)


def _site_keys(keys, bounce, slot: int):
    """Fold (bounce, slot) into per-lane keys; bounce scalar or [P]."""
    b = bounce.to(torch.int64) if torch.is_tensor(bounce) else int(bounce)
    return fold_in(fold_in(keys, b), slot)


def uniform_1d(keys, bounce, slot: int):
    """One uniform in [0,1) per lane key (keys [P, 2]): the random-mode
    draw site draw_1d of statmc_tpu/core/rng.py."""
    return uniform(_site_keys(keys, bounce, slot), ())


def uniform_2d(keys, bounce, slot: int):
    """[P, 2] uniforms (counters 0 and 1 under each lane's site key): the
    random-mode draw site draw_2d of statmc_tpu/core/rng.py."""
    return uniform(_site_keys(keys, bounce, slot), (2,))
