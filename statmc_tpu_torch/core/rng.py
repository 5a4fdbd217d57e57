"""Counter-based per-(pixel, sample, bounce, slot) random streams.

Port of statmc_tpu/core/rng.py.  In random mode every draw is
addressed by coordinates and hashed with threefry2x32, bit-exact with
``jax.random`` under ``jax_threefry_partitionable=True`` (the JAX
package's setting): ``fold_in(key, d)`` is threefry(key, (0, d)), and
``uniform(key, shape)`` hashes the row-major element index as the
counter (0, i), xors the two output words and keeps the top 23 bits as
the mantissa of a float in [1, 2).

The low-discrepancy modes (``draw_1d``/``draw_2d`` with MODE_02,
MODE_HALTON, MODE_SOBOL) keep the draw-site addressing but replace the
hash by a scrambled (0,2)-sequence, a rotated radical inverse or a
scrambled Sobol' point; MODE_LOCKSTEP reads a table of the reference's
serial PCG32 draws (core/lockstep.py).  Every mode is bit-exact with
the JAX package's.

Keys are int64 tensors [..., 2] holding uint32 values.  The hashing of
every random-mode draw site, pixel key, fold_in and uniform is one call
of ``site_hash``: on CUDA tensors one launch of kernel R1
(csrc/threefry.cu, native uint32 arithmetic; counter ``kernel.R1``), on
CPU tensors its plain version ``site_hash_plain``, which emulates uint32
arithmetic in int64 masked to 32 bits.  Every ``draw_1d`` and ``draw_2d``
call runs in the span ``rng.draw`` (spans.py).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import cuda_build, spans
from . import math as cm

# Draw-site slot numbers (statmc_tpu/core/rng.py).
SLOT_CAMERA = 0
SLOT_LIGHT_SELECT = 1
SLOT_LIGHT_SAMPLE = 2
SLOT_BSDF_NEE = 3
SLOT_BSDF = 4
SLOT_RR = 5
SLOT_BSDF_COMPONENT = 6
SLOT_BSDF_COMPONENT_PC = 7
N_SLOTS = 8  # draw sites per bounce
# Media draw sites (volpath, render/volume.py).  They always draw
# threefry uniforms (uniform_1d/2d) in every sampler mode, LD modes
# included, and stay out of the LD and lockstep slot maps, as in the JAX
# package: delta and ratio tracking consume a variable number of draws.
SLOT_MEDIUM = 8  # 2D: channel select + distance (homogeneous.cpp:55-58)
SLOT_PHASE = 9  # 2D Henyey-Greenstein continuation direction
SLOT_PHASE_NEE = 10  # 2D phase half of EstimateDirect at a medium vertex
SLOT_TR = 11  # tracking-loop draws (the iteration index folded in)
# 2D exit-pupil sample (realistic camera).  Unlike the media and BSSRDF
# slots it follows the sampler mode (draw_2d), so the LD modes address it
# through N_SLOTS as the JAX package does; the lockstep table has no
# entry for it, and lockstep with a realistic camera raises KeyError
# there, as it does in the JAX package.
SLOT_LENS = 12
# BSSRDF draw sites (render/sss.py; statpath.cpp:892-926).  Like the
# media slots they always draw threefry uniforms and stay out of the LD
# and lockstep slot maps, as in the JAX package.
SLOT_SSS_AXIS = 13  # 1D axis/channel/chain selector (pbrt reuses u1)
SLOT_SSS_RADIUS = 14  # 2D profile radius + phi
SLOT_SSS_LIGHT_SELECT = 15  # 1D light pick at the exit vertex
SLOT_SSS_LIGHT = 16  # 2D light surface sample at the exit vertex
SLOT_SSS_NEE_BSDF = 17  # 2D Sw-lobe sample inside EstimateDirect
SLOT_SSS_SW = 18  # 2D Sw-lobe continuation sample

# Sampler modes (statmc_tpu/core/rng.py:171-201).
MODE_RANDOM = 0
MODE_02 = 1
MODE_HALTON = 2
MODE_LOCKSTEP = 3  # padded replay table of the reference's PCG32 streams
MODE_LOCKSTEP_EXACT = 4  # conditional-consumption replay (lockstep_exact)
MODE_SOBOL = 5

SAMPLER_MODES = {
    "random": MODE_RANDOM,
    "stratified": MODE_02,
    "02sequence": MODE_02,
    "zerotwosequence": MODE_02,
    "lowdiscrepancy": MODE_02,
    "sobol": MODE_SOBOL,
    "maxmindist": MODE_02,
    "halton": MODE_HALTON,
    "lockstep": MODE_LOCKSTEP,
}

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


def site_hash_plain(key, words=(), shape=None):
    """Kernel R1's plain version (csrc/threefry.cu): each of `words` (a
    Python int or an int tensor broadcastable against key[..., 0]) folded
    into the keys `key` [..., 2] in turn, as jax.random.fold_in: key =
    threefry(key, (0, word)).  With shape None, the folded keys [..., 2];
    else jax.random.uniform(k, shape) of each folded key k: the row-major
    element index hashed as the counter (0, i), the two output words
    xored, the top 23 bits the mantissa of a float in [1, 2), less 1,
    batch + shape."""
    for w in words:
        if torch.is_tensor(w):
            w = w.to(torch.int64)
        a, b = threefry2x32(key[..., 0], key[..., 1], 0, w)
        key = torch.stack([a, b], dim=-1)
    if shape is None:
        return key
    n = 1
    for s in shape:
        n *= int(s)
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., None, 0], key[..., None, 1], 0, counts)
    f = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0).reshape(key.shape[:-1]
                                                 + tuple(shape))


class _R1Word(ctypes.Structure):
    """struct Word of csrc/threefry.cu."""
    _fields_ = [("ptr", ctypes.c_void_p), ("div", ctypes.c_longlong),
                ("mod", ctypes.c_longlong), ("is64", ctypes.c_int),
                ("value", ctypes.c_uint)]


class _R1Args(ctypes.Structure):
    """struct Args of csrc/threefry.cu."""
    _fields_ = [("key", ctypes.c_void_p), ("key_div", ctypes.c_longlong),
                ("key_mod", ctypes.c_longlong), ("w", _R1Word * 2),
                ("n_words", ctypes.c_int), ("n_lanes", ctypes.c_longlong),
                ("n_ctr", ctypes.c_longlong), ("key_out", ctypes.c_void_p),
                ("u_out", ctypes.c_void_p)]


def _broadcast(shapes):
    """torch.broadcast_shapes of a few shapes, at a fraction of its host
    time."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, n in enumerate(s, nd - len(s)):
            if n != 1:
                if out[i] != 1 and out[i] != n:
                    raise ValueError(f"site_hash: shapes {shapes} do not "
                                     "broadcast")
                out[i] = n
    return tuple(out)


def _rows(x, batch, inner: int, lanes: int):
    """(x', div, mod): lane l of the row-major `batch` (`lanes` in all)
    reads row (l // div) % mod of x' (rows of `inner` elements, contiguous
    from x'.data_ptr()), where x [..., inner] (or [...] for inner 1)
    broadcasts to `batch`.  Broadcast dimensions are indexed, not copied,
    as long as x's other dimensions form one contiguous block; else x' is
    the broadcast x made contiguous (div 1, mod the lanes)."""
    if (x.shape[:-1] if inner > 1 else x.shape) == batch:
        if x.is_contiguous():
            return x, 1, lanes
    x = x.expand(*batch, inner) if inner > 1 else x.expand(batch)
    live = [i for i, n in enumerate(batch) if n != 1 and x.stride(i) != 0]
    if not live:
        return x, 1, 1
    ok = inner == 1 or x.stride(-1) == 1
    step = inner
    for i in range(live[-1], live[0] - 1, -1):
        if batch[i] != 1:
            ok = ok and x.stride(i) == step
            step *= batch[i]
    if not ok:
        return x.contiguous(), 1, lanes
    return x, math.prod(batch[live[-1] + 1:]), step // inner


def site_hash(key, words=(), shape=None):
    """Kernel R1 wrapper: same contract as `site_hash_plain`, which CPU
    tensors take; CUDA tensors launch the kernel (one launch a call, on
    the current stream), and the counter kernel.R1 (spans.py) counts the
    launches.  A tensor word is int32 or int64 on the key's device (other
    integer types are converted; a 0-d tensor elsewhere is read as an
    int); broadcast keys and words are read in place, not expanded."""
    if not key.is_cuda:
        return site_hash_plain(key, words, shape)
    if len(words) > 2:
        raise ValueError(f"site_hash: at most 2 fold words, got {len(words)}")
    dev = key.device
    if key.dtype != torch.int64:
        key = key.to(torch.int64)
    args = _R1Args(n_words=len(words))
    shapes = [key.shape[:-1]]
    tensors = [None] * len(words)
    for i, w in enumerate(words):
        if torch.is_tensor(w) and w.device != dev and w.dim() == 0:
            w = int(w)
        if not torch.is_tensor(w):
            args.w[i].value = int(w) & _MASK
            continue
        if w.device != dev:
            raise ValueError(f"site_hash: word {i} on {w.device}, the keys "
                             f"on {dev}")
        if w.dtype != torch.int32 and w.dtype != torch.int64:
            w = w.to(torch.int64)
        tensors[i] = w
        shapes.append(w.shape)
    batch = _broadcast(shapes)
    lanes = math.prod(batch)
    n = None if shape is None else math.prod(shape)
    out = torch.empty((*batch, 2 if n is None else n),
                      dtype=torch.int64 if n is None else torch.float32,
                      device=dev)
    if out.numel() > 0:
        key, args.key_div, args.key_mod = _rows(key, batch, 2, lanes)
        args.key = key.data_ptr()
        for i, w in enumerate(tensors):
            if w is not None:  # kept in `tensors` until the launch
                tensors[i], args.w[i].div, args.w[i].mod = _rows(
                    w, batch, 1, lanes)
                args.w[i].ptr = tensors[i].data_ptr()
                args.w[i].is64 = tensors[i].dtype == torch.int64
        args.n_lanes = lanes
        if n is None:
            args.key_out = out.data_ptr()
        else:
            args.n_ctr = n
            args.u_out = out.data_ptr()
        rc = cuda_build.library().statmc_threefry(
            ctypes.addressof(args), torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(rc, "statmc_threefry")
        spans.count("kernel.R1", 1)
    return out if n is None else out.reshape(*batch, *shape)


def fold_in(key, data):
    """jax.random.fold_in: key [..., 2], data int tensor broadcastable to
    key[..., 0] (or a Python int)."""
    return site_hash(key, (data,))


def uniform(key, shape):
    """jax.random.uniform(k, shape) for every key k of `key` [..., 2]:
    returns key.shape[:-1] + shape in [0, 1)."""
    return site_hash(key, (), tuple(shape))


def base_key(base_seed: int, device=None):
    """Root key: jax.random.PRNGKey(uint32(seed)) = (0, seed)."""
    return torch.tensor([0, int(base_seed) & _MASK], dtype=torch.int64,
                        device=device)


def pixel_keys(key, pixel_ids, sample_index):
    """Per-pixel keys [P, 2] for one sample index (scalar or [P]) under
    the root key `key` [2]: fold_in(fold_in(key, sample), pixel)."""
    return site_hash(key, (sample_index, pixel_ids))


def _site_keys(keys, bounce, slot: int):
    """Fold (bounce, slot) into per-lane keys; bounce scalar or [P]."""
    return site_hash(keys, (bounce, slot))


def uniform_1d(keys, bounce, slot: int):
    """One uniform in [0,1) per lane key (keys [P, 2]): the random-mode
    draw site draw_1d of statmc_tpu/core/rng.py."""
    return site_hash(keys, (bounce, slot), ())


def uniform_2d(keys, bounce, slot: int):
    """[P, 2] uniforms (counters 0 and 1 under each lane's site key): the
    random-mode draw site draw_2d of statmc_tpu/core/rng.py."""
    return site_hash(keys, (bounce, slot), (2,))


# ---------------------------------------------------------------------------
# Low-discrepancy streams (statmc_tpu/core/rng.py:100-356).
# ---------------------------------------------------------------------------

_INV_2_32 = 1.0 / 4294967296.0


def _vdc_bits(n):
    """Bit-reversed 32-bit integers (van der Corput), n int64 of uint32."""
    n = ((n << 16) | (n >> 16)) & _MASK
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    return ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)


def _sobol2_bits(n):
    """Second Sobol' dimension (direction numbers v, v ^= v >> 1)."""
    result = torch.zeros_like(n)
    v = 1 << 31
    for _ in range(32):
        result = torch.where((n & 1) == 1, result ^ v, result)
        n = n >> 1
        v ^= v >> 1
    return result


def _u32(x):
    """An index (int tensor or Python int) as int64 holding uint32."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def _unit(bits):
    """uint32 bits -> float32 in [0, 1]: rounded to float32, times 2^-32."""
    return bits.to(torch.float32) * _INV_2_32


def pixel_scramble(key, pixel_ids):
    """Per-pixel scramble words [P, 2], independent of the sample index."""
    return fold_in(key, pixel_ids)


def ld_camera_jitter(keys, sample_index):
    """[P,2] (0,2)-sequence film jitter, per-pixel scrambled."""
    s0, s1 = keys[:, 0], keys[:, 1]
    n = torch.broadcast_to(torch.as_tensor(_u32(sample_index),
                                           device=keys.device), s0.shape)
    return torch.stack([_unit(_vdc_bits(n) ^ s0),
                        _unit(_sobol2_bits(n) ^ s1)], dim=-1)


def _primes(n: int):
    import numpy as np

    sieve = np.ones(20000, bool)
    sieve[:2] = False
    for i in range(2, 142):
        if sieve[i]:
            sieve[i * i:: i] = False
    return np.nonzero(sieve)[0][:n].astype(np.int32)


_PRIMES = {}  # device -> the first 1,100 primes, made once per device


def _primes_table(device):
    if device not in _PRIMES:
        _PRIMES[device] = torch.as_tensor(_primes(1100).astype("int64"),
                                          device=device)
    return _PRIMES[device]


def radical_inverse(base, n):
    """Radical inverse of n in `base` (int tensors, broadcast), float32 as
    the JAX package rounds it: rd * base + digit is one fused
    multiply-add in XLA's compiled CPU code."""
    base, n = torch.broadcast_tensors(base.to(torch.int64), n.to(torch.int64))
    base_f = base.to(torch.float32)
    rd = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    inv = torch.ones(n.shape, dtype=torch.float32, device=n.device)
    for _ in range(32):
        nxt = torch.div(n, base, rounding_mode="floor")
        digit = n - nxt * base
        live = n > 0
        rd = torch.where(live, cm.fma(rd, base_f, digit.to(torch.float32)),
                         rd)
        inv = torch.where(live, inv / base_f, inv)
        n = nxt
    return rd * inv


def _ld_fold(scramble_keys, bounce, slot: int):
    return _site_keys(scramble_keys, bounce, slot)


# Lockstep table layout (core/lockstep.py): 5 camera dims, then 8 per
# bounce; the BxDF component choice reuses x of the 2D sample it remaps
# (pbrt's BSDF::Sample_f).
_LOCKSTEP_POS = {
    SLOT_CAMERA: (0, 1),
    SLOT_LIGHT_SELECT: (5 + 0,),
    SLOT_LIGHT_SAMPLE: (5 + 1, 5 + 2),
    SLOT_BSDF_COMPONENT: (5 + 3,),
    SLOT_BSDF_NEE: (5 + 3, 5 + 4),
    SLOT_BSDF_COMPONENT_PC: (5 + 5,),
    SLOT_BSDF: (5 + 5, 5 + 6),
    SLOT_RR: (5 + 7,),
}


def _lockstep_draw(ld, bounce, slot: int) -> list:
    """Values for (bounce, slot) from a lockstep table: ld = (tab
    [P,S,D], n), n and bounce scalar or [P]."""
    tab, n = ld
    P, S, D = tab.shape
    dev = tab.device
    nn = torch.clamp(torch.broadcast_to(
        torch.as_tensor(n, device=dev).to(torch.int64), (P,)), 0, S - 1)
    row = torch.gather(tab, 1, nn[:, None, None].expand(P, 1, D))[:, 0]
    if slot == SLOT_CAMERA:
        offs = torch.zeros((P,), dtype=torch.int64, device=dev)
    else:
        offs = 8 * torch.broadcast_to(
            torch.as_tensor(bounce, device=dev).to(torch.int64), (P,))
    return [torch.gather(row, 1, torch.clamp(offs + pos, 0, D - 1)[:, None])
            [:, 0] for pos in _LOCKSTEP_POS[slot]]


def _halton(words, n, bounce, slot: int, k: int, cap: int):
    """Rotated radical inverse of dimension 2 (bounce N_SLOTS + slot) + k,
    the dimension capped at `cap` (the JAX package caps a 1D draw's at
    1099, a 2D draw's at 1098 and 1099)."""
    dev = words.device
    dim = 2 * (torch.as_tensor(bounce, device=dev).to(torch.int64) * N_SLOTS
               + slot) + k
    # take, not [], so that a 0-d index is not read back to the host.
    base = torch.take(_primes_table(dev), torch.clamp(dim, max=cap))
    h = radical_inverse(base, torch.as_tensor(n, device=dev))
    return torch.remainder(h + _unit(words[:, k]), 1.0)


def _ld_draw(words, mode: int, n, bounce, slot: int, k: int,
             cap: int = 1099):
    """Component k (0 or 1) of an LD draw at (bounce, slot)."""
    if mode == MODE_HALTON:
        return _halton(words, n, bounce, slot, k, cap)
    dev = words.device
    nn = torch.broadcast_to(torch.as_tensor(_u32(n), device=dev),
                            words[:, 0].shape)
    if mode == MODE_02:
        bits = _vdc_bits(nn) if k == 0 else _sobol2_bits(nn)
        return _unit(bits ^ words[:, k])
    from . import sobol as sbl

    dim = 2 * (torch.as_tensor(bounce, device=dev).to(torch.int64) * N_SLOTS
               + slot) + k
    return sbl.sobol_1d(torch.broadcast_to(dim, nn.shape), nn, words[:, k])


@spans.spanned("rng.draw")
def draw_1d(keys, ld, mode: int, bounce, slot: int):
    """One uniform per lane at draw site (bounce, slot) under `mode`;
    ld = (scramble keys [P,2], sample index), a lockstep (table, index),
    or None (random)."""
    if mode == MODE_LOCKSTEP and ld is not None:
        return _lockstep_draw(ld, bounce, slot)[0]
    if mode == MODE_RANDOM or ld is None:
        return uniform_1d(keys, bounce, slot)
    scr, n = ld
    return _ld_draw(_ld_fold(scr, bounce, slot), mode, n, bounce, slot, 0)


@spans.spanned("rng.draw")
def draw_2d(keys, ld, mode: int, bounce, slot: int):
    """[P,2] uniforms at draw site (bounce, slot) under `mode`."""
    if mode == MODE_LOCKSTEP and ld is not None:
        return torch.stack(_lockstep_draw(ld, bounce, slot), dim=-1)
    if mode == MODE_RANDOM or ld is None:
        return uniform_2d(keys, bounce, slot)
    scr, n = ld
    words = _ld_fold(scr, bounce, slot)
    return torch.stack([_ld_draw(words, mode, n, bounce, slot, k, 1098 + k)
                        for k in (0, 1)], dim=-1)


# ---------------------------------------------------------------------------
# jax.random's split / uniform(minval, maxval) / normal / categorical, as
# MLT (render/pssmlt.py) draws them, with the float32 math of XLA's CPU
# code: its log and log1p (the Cephes forms it emits, products contracted
# into FMAs) and the erf_inv polynomial of the CHLO lowering.  Bit-exact
# with jax.random on the draws tests/test_torch_mlt.py checks.
# ---------------------------------------------------------------------------

def split(key, n: int):
    """jax.random.split(key, n) under threefry_partitionable: [n, 2], key
    i = threefry(key, (0, i)), which is fold_in(key, i)."""
    return fold_in(key.expand(n, 2),
                   torch.arange(n, dtype=torch.int64, device=key.device))


def uniform_range(key, shape, minval: float, maxval: float):
    """jax.random.uniform(key, shape, minval=, maxval=) in float32:
    max(minval, u * (maxval - minval) + minval), the span rounded to
    float32 first."""
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, cm.fma(uniform(key, shape), span, lo))


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def xla_log(x):
    """float32 log as XLA's CPU code computes it (the Cephes frexp form
    with its degree-8 polynomial) for x > 0."""
    fma = cm.fma
    tiny = float(torch.finfo(torch.float32).tiny)
    bits = torch.clamp(x, min=tiny).view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < 0.70710678118654752
    t = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.to(torch.float32)
    x2 = t * t
    x3 = x2 * t
    c = [_f32(v, x) for v in _LOG_P]
    y = fma(fma(t, c[0], c[1]), t, c[2])
    y1 = fma(fma(t, c[3], c[4]), t, c[5])
    y2 = fma(fma(t, c[6], c[7]), t, c[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, _f32(-2.12194440e-4, x) * e)
    t = fma(_f32(-0.5, x), x2, t) + y
    return fma(_f32(0.693359375, x), e, t)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(x, coeffs):
    p = torch.zeros_like(x)
    for v in coeffs:
        p = cm.fma(p, x, _f32(v, x))
    return p


def xla_log1p(x):
    """float32 log1p as XLA's CPU code computes it: a Cephes rational
    form below |x| = sqrt(2) - 1, xla_log(1 + x) above."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + cm.fma(_f32(-0.5, x), x2, small)
    return torch.where(torch.abs(x) < 0.41421356237309504880, small,
                       xla_log(x + 1.0))


# erf_inv's polynomial (Giles), below and above w = 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x):
    """float32 erf^-1 on (-1, 1), as JAX's erf_inv lowers for float32."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, cm.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, _f32(a, x), _f32(b, x))
        p = c if p is None else cm.fma(p, w, c)
    return p * x


NORMAL_LO = -0.99999994  # nextafter(-1, 0) in float32


def normal(key, shape):
    """jax.random.normal(key, shape): sqrt(2) erf^-1(u), u uniform on
    (nextafter(-1, 0), 1)."""
    u = uniform_range(key, shape, NORMAL_LO, 1.0)
    return _f32(1.4142135623730951, u) * erf_inv(u)


def categorical(key, logits, n: int, rows: int = 256):
    """jax.random.categorical(key, logits [K], shape=(n,)): argmax over K
    of logits + Gumbel noise -log(-log(u)), u uniform on [tiny, 1), the
    noise of draw i at counters i K ... i K + K - 1.  Made `rows` draws at
    a time, so the [n, K] noise never exists whole."""
    K = logits.shape[0]
    tiny = float(torch.finfo(torch.float32).tiny)
    out = []
    for a in range(0, n, rows):
        b = min(a + rows, n)
        counts = torch.arange(a * K, b * K, dtype=torch.int64,
                              device=key.device)
        x1, x2 = threefry2x32(key[0], key[1], 0, counts)
        f = (((x1 ^ x2) >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
        u = torch.maximum(_f32(tiny, f), f + tiny)
        g = -xla_log(-xla_log(u))
        out.append(torch.argmax((g.reshape(b - a, K) + logits[None]), -1))
    return torch.cat(out)
