"""The port's sampler modes against the JAX package's (core/rng.py,
core/sobol.py): every low-discrepancy and lockstep draw bit for bit, and
24x16 staircase renders under halton, sobol and 02sequence at the
slice's rule (tests/test_torch_slice.py: exact counts and ray totals,
rtol 1e-4 on 98.5% of the pixels of every buffer; measured 98.96-100%).

radical_inverse rounds rd * base + digit once: XLA's compiled CPU code
contracts it into a fused multiply-add, and without the fused form 631
of 4,096 random (base, n) pairs differ in the last bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.core import lockstep as JLS
from statmc_tpu.core import rng as J
from statmc_tpu.core import sobol as JS
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch.core import rng as T
from statmc_tpu_torch.core import sobol as TS
from statmc_tpu_torch.testscenes import scene_text

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.array(x).astype(np.int64))


def _i(x):
    """An index (int or array) as the port takes it."""
    return x if isinstance(x, int) else torch.as_tensor(np.array(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_ld_primitives_bit_exact():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2 ** 32, 2048, dtype=np.uint64).astype(np.uint32)
    u[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    for jf, tf in ((J._vdc_bits, T._vdc_bits),
                   (J._sobol2_bits, T._sobol2_bits)):
        np.testing.assert_array_equal(
            np.asarray(jax.jit(jf)(jnp.asarray(u))).astype(np.int64),
            tf(_t(u)).numpy())
    n = rng.integers(0, 2 ** 31 - 1, 2048).astype(np.int32)
    n[:6] = [0, 1, 2, 1023, 1024, 2 ** 31 - 1]
    base = rng.choice(J._primes(1100), 2048).astype(np.int32)
    np.testing.assert_array_equal(
        _bits(jax.jit(J.radical_inverse)(jnp.asarray(base), jnp.asarray(n))),
        _bits(T.radical_inverse(_t(base), _t(n))))
    np.testing.assert_array_equal(J._primes(1100), T._primes(1100))
    np.testing.assert_array_equal(JS.matrices(), TS.matrices())
    dim = rng.integers(-3, 170, 2048).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(JS.sobol_bits)(jnp.asarray(dim),
                                          jnp.asarray(u))).astype(np.int64),
        TS.sobol_bits(_t(dim), _t(u)).numpy())
    pid = jnp.arange(0, 4000, 13, dtype=jnp.int32)
    for seed in (0, 9):
        np.testing.assert_array_equal(
            np.asarray(J.pixel_scramble(J.base_key(seed), pid)).astype(
                np.int64),
            T.pixel_scramble(T.base_key(seed), _t(pid)).numpy())
    keys = J.pixel_keys(J.base_key(4), pid, 0)
    for s in (0, 7, 1 << 20):
        np.testing.assert_array_equal(
            _bits(J.ld_camera_jitter(keys, s)),
            _bits(T.ld_camera_jitter(_t(keys), s)))


@pytest.mark.parametrize("mode", ["02sequence", "halton", "sobol"])
def test_ld_draws_bit_exact(mode):
    """draw_1d / draw_2d at every slot, per-lane sample indices and per-lane
    bounces up to 79 (past the Halton dimension caps at 1098/1099 and the
    Sobol' table's 160 dimensions), and scalar ones at two slots."""
    m = J.SAMPLER_MODES[mode]
    assert T.SAMPLER_MODES[mode] == m
    rng = np.random.default_rng(m)
    P = 256
    pid = jnp.arange(P, dtype=jnp.int32)
    keys = J.pixel_keys(J.base_key(3), pid, 0)
    scr = J.pixel_scramble(J.base_key(3), pid)
    kt, st = _t(keys), _t(scr)
    sidx = rng.integers(0, 5000, P).astype(np.int32)
    bounce = rng.integers(0, 80, P).astype(np.int32)
    cases = [(jnp.asarray(sidx), jnp.asarray(bounce), range(J.N_SLOTS)),
             (5, 72, (J.SLOT_CAMERA, J.SLOT_RR))]
    for s, b, slots in cases:
        s_t, b_t = _i(s), _i(b)
        for slot in slots:
            np.testing.assert_array_equal(
                _bits(J.draw_1d(keys, (scr, s), m, b, slot)),
                _bits(T.draw_1d(kt, (st, s_t), m, b_t, slot)),
                err_msg=f"1d slot {slot}")
            np.testing.assert_array_equal(
                _bits(J.draw_2d(keys, (scr, s), m, b, slot)),
                _bits(T.draw_2d(kt, (st, s_t), m, b_t, slot)),
                err_msg=f"2d slot {slot}")


def test_lockstep_draws_bit_exact():
    """MODE_LOCKSTEP reads the padded PCG32 table by (sample, bounce,
    slot); out-of-range samples and bounces clamp."""
    W, H, S, n_steps = 20, 3, 3, 4
    tab = JLS.make_table(W, H, S, n_steps, base_seed=2)
    P = W * H
    rng = np.random.default_rng(1)
    sidx = rng.integers(0, S + 2, P).astype(np.int32)
    bounce = rng.integers(0, n_steps + 2, P).astype(np.int32)
    keys = J.pixel_keys(J.base_key(0), jnp.arange(P, dtype=jnp.int32), 0)
    tt = torch.as_tensor(tab)
    for s, b in ((jnp.asarray(sidx), jnp.asarray(bounce)), (1, 2)):
        s_t, b_t = _i(s), _i(b)
        for slot in range(J.N_SLOTS):
            ld_j, ld_t = (jnp.asarray(tab), s), (tt, s_t)
            np.testing.assert_array_equal(
                _bits(J.draw_1d(keys, ld_j, J.MODE_LOCKSTEP, b, slot)),
                _bits(T.draw_1d(_t(keys), ld_t, T.MODE_LOCKSTEP, b_t, slot)))
            if len(J._LOCKSTEP_POS[slot]) == 2:  # the 2D draw sites
                np.testing.assert_array_equal(
                    _bits(J.draw_2d(keys, ld_j, J.MODE_LOCKSTEP, b, slot)),
                    _bits(T.draw_2d(_t(keys), ld_t, T.MODE_LOCKSTEP, b_t,
                                    slot)))


@pytest.mark.parametrize("sampler", ["halton", "sobol", "02sequence"])
def test_ld_render_matches_jax(sampler, tmp_path):
    """load(...).render() in both packages on a 24x16 staircase proxy
    under an LD sampler, held to the slice's rule."""
    text = scene_text(width=24, height=16, spp=2, iterations=2, maxdepth=4,
                      denoise=True, filterradius=2)
    assert 'Sampler "random"' in text
    path = tmp_path / "scene.pbrt"
    path.write_text(text.replace('Sampler "random"', f'Sampler "{sampler}"'))
    rj, rt = JD.load(str(path)), TD.load(str(path), device="cpu")
    assert rt.s.icfg.sampler_mode == T.SAMPLER_MODES[sampler]
    lj = rj.render(verbose=False)
    lt = rt.render(verbose=False)
    assert [x["rays_total"] for x in lj] == [x["rays_total"] for x in lt]
    bj, bt = rj.buffers(), rt.buffers()
    assert bj.keys() == bt.keys()
    for k in bj:
        a, b = np.asarray(bj[k]), np.asarray(bt[k])
        if k.endswith("-n"):
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        close = np.isclose(b, a, rtol=1e-4, atol=1e-6)
        close = close.all(-1) if close.ndim == 3 else close
        assert close.mean() >= 0.985, (k, close.mean())
