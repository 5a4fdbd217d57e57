"""Kernel B2's plain PyTorch version and the port's StatDenoiser against
the JAX package's filter: the Pallas kernel in interpret mode and the XLA
reference stat_filter, at 24x40, r = 3 (as tests/test_pallas_filter.py),
rtol 1e-5 / atol 1e-6.  The three sum the same window with different
groupings of the exponent (one exp of the sum, the Pallas quadratic
expansion, a product of two exps), so they agree to rounding only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statmc_tpu.denoise.filter_jax import StatDenoiser as JDenoiser
from statmc_tpu.denoise.filter_jax import corrected_stats as j_corrected
from statmc_tpu.denoise.filter_jax import stat_filter as j_stat_filter
from statmc_tpu.denoise.filter_pallas import _run_filter
from statmc_tpu.denoise.ttest import quantile_table
from statmc_tpu.scene.params import ParamSet
from statmc_tpu.stats import estimator as JE
from statmc_tpu_torch import convert
from statmc_tpu_torch.denoise import filter as TFL
from statmc_tpu_torch.denoise import filter_cuda as FC
from statmc_tpu_torch.stats import estimator as TE

torch.set_num_threads(2)


def _fields(seed=0, H=24, W=40, C=3, N=16):
    rng = np.random.default_rng(seed)
    xs = rng.gamma(4.0, 0.25, size=(N, H, W, C)).astype(np.float32)
    ys = 2.0 * (np.sqrt(xs) - 1.0)
    n = np.full((H, W), N, np.float32)
    mean = ys.mean(0)
    d = ys - mean
    m2 = (d ** 2).sum(0)
    m3 = (d ** 3).sum(0)
    fm = xs.mean(0)
    gb = rng.random((H, W, 3)).astype(np.float32)
    return n, mean, m2, m3, fm, gb


@pytest.mark.parametrize("normalize", [True, False])
def test_plain_b2_matches_pallas_interpret(normalize):
    n, mean, m2, m3, fm, gb = _fields()
    H, W, _ = mean.shape
    tq = quantile_table(0.005)
    mc, disc = j_corrected(jnp.asarray(n), jnp.asarray(mean),
                           jnp.asarray(m2), jnp.asarray(m3), jnp.asarray(tq))
    gf = tuple([-0.5 / 0.1 ** 2] * 3)
    ref, wref = _run_filter(mc, disc * disc, jnp.asarray(fm), jnp.asarray(gb),
                            jnp.ones((H, W)), 3, -0.5 / 2.0 ** 2, gf,
                            normalize=normalize, th=8, interpret=True)
    mc_t, disc_t = TFL.corrected_stats(
        torch.as_tensor(n), torch.as_tensor(mean), torch.as_tensor(m2),
        torch.as_tensor(m3), torch.as_tensor(tq))
    np.testing.assert_allclose(mc_t.numpy(), np.asarray(mc), rtol=1e-6)
    np.testing.assert_allclose(disc_t.numpy(), np.asarray(disc), rtol=1e-6)
    out, wsum = FC.run_filter(
        mc_t, disc_t * disc_t, torch.as_tensor(fm), torch.as_tensor(gb),
        torch.ones((H, W)), 3, -0.5 / 2.0 ** 2, gf, normalize=normalize)
    # The Pallas kernel evaluates the range exponent in its quadratic
    # expansion, whose terms reach |gf| * 3 = 150 here, so its unnormalized
    # sums carry ~150 * 2^-24 ~ 1e-5 relative error; the normalized output
    # cancels it.  Hence rtol 1e-5 normalized, 5e-5 for raw sums.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5 if normalize else 5e-5, atol=1e-6)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(wref), rtol=5e-5,
                               atol=1e-6)
    assert float(wsum.min()) >= 1.0 - 1e-5


def test_stat_filter_matches_xla_reference():
    n, mean, m2, m3, fm, gb = _fields(seed=3)
    tq = quantile_table(0.005)
    film = np.random.default_rng(4).random(fm.shape).astype(np.float32)
    ref = j_stat_filter(
        jnp.asarray(n), jnp.asarray(mean), jnp.asarray(m2), jnp.asarray(m3),
        jnp.asarray(fm), jnp.asarray(gb)[None], jnp.asarray([-0.5 / 0.1 ** 2]),
        jnp.asarray(-0.5 / 2.0 ** 2), jnp.asarray(tq), 3,
        film_img=jnp.asarray(film))
    res = TFL.stat_filter(
        torch.as_tensor(n), torch.as_tensor(mean), torch.as_tensor(m2),
        torch.as_tensor(m3), torch.as_tensor(fm), torch.as_tensor(gb),
        (-0.5 / 0.1 ** 2,) * 3, -0.5 / 2.0 ** 2, torch.as_tensor(tq), 3,
        film_img=torch.as_tensor(film))
    for k in ("mean_corr", "discriminator", "film_mean_f", "film_f"):
        np.testing.assert_allclose(res[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_stat_denoiser_matches_jax_on_the_same_states():
    """StatDenoiser end to end (G-buffers, corrected stats, film-f
    alias) against the JAX StatDenoiser(impl="jax") on one state dict."""
    W, H, P = 20, 12, 240
    p = ParamSet()
    for decl, v in (("bool denoiseimage", [True]), ("bool calcstats", [True]),
                    ("integer filterradius", [2]), ("float filtersd", [3.0])):
        p.add(decl, v)
    jc, tc = JE.derive_config(p, ParamSet(), 4), TE.derive_config(
        p, ParamSet(), 4)
    rng = np.random.default_rng(11)
    states = JE.make_states(jc, P)
    states = {t: {k: jnp.asarray((rng.gamma(2.0, 0.3, np.shape(v)) + (
        4.0 if k == "n" else 0.0)).astype(np.float32))
        for k, v in st.items()} for t, st in states.items()}
    film = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    jd = JDenoiser(jc, W, H, impl="jax")
    jg = jd._gbuffers(states)
    jres = jd(states[JE.RADIANCE], jc.configs[JE.RADIANCE], film, W, H,
              gbufs=jg)
    td = TFL.StatDenoiser(tc, W, H)
    ts = convert.moment_states(states)
    tres = td(ts[TE.RADIANCE], torch.as_tensor(np.asarray(film)),
              td._gbuffers(ts))
    for k in ("mean_corr", "discriminator", "film_mean_f", "film_f"):
        np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
