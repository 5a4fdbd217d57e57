"""Kernel B2's five other forms (range_bf16, accept_expand, accept_bf16
and their pairs) and the denoiser options that reach them, against the
JAX package: the Pallas kernel `_run_filter` in interpret mode with the
same flags, and `StatDenoiser(alpha=, moon_ci=, range_bf16=)`, at 24x40,
r = 4, th = 8.  Each JAX run of a form is made once, in a module-scoped
fixture, and shared by the tests that read it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu_torch.driver as TD
from statmc_tpu.denoise.filter_jax import StatDenoiser as JDenoiser
from statmc_tpu.denoise.filter_jax import corrected_stats as j_corrected
from statmc_tpu.denoise.filter_pallas import _run_filter
from statmc_tpu.scene.params import ParamSet
from statmc_tpu.stats import estimator as JE
from statmc_tpu.testscenes import scene_text
from statmc_tpu_torch import convert
from statmc_tpu_torch.denoise import filter as TFL
from statmc_tpu_torch.denoise import filter_cuda as FC
from statmc_tpu_torch.stats import estimator as TE

torch.set_num_threads(2)

H, W, C, G, R = 24, 40, 3, 6, 4
FORMS = list(FC.FORMS)
NEW_FORMS = FORMS[1:]  # all but the f32 direct form
BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values


def _run_jax(args, radius, ds, gf, kw, normalize):
    out, wsum = _run_filter(*(jnp.asarray(a) for a in args), radius, ds, gf,
                            normalize=normalize, th=8, interpret=True, **kw)
    return np.asarray(out), np.asarray(wsum)


def _run_plain(args, radius, ds, gf, kw, normalize):
    out, wsum = FC.run_filter(*(torch.as_tensor(a) for a in args), radius,
                              ds, gf, normalize=normalize, **kw)
    return out.numpy(), wsum.numpy()


# -- the acceptance test's decisions, pair by pair -------------------------

SIDE = 2 * R + 1
WORD = 21  # bits of a pair's code in one float32 channel (sums stay exact)


def _decision_inputs():
    """Inputs whose tests sit at the acceptance boundary: mc is a
    checkerboard of two values a channel, so every neighbour differs by 0
    or by the same diff, and d2 = diff^2 / 2 a pixel, moved by 2^-6 to
    2^-20 relative (bf16's spacing down to float32's).  The G-buffer is 0
    and ds = 0, so every accepted pair weighs exactly 1 in every form;
    fm codes the neighbour's offset, (y mod 9) * 9 + (x mod 9), as a power
    of two in one of 4 channels, so that the unnormalized sums name the
    accepted neighbours of every pixel exactly.  A tenth of the pixels
    are invalid neighbours."""
    rng = np.random.default_rng(21)
    x, y = (rng.uniform(-2, 2, C).astype(np.float32) for _ in range(2))
    chk = ((np.arange(H)[:, None] + np.arange(W)[None]) % 2)[..., None]
    mc = np.where(chk == 1, y, x).astype(np.float32)
    half = (y.astype(np.float64) - x) ** 2 / 2
    rel = 2.0 ** -rng.uniform(6, 20, (H, W, C)) * rng.choice([-1, 1],
                                                              (H, W, C))
    d2 = (half * (1 + rel)).astype(np.float32)
    code = (np.arange(H)[:, None] % SIDE) * SIDE + np.arange(W)[None] % SIDE
    fm = np.zeros((H, W, 4), np.float32)
    for c in range(4):
        inside = code // WORD == c
        fm[..., c] = np.where(inside, 2.0 ** (code % WORD), 0.0)
    gb = np.zeros((H, W, G), np.float32)
    valid = (rng.random((H, W)) > 0.1).astype(np.float32)
    return mc, d2, fm, gb, valid


def _accepted(acc):
    """[H,W] Python ints: bit k set when the neighbour with code k was
    accepted (and valid)."""
    acc = acc.astype(np.int64)
    out = np.zeros(acc.shape[:2], object)
    for c in range(acc.shape[-1]):
        out = out + (acc[..., c] << (WORD * c)).astype(object)
    return out


def _pairs_differing(a, b):
    return sum(bin(int(u) ^ int(v)).count("1")
               for u, v in zip(a.ravel(), b.ravel()))


@pytest.fixture(scope="module")
def decisions():
    """{form: (JAX's accepted neighbours, the plain version's)} on the
    boundary inputs, one JAX run a form."""
    args = _decision_inputs()
    gf = (-50.0,) * G
    return {f: tuple(_accepted(run(args, R, 0.0, gf, kw, False)[0])
                     for run in (_run_jax, _run_plain))
            for f, kw in FC.FORMS.items()}


@pytest.mark.parametrize("form", FORMS)
def test_variant_decisions_match_jax(decisions, form):
    """The plain version accepts exactly the pairs that the JAX package's
    interpret-mode kernel accepts in each form: 0 pairs differ.  The
    expanded test must put its FMAs where XLA's CPU code contracts (A =
    fma(mc, mc, -d2), b = fma(-mc, mc, d2 + 1e-20), fma(-2 mc_i, mc_j,
    A_j)); the bf16 test must round every operation to bf16.  The inputs
    sit on the boundary: each new test decides otherwise than the f32
    direct one on some pairs, so a misplaced rounding shows."""
    jax_acc, port_acc = decisions[form]
    pairs = sum(bin(int(v)).count("1") for v in jax_acc.ravel())
    assert pairs > 0
    assert _pairs_differing(jax_acc, port_acc) == 0
    if form in ("accept_expand", "accept_bf16"):
        assert _pairs_differing(jax_acc, decisions["f32"][0]) > 0


@pytest.mark.parametrize("form", FORMS)
def test_form_of_names_each_form(form):
    """run_filter counts a launch under form_of(flags): each form's own
    flags name it, and accept_bf16 takes precedence over accept_expand,
    as in the kernel's entry point and the JAX package's kernel."""
    kw = FC.FORMS[form]
    assert FC.form_of(**kw) == form
    if kw.get("accept_bf16"):
        assert FC.form_of(accept_expand=True, **kw) == form


# -- the weights and sums --------------------------------------------------

def _quality_inputs():
    """tests/test_pallas_filter.py:96 test_range_bf16_quality's inputs."""
    rng = np.random.default_rng(5)

    def mk(c):
        return rng.random((H, W, c), np.float32)

    mc, d2, fm, gb = mk(C), mk(C) * np.float32(0.01), mk(C), mk(G)
    return mc, d2, fm, gb, np.ones((H, W), np.float32)


QUALITY = dict(radius=R, ds=-0.005, gf=(-0.5 / 0.1 ** 2,) * G)


@pytest.fixture(scope="module")
def weights():
    """{(form, normalize): (out, wsum)} of JAX's interpret-mode kernel on
    the quality inputs, one run a form and normalization."""
    args = _quality_inputs()
    return {(f, n): _run_jax(args, QUALITY["radius"], QUALITY["ds"],
                             QUALITY["gf"], kw, n)
            for f, kw in FC.FORMS.items() for n in (True, False)}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("form", NEW_FORMS)
def test_variant_matches_jax_interpret(weights, form, normalize):
    """The plain version of each form against the JAX package's kernel on
    the same inputs.  Both sum the same weights of the same accepted
    pairs (test_variant_decisions_match_jax), in another order.

    - f32 range forms: rtol 1e-5 normalized, 5e-5 for the raw sums, atol
      1e-6, as tests/test_torch_filter.py: the Pallas kernel's f32 range
      exponent is the quadratic expansion, whose terms reach 150 here.
    - bf16 range forms: the exponent is rounded at the same places on both
      sides, so only XLA's exp against PyTorch's can differ, by one bf16
      ulp of a weight after rounding: 2^-8 relative on the raw sums,
      twice that (2^-7) on the normalized output, where numerator and
      denominator both move; atol 1e-6 and rtol 1e-5 more for the f32
      sums' order."""
    args = _quality_inputs()
    kw = FC.FORMS[form]
    out, wsum = _run_plain(args, QUALITY["radius"], QUALITY["ds"],
                           QUALITY["gf"], kw, normalize)
    ref, wref = weights[(form, normalize)]
    if kw.get("range_bf16"):
        rtol = (2 * BF16_ULP if normalize else BF16_ULP) + 1e-5
        wtol = BF16_ULP + 1e-5
    else:
        rtol, wtol = (1e-5 if normalize else 5e-5), 5e-5
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(wsum, wref, rtol=wtol, atol=1e-6)


@pytest.mark.parametrize("form", NEW_FORMS)
def test_variant_quality_against_f32(weights, form):
    """After tests/test_pallas_filter.py:96 test_range_bf16_quality: each
    form's normalized output against the port's f32 form on its inputs,
    mean relative error < 2e-3 and all finite; the JAX package's own form
    against its own f32 output on the same inputs beside it."""
    args = _quality_inputs()
    kw = FC.FORMS[form]
    f32, _ = _run_plain(args, R, QUALITY["ds"], QUALITY["gf"], {}, True)
    var, _ = _run_plain(args, R, QUALITY["ds"], QUALITY["gf"], kw, True)

    def mean_rel(a, b):
        return float((np.abs(a - b) / (np.abs(b) + 1e-6)).mean())

    port = mean_rel(var, f32)
    jax_rel = mean_rel(weights[(form, True)][0], weights[("f32", True)][0])
    print(f"{form}: mean relative error against f32, port {port:.3e}, "
          f"JAX package {jax_rel:.3e}")
    assert np.isfinite(var).all()
    assert port < 2e-3


# -- the denoiser's options ------------------------------------------------

def _states(seed=11):
    """JAX and port estimator configs, a random moment state dict (n >= 4)
    and a film, at 20x12 with filter radius 2 and the albedo and normal
    G-buffers (tests/test_torch_filter.py's), whose means are 0.5 plus
    noise of 0.01 so that neighbours weigh more than 0 (sd 0.1 and 0.02)."""
    Wd, Hd, P = 20, 12, 240
    p = ParamSet()
    for decl, v in (("bool denoiseimage", [True]), ("bool calcstats", [True]),
                    ("integer filterradius", [2]), ("float filtersd", [3.0])):
        p.add(decl, v)
    jc, tc = JE.derive_config(p, ParamSet(), 4), TE.derive_config(
        p, ParamSet(), 4)
    rng = np.random.default_rng(seed)
    states = JE.make_states(jc, P)
    states = {t: {k: jnp.asarray((rng.gamma(2.0, 0.3, np.shape(v)) + (
        4.0 if k == "n" else 0.0)).astype(np.float32))
        for k, v in st.items()} for t, st in states.items()}
    for t in (JE.STAT_ALBEDO, JE.STAT_NORMAL):
        shape = np.shape(states[t]["mean"])
        states[t]["mean"] = jnp.asarray(
            (0.5 + 0.01 * rng.standard_normal(shape)).astype(np.float32))
    film = jnp.asarray(rng.random((Hd, Wd, 3)).astype(np.float32))
    return jc, tc, states, film, Wd, Hd


def _port_denoise(tc, states, film, Wd, Hd, **kw):
    td = TFL.StatDenoiser(tc, Wd, Hd, **kw)
    ts = convert.moment_states(states)
    return td, td(ts[TE.RADIANCE], torch.tensor(np.asarray(film)),
                  td._gbuffers(ts))


@pytest.mark.parametrize("kw", [dict(alpha=0.01), dict(moon_ci=True)],
                         ids=["alpha", "moon_ci"])
def test_denoiser_options_match_jax(kw):
    """StatDenoiser(alpha=0.01) and StatDenoiser(moon_ci=True) against the
    JAX package's StatDenoiser(impl="jax") with the same option on the
    same states: every output within rtol 1e-5 / atol 1e-6 (the filter's
    f32 form, tests/test_torch_filter.py).  moon_ci tests the film means,
    as the JAX package's stat_filter does; each option changes the
    result."""
    jc, tc, states, film, Wd, Hd = _states()
    jd = JDenoiser(jc, Wd, Hd, impl="jax", **kw)
    jres = jd(states[JE.RADIANCE], jc.configs[JE.RADIANCE], film, Wd, Hd,
              gbufs=jd._gbuffers(states))
    _, tres = _port_denoise(tc, states, film, Wd, Hd, **kw)
    _, plain = _port_denoise(tc, states, film, Wd, Hd)
    for k in ("mean_corr", "discriminator", "film_mean_f", "film_f"):
        np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    key = "mean_corr" if "moon_ci" in kw else "discriminator"
    assert not torch.equal(tres[key], plain[key])
    if "moon_ci" in kw:
        ts = convert.moment_states(states)[TE.RADIANCE]
        assert torch.equal(tres["mean_corr"], ts["film_mean"])


def test_denoiser_range_bf16_matches_jax():
    """StatDenoiser(range_bf16=True) against the JAX package's bf16 path,
    composed as its StatDenoiser._make_jit_bounce composes it
    (statmc_tpu/denoise/filter_jax.py:338-368: corrected_stats, then
    _run_filter(range_bf16=True) on the whole image) with interpret=True:
    film-mean-f of every bounce within the bf16 tolerance of
    test_variant_matches_jax_interpret (2^-7 + 1e-5 relative, atol 1e-6),
    mean-corr and the discriminator within rtol 1e-5."""
    jc, tc, states, film, Wd, Hd = _states()
    jd = JDenoiser(jc, Wd, Hd, impl="jax")
    _, _, gb_planes, gf_planes = jd._gbuffers(states)
    assert gb_planes.shape[-1] > 0
    st = states[JE.RADIANCE]
    _, tres = _port_denoise(tc, states, film, Wd, Hd, range_bf16=True)
    for j in range(st["n"].shape[0]):
        n = st["n"][j, :, 0].reshape(Hd, Wd)
        mean, m2, m3, fm = (st[k][j].reshape(Hd, Wd, 3)
                            for k in ("mean", "m2", "m3", "film_mean"))
        mc, disc = j_corrected(n, mean, m2, m3, jd.tq)
        out, _ = _run_filter(mc, disc * disc, fm, gb_planes,
                             jnp.ones((Hd, Wd)), jd.radius,
                             float(jd.ds_factor), gf_planes, th=8,
                             interpret=True, range_bf16=True)
        np.testing.assert_allclose(
            tres["film_mean_f"][j].numpy(), np.asarray(out).reshape(-1, 3),
            rtol=2 * BF16_ULP + 1e-5, atol=1e-6)
        for k, v in (("mean_corr", mc), ("discriminator", disc)):
            np.testing.assert_allclose(tres[k][j].numpy(),
                                       np.asarray(v).reshape(-1, 3),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_denoiser_halo_stays_f32():
    """With a halo (a mesh's row slab; here one slab, zeros past the
    edges), StatDenoiser(range_bf16=True) filters in the f32 form, bit for
    bit, as the JAX package's sharded denoise runs stat_filter whatever the
    flag (filter_jax.py:302-312); on the whole image the flag acts."""
    _, tc, states, film, Wd, Hd = _states(seed=12)
    ts = convert.moment_states(states)
    r = int(tc.filter_radius)

    def halo(x):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, r, r))

    res = {}
    for rb in (False, True):
        td = TFL.StatDenoiser(tc, Wd, Hd, range_bf16=rb)
        gbufs = td._gbuffers(ts)
        args = (ts[TE.RADIANCE], torch.tensor(np.asarray(film)), gbufs)
        res[rb] = td(*args, halo=halo), td(*args)
    for k in ("mean_corr", "discriminator", "film_mean_f", "film_f"):
        assert torch.equal(res[True][0][k], res[False][0][k]), k
    assert not torch.equal(res[True][1]["film_mean_f"],
                           res[False][1]["film_mean_f"])


def test_denoiser_defaults():
    """The port's StatDenoiser defaults to the f32 form, where the JAX
    package's defaults to range_bf16=True (filter_jax.py:187; its Pallas
    path on a TPU reads it): a divergence made on purpose (ROADMAP.md
    section C).  alpha and moon_ci default as the JAX package's."""
    jc, tc, _, _, Wd, Hd = _states()
    td, jd = TFL.StatDenoiser(tc, Wd, Hd), JDenoiser(jc, Wd, Hd, impl="jax")
    assert td.range_bf16 is False and jd.range_bf16 is True
    assert (td.alpha, td.moon_ci) == (jd.alpha, jd.moon_ci)
    np.testing.assert_array_equal(td.tq.numpy(), np.asarray(jd.tq))


def test_renderer_takes_the_given_denoiser(tmp_path):
    """Renderer(setup, denoiser=...) replaces the default denoiser, as
    statmc_tpu/driver.py:711's: the render's denoise pass goes through it
    (here StatDenoiser(range_bf16=True)), and a film-f comes out finite."""
    path = tmp_path / "scene.pbrt"
    path.write_text(scene_text(width=8, height=8, spp=1, iterations=1,
                               maxdepth=2, denoise=True, filterradius=1))
    setup = TD.load(str(path), device="cpu").s
    assert TD.Renderer(setup).denoiser.range_bf16 is False

    class Counting(TFL.StatDenoiser):
        calls = 0

        def __call__(self, *args, **kw):
            Counting.calls += 1
            return super().__call__(*args, **kw)

    d = Counting(setup.ecfg, setup.width, setup.height, range_bf16=True)
    r = TD.Renderer(setup, denoiser=d)
    assert r.denoiser is d
    r.render(iterations=1, verbose=False)
    assert Counting.calls > 0
    assert np.isfinite(r.film_f.numpy()).all()
