"""`Integrator "mlt"` (statmc_tpu_torch/render/pssmlt.py) and the
jax.random draws it makes (core/rng.py) against the JAX package.

* split, uniform(minval, maxval), normal and categorical against
  jax.random, bit for bit (XLA's float32 log, log1p and erf_inv emulated);
* the bidirectional contribution f(U) (render/bdpt.py make_contribution)
  and the unidirectional one (integrator.trace under MODE_LOCKSTEP, U as
  the table) on 256 chains of the 8x8 box at maxdepth 2, against the JAX
  package's f run op-by-op under jax.disable_jit: the same dimension
  count, pixels equal, y and L within rtol 1e-4 (atol 1e-6) on >= 98.5%
  of the chains (measured 100%);
* the chain logic apart from f: `_f` monkeypatched in both packages to
  one cheap function of U, N_CHAINS and N_BOOTSTRAP cut to 64 and 512;
  the bootstrap's chains bit for bit and b within rtol 1e-6 (the two
  means reduce in different orders), then three mutation steps from the
  same key: every proposal, the chains and the splat bit for bit; then a
  fourth step from the JAX package's state (convert.alt_renderer_state),
  bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
import statmc_tpu.render.pssmlt as JM
import statmc_tpu_torch.driver as TD
import statmc_tpu_torch.render.pssmlt as TM
from statmc_tpu_torch import convert
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.core import rng as crng

torch.set_num_threads(2)
N = 4096
C = 256


def _key(seed):
    return jax.random.PRNGKey(np.uint32(seed)), crng.base_key(seed)


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("seed", [0, 7])
def test_split_and_uniform_match_jax(seed):
    kj, kt = _key(seed)
    np.testing.assert_array_equal(
        crng.split(kt, 5).numpy(), np.asarray(jax.random.split(kj, 5))
        .astype(np.int64))
    np.testing.assert_array_equal(
        _bits(crng.uniform_range(kt, (N,), 0.25, 3.5)),
        _bits(jax.random.uniform(kj, (N,), minval=0.25, maxval=3.5)))
    np.testing.assert_array_equal(
        _bits(crng.uniform(kt, (64, 64))),
        _bits(jax.random.uniform(kj, (64, 64))))


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_matches_jax(seed):
    """sqrt(2) erf^-1(u) with XLA's log1p and erf_inv polynomial: bit for
    bit on 4,096 draws, jitted and eager."""
    kj, kt = _key(seed)
    t = _bits(crng.normal(kt, (64, 64)))
    np.testing.assert_array_equal(t, _bits(jax.random.normal(kj, (64, 64))))
    np.testing.assert_array_equal(t, _bits(jax.jit(
        lambda k: jax.random.normal(k, (64, 64)))(kj)))


def test_xla_log_and_log1p_match_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(1e-30, 1e-3, N), rng.uniform(1e-3, 50, N),
                        np.exp(rng.uniform(-80, 80, N))]).astype(np.float32)
    np.testing.assert_array_equal(_bits(crng.xla_log(torch.tensor(x))),
                                  _bits(jax.jit(jnp.log)(x)))
    y = rng.uniform(-0.999, 3, 3 * N).astype(np.float32)
    np.testing.assert_array_equal(_bits(crng.xla_log1p(torch.tensor(y))),
                                  _bits(jax.jit(jnp.log1p)(y)))


@pytest.mark.parametrize("seed", [0, 7])
def test_categorical_matches_jax(seed):
    """Gumbel-max over 3,000 logits, 4,096 draws made 1,000 at a time:
    the same indices."""
    kj, kt = _key(seed)
    y = np.random.default_rng(seed).random(3000).astype(np.float32)
    y[::7] = 0.0
    logits = np.log(np.maximum(y, 1e-20))
    got = crng.categorical(kt, crng.xla_log(torch.clamp(torch.tensor(y),
                                                        min=1e-20)), N,
                           rows=1000)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.categorical(
            kj, jnp.asarray(logits), shape=(N,))))


def _box(tmp_path_factory, name, bidirectional, maxdepth=2):
    text = TS.box_scene_text("mlt", 1, maxdepth=maxdepth, size=8)
    if not bidirectional:
        text = text.replace('"integer iterations" [1]',
                            '"integer iterations" [1] '
                            '"bool bidirectional" ["false"]', 1)
    path = tmp_path_factory.mktemp(name) / f"{name}.pbrt"
    path.write_text(text)
    return str(path)


def _share(a, b):
    close = np.isclose(a, b, rtol=1e-4, atol=1e-6)
    return float((close.all(-1) if close.ndim == 2 else close).mean())


@pytest.mark.parametrize("bidirectional", [True, False])
def test_contribution_matches_jax(bidirectional, tmp_path_factory, capsys,
                                  monkeypatch):
    """f(U) on the same 256 chains (the JAX side op-by-op): the same
    dimension count, pixels equal, y and L within rtol 1e-4 on >= 98.5%
    of the chains."""
    for mod in (JM, TM):
        monkeypatch.setattr(mod, "N_CHAINS", C)
    path = _box(tmp_path_factory, f"f{int(bidirectional)}", bidirectional)
    jr = JD.load(path)
    tr = TD.load(path, device="cpu")
    assert isinstance(tr, TM.MLTRenderer) and tr.bidirectional is bidirectional
    assert tr.D == jr.D
    if bidirectional:  # t = 1 and its MIS terms left out of f (both)
        assert tr._bdpt.exclude_t1 and jr._bdpt.exclude_t1
    U = np.random.default_rng(11).random((C, tr.D)).astype(np.float32)
    if bidirectional:
        f_j = jr._f_bdpt
    else:
        f_j = jr._f
    with jax.disable_jit():
        yj, Lj, pj = (np.asarray(x) for x in f_j(jnp.asarray(U)))
    yt, Lt, pt = (x.numpy() for x in tr._f(torch.tensor(U)))
    np.testing.assert_array_equal(pt, pj)
    share = min(_share(yt, yj), _share(Lt, Lj))
    assert share >= 0.985
    assert (yj > 0).mean() > 0.3
    with capsys.disabled():
        print(f"\nmlt f(U), bidirectional {bidirectional}: D = {tr.D}, "
              f"{share:.4f} of {C} chains within rtol 1e-4")


def _cheap(U, W, H, backend):
    """A cheap f(U) for the chain logic, each float op a single rounding
    in both packages: L = U[:, 2:5], y = U2 U3 (0 where U4 < 0.2), pixel
    from U[:, :2]."""
    xp = jnp if backend == "jax" else torch
    if backend == "jax":
        px = jnp.clip(U[:, 0] * W, 0.0, W - 1e-3).astype(jnp.int32)
        py = jnp.clip(U[:, 1] * H, 0.0, H - 1e-3).astype(jnp.int32)
    else:
        px = torch.clamp(U[:, 0] * W, 0.0, W - 1e-3).to(torch.int32)
        py = torch.clamp(U[:, 1] * H, 0.0, H - 1e-3).to(torch.int32)
    y = xp.where(U[:, 4] < 0.2, 0.0, U[:, 2] * U[:, 3])
    return y, U[:, 2:5], py * W + px


def test_chain_logic_matches_jax(tmp_path_factory, monkeypatch):
    """Bootstrap, three mutation steps and a fourth from the JAX package's
    state, with a cheap f in both packages (module docstring)."""
    for mod in (JM, TM):
        monkeypatch.setattr(mod, "N_CHAINS", 64)
        monkeypatch.setattr(mod, "N_BOOTSTRAP", 512)
    path = _box(tmp_path_factory, "chain", False)
    jr = JD.load(path, base_seed=5)
    tr = TD.load(path, base_seed=5, device="cpu")
    W, H = tr.s.width, tr.s.height
    seen = []

    def f_j(self, U):
        jax.debug.callback(lambda u: seen.append(np.asarray(u)), U)
        return _cheap(U, W, H, "jax")

    monkeypatch.setattr(JM.MLTRenderer, "_f", f_j)
    monkeypatch.setattr(TM.MLTRenderer, "_f",
                        lambda self, U: _cheap(U, W, H, "torch"))
    jr._bootstrap()
    tr._bootstrap()
    assert abs(tr.b - jr.b) <= 1e-6 * jr.b and jr.b > 0
    for a, b in zip(tr._chains, jr._chains):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tr.key.numpy(),
                                  np.asarray(jr.key).astype(np.int64))
    kj, kt = _key(21)
    seen.clear()
    chains, splat = jr._make_step()(jr._chains, jr.splat, kj, n_steps=3)
    jax.block_until_ready(splat)
    props = []
    real_f = TM.MLTRenderer._f

    def rec_f(self, U):
        props.append(U.numpy())
        return real_f(self, U)

    monkeypatch.setattr(TM.MLTRenderer, "_f", rec_f)
    ch = tr._chains
    for k in crng.split(kt, 3):
        ch = tr.step(ch, k)
    assert len(props) == len(seen) == 3
    for a, b in zip(props, seen):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ch, chains):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tr.splat.numpy(), np.asarray(splat))
    assert np.asarray(splat).sum() > 0
    moved = (props[0] != jr._chains[0]).any(-1)
    assert 0 < moved.mean() <= 1  # every chain proposes; some accept

    # One more iteration from the JAX package's state.
    jr._chains, jr.splat = chains, splat
    jr.n_mut = 3 * 64
    tr2 = TD.load(path, base_seed=5, device="cpu")
    tr2._bootstrap = None
    convert.alt_renderer_state(jr, tr2)
    assert tr2.b == jr.b and tr2.n_mut == jr.n_mut
    jr._step_fn = None
    jr._render_iteration(1)
    tr2._render_iteration(1)
    for a, b in zip(tr2._chains, jr._chains):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tr2.splat.numpy(), np.asarray(jr.splat))
    np.testing.assert_array_equal(tr2.film_mean.numpy(),
                                  np.asarray(jr.film_mean))


def test_cli_renders_mlt(tmp_path, capsys, monkeypatch):
    """python -m statmc_tpu_torch --device cpu renders an mlt scene (256
    chains), writes its film (equal to load(...).render()'s) and prints
    the ray total."""
    import statmc_tpu_torch.__main__ as TMAIN
    from statmc_tpu_torch.io.pfm import read_pfm

    monkeypatch.setattr(TM, "N_CHAINS", 256)
    monkeypatch.setattr(TM, "N_BOOTSTRAP", 1024)
    path = tmp_path / "s.pbrt"
    path.write_text(TS.mlt_scene_text(width=8, height=6, spp=4, maxdepth=2,
                                      iterations=2))
    out = tmp_path / "out"
    assert TMAIN.main([str(path), "--writeimages", "--outdir", str(out),
                       "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "Iteration: 2" in text and "Rays traced" in text
    r = TD.load(str(path), device="cpu")
    r.render(verbose=False)
    f = read_pfm(str(out / "staircase-proxy-8-film.pfm"))
    np.testing.assert_array_equal(f, r.buffers()["film"])
    assert np.isfinite(f).all() and f.mean() > 0


MLT_PARAMS = ('"integer bootstrapsamples" [4096] "integer chains" [100] '
              '"integer mutationsperpixel" [64] '
              '"float largestepprobability" [0.7] "float sigma" [0.05]')


@pytest.mark.parametrize("bidirectional", [True, False])
def test_mlt_scene_parameters_ignored(bidirectional, tmp_path_factory,
                                      monkeypatch):
    """pbrt's MLTIntegrator reads bootstrapsamples, chains,
    mutationsperpixel, largestepprobability and sigma; both packages
    take N_CHAINS, N_BOOTSTRAP, P_LARGE, SIGMA and the spp schedule
    instead (statmc_tpu/render/pssmlt.py:45-48,
    statmc_tpu_torch/render/pssmlt.py:37-40).  An mlt scene with those
    parameters renders bit for bit as the scene without them, in each
    package: the JAX package with the cheap f of the chain-logic test
    (its chain logic whole), the port with the cheap f and, in the
    unidirectional mode, with its real f."""
    for mod in (JM, TM):
        monkeypatch.setattr(mod, "N_CHAINS", 64)
        monkeypatch.setattr(mod, "N_BOOTSTRAP", 512)
    plain = _box(tmp_path_factory, f"plain{int(bidirectional)}",
                 bidirectional)
    text = open(plain).read()
    tagged = text.replace('"integer iterations" [1]',
                          '"integer iterations" [1] ' + MLT_PARAMS, 1)
    assert tagged != text
    with_params = plain[:-len(".pbrt")] + "_params.pbrt"
    with open(with_params, "w") as f:
        f.write(tagged)

    def renders(load, **kw):
        out = []
        for path in (plain, with_params):
            r = load(path, base_seed=5, **kw)
            r.render(iterations=1, verbose=False)
            out.append((np.asarray(r.film_mean).copy(), r.b, r.n_mut))
        return out

    real_t = TM.MLTRenderer._f
    W = H = 8
    monkeypatch.setattr(JM.MLTRenderer, "_f",
                        lambda self, U: _cheap(U, W, H, "jax"))
    monkeypatch.setattr(TM.MLTRenderer, "_f",
                        lambda self, U: _cheap(U, W, H, "torch"))
    runs = [renders(JD.load), renders(TD.load, device="cpu")]
    if not bidirectional:
        monkeypatch.setattr(TM.MLTRenderer, "_f", real_t)
        runs.append(renders(TD.load, device="cpu"))
    for (f0, b0, n0), (f1, b1, n1) in runs:
        np.testing.assert_array_equal(f1, f0)
        assert b1 == b0 and n1 == n0 > 0 and f0.sum() > 0
    # The cheap chains agree across the packages too, to b's rounding (its
    # two means reduce in different orders).
    np.testing.assert_allclose(runs[1][0][0], runs[0][0][0], rtol=1e-6)
