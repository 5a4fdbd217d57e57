"""statmc_tpu_torch.stats (moments + estimator) against the JAX package:
the streaming updates keep the reference's statement order and the
rounding of the JAX package's compiled (jitted) update, so on the CPU the
results are bitwise equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statmc_tpu.scene.params import ParamSet
from statmc_tpu.stats import estimator as JE
from statmc_tpu.stats import moments as JM
from statmc_tpu.render.integrator import SampleOutput as JOut
from statmc_tpu_torch import convert
from statmc_tpu_torch.render.integrator import SampleOutput as TOut
from statmc_tpu_torch.stats import estimator as TE
from statmc_tpu_torch.stats import moments as TM

torch.set_num_threads(2)


def _assert_state_equal(js, ts):
    """Bitwise for n, mean, m2 and the film duals.  m3 adds two products,
    -3 dn m2' + d (d^2 - dn^2), which XLA's CPU loop contracts into
    fma(-3 dn, m2', .) in its 16-wide vector body but into fma(d, ., .)
    in the scalar remainder of each row (here the last 6 of 150).  The
    port takes the body's grouping, so m3, whose values near 0 come from
    cancellation, is held at rtol 1e-5 / atol 1e-6 (a few ulps of its
    O(1) scale)."""
    assert set(js) == set(ts)
    for k in js:
        if k == "m3":
            np.testing.assert_allclose(np.asarray(js[k]), ts[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(),
                                          err_msg=k)


@pytest.mark.parametrize("transform", [False, True])
def test_moment_updates_bitwise(transform):
    rng = np.random.default_rng(1 + transform)
    js = JM.make_state((2, 50), 3, transform=transform)
    ts = TM.make_state((2, 50), 3, transform=transform)
    for _ in range(6):
        x = rng.gamma(2.0, 0.5, size=(2, 50, 3)).astype(np.float32)
        mask = rng.random((2, 50)) < 0.8
        ju = jax.jit(JM.update_transform if transform else JM.update)
        tu = TM.update_transform if transform else TM.update
        js = ju(js, jnp.asarray(x), jnp.asarray(mask))
        ts = tu(ts, torch.as_tensor(x), torch.as_tensor(mask))
        _assert_state_equal(js, ts)
    np.testing.assert_array_equal(
        np.asarray(JM.mean_variance(js, film=True)),
        TM.mean_variance(ts, film=True).numpy())


def _config(extra):
    p = ParamSet()
    for name, typ, val in extra:
        p.add(f"{typ} {name}", val)
    return p


@pytest.mark.parametrize("flags", [
    [("denoiseimage", "bool", [True]), ("calcstats", "bool", [True])],
    [("acrr", "bool", [True]), ("smis", "bool", [True]),
     ("calcprodenstats", "bool", [True]), ("calcitstats", "bool", [True]),
     ("maxdepth", "integer", [3])],
])
def test_update_states_and_export_bitwise(flags):
    params = _config(flags)
    jc = JE.derive_config(params, ParamSet(), 4)
    tc = TE.derive_config(params, ParamSet(), 4)
    assert [vars(c) for c in jc.configs] == [vars(c) for c in tc.configs]
    P, W, H = 24, 6, 4
    js = JE.make_states(jc, P)
    jupd = jax.jit(lambda st, out, m: JE.update_states(st, jc, out, m))
    ts = TE.make_states(tc, P)
    rng = np.random.default_rng(5)
    NL, NB = max(jc.configs[JE.RADIANCE].bounce_end, 1), max(
        jc.configs[JE.MIS_BSDF_WIN_RATE].bounce_end, 1)
    for _ in range(4):
        f = {
            "ls": rng.gamma(2.0, 0.5, size=(P, NL, 3)),
            "mis_bsdf": rng.integers(0, 3, size=(P, NB)),
            "mis_light": rng.integers(0, 3, size=(P, NB)),
            "mat_id": rng.integers(0, 5, size=(P,)),
            "depth": rng.random(P) * 10, "normal": rng.random((P, 3)),
            "albedo": rng.random((P, 3)), "n_rays": rng.integers(1, 9, P),
            "path_len": rng.integers(0, 5, P),
        }
        f = {k: v.astype(np.float32) for k, v in f.items()}
        mask = rng.random(P) < 0.9
        js = jupd(js, JOut(**{k: jnp.asarray(v)
                                              for k, v in f.items()}),
                              jnp.asarray(mask))
        ts = TE.update_states(ts, tc, TOut(**{k: torch.as_tensor(v)
                                              for k, v in f.items()}),
                              torch.as_tensor(mask))
    for t in js:
        _assert_state_equal(js[t], ts[t])
    assert convert.moment_states(js).keys() == ts.keys()
    bj = JE.export_buffers(js, jc, W, H)
    bt = TE.export_buffers(ts, tc, W, H)
    assert bj.keys() == bt.keys()
    for k in bj:
        np.testing.assert_allclose(bj[k], bt[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("transform", [False, True])
@pytest.mark.parametrize("axis", [0, 2])
def test_from_batch_matches_jax(axis, transform, masked):
    """from_batch (plain, transform=True, mask=) and sample_variance: the
    reductions sum in another order than XLA's, so every field is held
    at rtol 1e-6 with an atol of 1e-6 times the field's largest
    magnitude (m3 and the Box-Cox mean sum signed terms that cancel)."""
    rng = np.random.default_rng(20 + 4 * axis + 2 * transform + masked)
    shape = (16, 5, 6, 3) if axis == 0 else (5, 6, 16, 3)
    x = rng.gamma(2.0, 0.5, size=shape).astype(np.float32)
    m = rng.random(shape[:-1]) < 0.7 if masked else None
    js = JM.from_batch(jnp.asarray(x), axis=axis, transform=transform,
                       mask=None if m is None else jnp.asarray(m))
    ts = TM.from_batch(torch.tensor(x), axis=axis, transform=transform,
                       mask=None if m is None else torch.tensor(m))
    assert set(ts) == set(js)
    js["var"], ts["var"] = JM.sample_variance(js), TM.sample_variance(ts)
    for k in js:
        a = np.asarray(js[k])
        assert ts[k].shape == a.shape, k
        np.testing.assert_allclose(ts[k].numpy(), a, rtol=1e-6,
                                   atol=1e-6 * np.abs(a).max(), err_msg=k)
