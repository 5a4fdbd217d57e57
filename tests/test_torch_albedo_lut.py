"""The albedo-LUT precompute of the port (statmc_tpu_torch/render/
albedo_lut.py, tools/precomputealbedo.py) against the JAX package.

* LookupTable.lookup against the JAX package's on random tables of
  N = 1..8 axes (one of them a single texel from N = 3), with and without
  a channel axis, at coordinates inside and outside [0, 1]: rtol 1e-6.
* FAMILY_AXES equal to the JAX package's, and the default table sizes.
* mc_albedo_at for each of the nine families on 24 coordinates at 32
  samples: each texel within rtol 1e-5 of the JAX package's compiled run
  (the fori_loop body is an XLA program; measured <= 9.5e-7 but on one
  texel), or, where it is not, within rtol 1e-5 of the package run op by
  op (jax.disable_jit) and no farther from the compiled run than that
  one is.  Metal's coordinate 22 (eta 0.41, k 1.6e-4, where the conductor
  Fresnel's eta^2 - k^2 - sin^2 cancels) moves by 1.0e-4 relative between
  the package's own two runs; the port meets the op-by-op run to 1.2e-7.
* precompute_family_nd for mirror (3, 5), hair (3, 4, 2, 2) and plastic
  (3, 2, 2, 3) at 16-64 samples, and precompute_family("matte", (8, 8)),
  against the JAX package's (rtol 1e-5, the same rule).
* The default tables miss --compare's 0.05 in both packages alike:
  glass's and uber's grids between their texels, metal's through the
  noise of the compare's truth at a grazing coordinate.
* precomputealbedo.main with --device cpu --compare --testlut --out:
  the JAX tool's exit code and printed lines (the seconds aside), and
  its .npz (data within rtol 1e-5; sizes and family equal).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.render.albedo_lut as JA
from statmc_tpu.tools import precomputealbedo as JP
import statmc_tpu_torch.render.albedo_lut as TA
from statmc_tpu_torch.tools import precomputealbedo as TP

torch.set_num_threads(2)
FAMILIES = sorted(TA.FAMILY_AXES)


def _assert_as_jax(t, compiled, opbyop, rtol=1e-5):
    """t within rtol of the JAX package's compiled run; where it is not,
    within rtol of the package's op-by-op run (`opbyop()`, run only then)
    and no farther from the compiled run than that one is."""
    gap = np.abs(t - compiled)
    if np.all(gap <= rtol * np.abs(compiled)):
        return
    with jax.disable_jit():
        witness = np.asarray(opbyop())
    np.testing.assert_allclose(t, witness, rtol=rtol)
    assert np.all(gap <= rtol * np.abs(compiled)
                  + np.abs(witness - compiled)), gap.max()


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("n", range(1, 9))
def test_lookup_matches_jax(n, channels):
    rng = np.random.default_rng(10 * n + (channels or 0))
    sizes = tuple(int(s) for s in rng.integers(2, 5, n))
    if n >= 3:
        sizes = sizes[:1] + (1,) + sizes[2:]
    shape = (int(np.prod(sizes)),) + ((channels,) if channels else ())
    data = rng.random(shape).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, (256, n)).astype(np.float32)
    j = np.asarray(jax.jit(JA.LookupTable(jnp.asarray(data), sizes).lookup)(
        jnp.asarray(coords)))
    t = TA.LookupTable(torch.tensor(data), sizes).lookup(
        torch.tensor(coords)).numpy()
    assert t.shape == j.shape == (256,) + shape[1:]
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_family_axes_match_jax():
    assert TA.FAMILY_AXES == JA.FAMILY_AXES
    assert {f: TA.default_sizes(f) for f in FAMILIES} == {
        f: ((16, 16, 8, 8, 8) if f == "metal" else
            (4 if f == "uber" else 8,) * len(JA.FAMILY_AXES[f]))
        for f in FAMILIES}
    for f in FAMILIES:
        assert TA._family_mat_type(f) == JA._family_mat_type(f)


@pytest.mark.parametrize("family", FAMILIES)
def test_mc_albedo_at_matches_jax(family):
    c = np.random.default_rng(5).random(
        (24, len(TA.FAMILY_AXES[family]))).astype(np.float32)
    def jax_run():
        return JA.mc_albedo_at(family, jnp.asarray(c), n_samples=32, seed=5)

    t = TA.mc_albedo_at(family, torch.tensor(c), 32, 5).numpy()
    _assert_as_jax(t, np.asarray(jax_run()), jax_run)
    if family == "hair":  # lanes built by field name: hair reflects
        assert t.min() > 0.1


@pytest.mark.parametrize("family,sizes,n_samples", [
    ("mirror", (3, 5), 16), ("hair", (3, 4, 2, 2), 32),
    ("plastic", (3, 2, 2, 3), 64)])
def test_precompute_family_nd_matches_jax(family, sizes, n_samples):
    def jax_run():
        return JA.precompute_family_nd(family, sizes, n_samples=n_samples,
                                       seed=2).data

    j = JA.precompute_family_nd(family, sizes, n_samples=n_samples, seed=2)
    t = TA.precompute_family_nd(family, sizes, n_samples=n_samples, seed=2,
                                device="cpu")
    assert t.sizes == j.sizes == tuple(sizes)
    _assert_as_jax(t.data.numpy(), np.asarray(j.data), jax_run)
    if family == "mirror":  # albedo = Kr exactly
        np.testing.assert_allclose(t.data.numpy().reshape(sizes)[0],
                                   np.linspace(0, 1, 5), atol=1e-5)


def test_precompute_family_matte_matches_jax():
    def jax_run():
        return JA.precompute_family("matte", (8, 8), n_samples=256).data

    j = JA.precompute_family("matte", (8, 8), n_samples=256)
    t = TA.precompute_family("matte", (8, 8), n_samples=256, device="cpu")
    assert t.sizes == j.sizes == (8, 8)
    _assert_as_jax(t.data.numpy(), np.asarray(j.data), jax_run)


def _at(package, family, p, n_samples, seed):
    if package == "jax":
        return np.asarray(JA.mc_albedo_at(family, jnp.asarray(p),
                                          n_samples=n_samples, seed=seed))
    return TA.mc_albedo_at(family, torch.tensor(p), n_samples, seed).numpy()


def _compare_coord(family, k):
    """Coordinate k of --compare's draw for seed 0."""
    n = len(TA.FAMILY_AXES[family])
    return np.random.default_rng(1).random((64, n)).astype(np.float32)[k]


@pytest.mark.parametrize("family,k", [("glass", 6), ("uber", 40)])
def test_default_grid_misses_the_threshold(family, k):
    """The default grids of glass and uber, copied from the JAX package,
    miss --compare's 0.05 between texels in both packages alike: at the
    compare's coordinate k the multilinear interpolation of its cell's
    2^N corner texels (1,024 samples) is off the 4,096-sample truth
    (seed 7) by more than 0.05 (measured 0.070 and 0.157; 0.088 and
    0.155 with 8,192-sample texels, whose spread over seeds is 0.02),
    and the two packages' texels agree within rtol 1e-5."""
    import itertools

    sizes = np.array(TA.default_sizes(family))
    c = _compare_coord(family, k)
    x = c * (sizes - 1)
    i0 = np.clip(np.floor(x).astype(int), 0, sizes - 2)
    corners = np.array(list(itertools.product([0, 1], repeat=len(sizes))))
    w = np.prod(np.where(corners == 1, x - i0, 1 - (x - i0)), -1)
    cc = ((i0 + corners) / (sizes - 1)).astype(np.float32)
    texels = {}
    for package in ("jax", "port"):
        truth = _at(package, family, c[None], 4096, 7)[0]
        texels[package] = _at(package, family, cc, 1024, 0)
        assert abs(float(w @ texels[package]) - truth) > 0.05, package
    np.testing.assert_allclose(texels["port"], texels["jax"], rtol=1e-5)


def test_metal_truth_noisier_than_the_threshold():
    """Metal's --compare misses 0.05 through noise, not its grid: at the
    compare's coordinate 15 (eta 4.81, k 7.28, grazing) sixteen
    4,096-sample estimates of the truth spread by more than 0.1
    (standard deviation 0.056), in both packages alike (rtol 1e-5)."""
    c = np.repeat(_compare_coord("metal", 15)[None], 16, 0)
    est = {p: _at(p, "metal", c, 4096, 7) for p in ("jax", "port")}
    for p, v in est.items():
        assert np.ptp(v) > 0.1, p
    np.testing.assert_allclose(est["port"], est["jax"], rtol=1e-5)


def _lines(text):
    return [re.sub(r" in [0-9.]+s$", "", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("family,sizes", [("matte", ["4", "4"]),
                                          ("mirror", ["3", "5"])])
def test_tool_matches_jax_tool(family, sizes, tmp_path, capsys):
    args = ["--family", family, "--sizes", *sizes, "--samples", "32",
            "--seed", "1", "--compare", "--testlut"]
    rc_j = JP.main(args + ["--out", str(tmp_path / "j.npz")])
    out_j = capsys.readouterr().out
    rc_t = TP.main(args + ["--out", str(tmp_path / "t.npz"), "--device",
                           "cpu"])
    out_t = capsys.readouterr().out
    assert rc_t == rc_j
    assert _lines(out_t.replace("t.npz", "j.npz")) == _lines(out_j)
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert a.files == b.files == ["data", "sizes", "family"]
    np.testing.assert_allclose(b["data"], a["data"], rtol=1e-5)
    np.testing.assert_array_equal(b["sizes"], a["sizes"])
    assert str(b["family"]) == str(a["family"]) == family


def test_tool_needs_the_card_unless_told(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TP.main(["--family", "mirror", "--sizes", "2", "2"]) == 1
    captured = capsys.readouterr()
    assert "--device cpu" in captured.err and not captured.out
