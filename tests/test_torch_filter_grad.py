"""The differentiable filter of the port (denoise/grad.py) against the JAX
package's (denoise/filter_pallas.py:356-452, its Pallas kernel in
interpret mode): FilterApply, whose backward pass is kernel B2 with
normalize=False (on the CPU its plain version), and the autodiff twin
filter_apply_diff.

The backward pass rests on w_ij = w_ji.  valid_j breaks that symmetry
where valid has zeros, so there the kernel gradient differs from the
true one; the port mirrors the JAX package, which does the same
(ROADMAP.md, section C; test_valid_zeros_break_the_symmetry)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statmc_tpu.denoise import filter_pallas as FP
from statmc_tpu_torch.denoise import grad as TG

torch.set_num_threads(2)
R, DS = 2, -0.5 / 4.0


def _setup(seed=0, H=10, W=12, C=3, G=4, valid_zeros=False):
    """tests/test_filter_grads.py's inputs: wide CIs, so the acceptance
    gate is mostly open and off its measure-zero boundary."""
    rng = np.random.default_rng(seed)
    fm = rng.random((H, W, C)).astype(np.float32)
    mc = rng.random((H, W, C)).astype(np.float32)
    d2 = (0.5 + rng.random((H, W, C))).astype(np.float32)
    gb = rng.random((H, W, G)).astype(np.float32)
    valid = np.ones((H, W), np.float32)
    if valid_zeros:
        valid[:, -3:] = 0.0  # a halo-style mask: the last columns
        valid[1, 2] = 0.0
    gbf = tuple(-0.5 / (0.3 ** 2) for _ in range(G))
    return fm, mc, d2, gb, valid, gbf


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


def _jax_grads(fm, mc, d2, gb, valid, gbf):
    """Forward and d sum(sin(out)) / d film_mean of the JAX package's
    filter_apply (interpret mode) and filter_apply_diff."""
    args = tuple(jnp.asarray(x) for x in (mc, d2, gb, valid))

    def loss(f, x):
        return jnp.sum(jnp.sin(f(x, *args, R, DS, gbf)))

    pal = jax.tree_util.Partial(FP.filter_apply, interpret=True)
    out = {}
    for name, f in (("kernel", pal), ("diff", FP.filter_apply_diff)):
        out[name] = (np.asarray(f(jnp.asarray(fm), *args, R, DS, gbf)),
                     np.asarray(jax.grad(lambda x: loss(f, x))(
                         jnp.asarray(fm))))
    return out


def _port(f, fm, mc, d2, gb, valid, gbf):
    x = _t(fm, grad=True)
    out = f(x, _t(mc), _t(d2), _t(gb), _t(valid), R, DS, gbf)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_apply_matches_jax(seed):
    inputs = _setup(seed)
    jx = _jax_grads(*inputs)["kernel"]
    out, g = _port(TG.filter_apply, *inputs)
    np.testing.assert_allclose(out, jx[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, jx[1], rtol=1e-4, atol=1e-6)


def test_filter_apply_diff_matches_jax_and_kernel_path():
    inputs = _setup(1)
    jx = _jax_grads(*inputs)
    out, g = _port(TG.filter_apply_diff, *inputs)
    np.testing.assert_allclose(out, jx["diff"][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, jx["diff"][1], rtol=1e-4, atol=1e-6)
    # Kernel VJP against autodiff (test_filter_grads.py's tolerances).
    out_k, g_k = _port(TG.filter_apply, *inputs)
    np.testing.assert_allclose(out_k, out, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_k, g, rtol=1e-3, atol=1e-5)


def test_gbuffer_grads_finite_difference():
    """tests/test_filter_grads.py:52 on the port's twin: gradients flow
    into the G-buffers and match central differences."""
    fm, mc, d2, gb, valid, gbf = _setup(2, H=6, W=7)
    cot = torch.as_tensor(np.random.default_rng(0).standard_normal(
        fm.shape).astype(np.float32))
    fixed = (_t(fm), _t(mc), _t(d2))

    def loss(g):
        return torch.sum(cot * TG.filter_apply_diff(
            fixed[0], fixed[1], fixed[2], g, _t(valid), R, DS, gbf))

    g = _t(gb, grad=True)
    loss(g).backward()
    grad_g = g.grad.numpy()
    assert np.abs(grad_g).max() > 0
    eps = 1e-3
    rng = np.random.default_rng(3)
    for _ in range(6):
        i, j, c = (rng.integers(0, s) for s in gb.shape)
        dg = np.zeros(gb.shape, np.float32)
        dg[i, j, c] = eps
        fd = (float(loss(_t(gb + dg))) - float(loss(_t(gb - dg)))) / (2 * eps)
        assert abs(fd - grad_g[i, j, c]) < 5e-2 * max(1.0, abs(fd)), (
            i, j, c, fd, grad_g[i, j, c])


def test_valid_zeros_break_the_symmetry():
    """With zeros in valid, B2's backward pass (which assumes w_ij =
    w_ji) departs from autodiff's true gradient: at invalid pixels it
    passes a gradient that the forward pass never used.  The JAX package
    computes the same kernel gradient, so the port keeps it."""
    inputs = _setup(4, valid_zeros=True)
    valid = inputs[4]
    jx = _jax_grads(*inputs)
    out_k, g_k = _port(TG.filter_apply, *inputs)
    out_d, g_d = _port(TG.filter_apply_diff, *inputs)
    np.testing.assert_allclose(out_k, out_d, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_k, jx["kernel"][1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_d, jx["diff"][1], rtol=1e-4, atol=1e-6)
    bad = valid == 0
    # The true gradient is 0 where valid is 0: those pixels never feed an
    # output.  The kernel's transpose sends them one anyway.
    assert np.abs(g_d[bad]).max() == 0.0
    assert np.abs(g_k[bad]).max() > 1e-3
    # Pixels whose whole window is valid keep the true gradient.
    inner = np.zeros_like(bad)
    inner[R + 1:-R - 1, R:-3 - R] = True
    inner &= ~bad
    for y, x in zip(*np.nonzero(inner)):
        if bad[max(0, y - R):y + R + 1, max(0, x - R):x + R + 1].any():
            inner[y, x] = False
    assert inner.any()
    np.testing.assert_allclose(g_k[inner], g_d[inner], rtol=1e-3, atol=1e-5)
