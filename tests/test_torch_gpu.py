"""Kernels B1 and B2 against their plain PyTorch versions on the card.

The CUDA kernels have no CPU mode, so these tests carry the `gpu` marker
and skip without an NVIDIA GPU.  The file imports torch and the port
only (no JAX), so it also runs on a machine without jax, where
``--noconftest`` skips tests/conftest.py (which imports jax):
``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``.
"""
import numpy as np
import pytest
import torch

from statmc_tpu_torch.accel import fused as TF
from statmc_tpu_torch.denoise import filter as TFL
from statmc_tpu_torch.denoise import filter_cuda as FC
from statmc_tpu_torch.denoise.ttest import quantile_table


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_b1_kernel_matches_plain(cuda):
    """Bit-identical FMA chains: ids equal, t equal where they agree."""
    rng = np.random.default_rng(9)
    n, R = 700, 4096
    p0 = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(R) % 3 == 2, 0.0, 1e30).astype(np.float32)
    ft = TF.FusedTris.from_tris(p0, e1, e2).to_device(cuda)
    raye, rayp = (x.contiguous() for x in TF.ray_features(
        torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)))
    args = (ft.edge_table, ft.plane_table, raye, rayp,
            torch.as_tensor(t_max, device=cuda))
    before = TF.intersect_tiles.launches
    t_k, id_k = TF.intersect_tiles(*args)
    assert TF.intersect_tiles.launches == before + 1
    t_p, id_p = TF.intersect_plain(*args)
    same = id_k == id_p
    assert float(same.float().mean()) >= 0.9999
    torch.testing.assert_close(t_k[same], t_p[same], rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("normalize", [True, False])
def test_b2_kernel_matches_plain(cuda, normalize):
    """Same window order and per-step rounding; expf vs the library exp
    may differ in the last bit, hence rtol 1e-4 / atol 1e-6."""
    rng = np.random.default_rng(2)
    H, W, C, N = 48, 64, 3, 16
    xs = rng.gamma(4.0, 0.25, size=(N, H, W, C)).astype(np.float32)
    ys = 2.0 * (np.sqrt(xs) - 1.0)
    mean = ys.mean(0)
    dev = ys - mean

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=cuda)

    mc, disc = TFL.corrected_stats(
        t(np.full((H, W), N, np.float32)), t(mean), t((dev ** 2).sum(0)),
        t((dev ** 3).sum(0)), t(quantile_table(0.005)))
    args = (mc.contiguous(), (disc * disc).contiguous(), t(xs.mean(0)),
            t(rng.random((H, W, 6)).astype(np.float32)),
            torch.ones((H, W), device=cuda), 5, -0.02, (-50.0,) * 6)
    ok, wk = FC.run_filter(*args, normalize=normalize)
    op, wp = FC.run_filter_plain(*args, normalize=normalize)
    torch.testing.assert_close(ok, op, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(wk, wp, rtol=1e-4, atol=1e-6)
    assert float(wk.min()) >= 1.0 - 1e-5
