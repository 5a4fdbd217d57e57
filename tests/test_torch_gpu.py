"""Kernels B1-B4 against their plain PyTorch versions on the card.

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
from statmc_tpu_torch.accel import twolevel as TT
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


def _twolevel_case(cuda, n_tris, spread, size, ray_spread, seed):
    """Padded block inputs of random triangles and rays (a third of the
    rays dead), through the port's glue on the card."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-size, size, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-size, size, (n_tris, 3)).astype(np.float32)
    R = 3 * TT.RT_WALK + 77
    o = rng.uniform(-ray_spread, ray_spread, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(R) % 3 == 2, 0.0, 1e30).astype(np.float32)
    tl = TT.TwoLevelTris.from_tris(p0, e1, e2).to_device(cuda)
    _, o_p, d_p, tm_p = TT.blocks(tl, *(torch.as_tensor(x, device=cuda)
                                        for x in (o, d, t_max)), sort=True)
    return tl, o_p, d_p, tm_p


@pytest.mark.gpu
def test_b3_kernel_matches_plain(cuda):
    """The slab test is elementwise: votes equal exactly, also for rays
    whose slab times are NaN (a NaN origin; an infinite origin against a
    zero inverse direction), which vote in neither version."""
    tl, o_p, d_p, tm_p = _twolevel_case(cuda, 5000, 10.0, 0.5, 12.0, 4)
    rays = TT.slab_rays(o_p, d_p, tm_p)
    rays[1, :, 6] = 1e30  # block 1: every ray live, and every one NaN
    rays[1, 0::2, 1] = float("nan")
    rays[1, 1::2, 2] = float("inf")
    rays[1, 1::2, 5] = 0.0
    rays[2, ::3, 0] = float("nan")  # block 2: a NaN ray in three
    before = TT.cull.launches
    vote = TT.cull(tl.bounds, rays)
    assert TT.cull.launches == before + 1
    assert torch.equal(vote, TT.cull_plain(tl.bounds, rays))
    assert vote.any() and not vote.all() and not vote[1].any()


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.gpu
def test_b4_kernel_matches_plain(cuda, dense):
    """Same FMA chains in the same order: (t, id) bit-identical, also for
    blocks that vote for more than MAXS subtiles and walk densely."""
    args = ((60000, 2.0, 0.1, 3.0, 5) if dense
            else (5000, 10.0, 0.5, 12.0, 6))
    tl, o_p, d_p, tm_p = _twolevel_case(cuda, *args)
    vote = TT.cull(tl.bounds, TT.slab_rays(o_p, d_p, tm_p))
    order, n_eff, mask = TT.worklists(tl, vote)
    assert bool((n_eff > TT.MAXS).any()) == dense
    walk_args = (tl.table, order, n_eff, mask, TT.block_features(o_p, d_p),
                 tm_p.reshape(-1, TT.RT_WALK), tl.fsub)
    before = TT.walk.launches
    t_k, id_k = TT.walk(*walk_args)
    assert TT.walk.launches == before + 1
    t_p, id_p = TT.walk_plain(*walk_args)
    assert torch.equal(id_k, id_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert int((id_k >= 0).sum()) > 100
