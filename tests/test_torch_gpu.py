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


def _bits_equal(t_k, id_k, t_p, id_p):
    assert torch.equal(id_k, id_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n,R,t_kind", [
    (700, 4096, "mixed"),      # three tiles, whole blocks
    (700, 4096 + 77, "mixed"),  # R not a multiple of the block
    (200, 1000, "mixed"),      # one tile, less than two blocks
    (700, 0, "mixed"),         # zero rays
    (700, 2048, "dead_block"),  # the first 512 rays dead, and every third
    (300, 1500, "inf"),        # t_max = +inf: the first triangle's 1e30 wins
    (300, 1500, "nan"),        # NaN t_max on every other ray
    (300, 1500, "nonfinite"),  # infinite and NaN origins
])
def test_b1_kernel_matches_plain(cuda, n, R, t_kind):
    """The same FMA chains over the same columns: ids equal on every ray
    and t equal as bits, on ragged sizes and on dead, unbounded, NaN and
    non-finite lanes."""
    rng = np.random.default_rng(9)
    p0 = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(R) % 3 == 2, 0.0, np.where(
        np.arange(R) % 3 == 1, 5.0, 1e30)).astype(np.float32)
    if t_kind == "dead_block":
        t_max[:512] = 0.0
    elif t_kind == "inf":
        t_max[:] = np.inf
    elif t_kind == "nan":
        t_max[::2] = np.nan
    elif t_kind == "nonfinite":
        o[0::4, 0] = np.inf
        o[1::4, 1] = np.nan
        o[2::8, 2] = -np.inf
    ft = TF.FusedTris.from_tris(p0, e1, e2).to_device(cuda)
    raye, rayp = (x.contiguous() for x in TF.ray_features(
        torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)))
    args = (ft.edge_table, ft.plane_table, raye, rayp,
            torch.as_tensor(t_max, device=cuda))
    before = TF.intersect_tiles.launches
    t_k, id_k = TF.intersect_tiles(*args, ft.packed, ft.n_tris)
    assert TF.intersect_tiles.launches == before + 1
    _bits_equal(t_k, id_k, *TF.intersect_plain(*args))
    # Packed on the fly, and the padding rows walked like any other.
    _bits_equal(*TF.intersect_tiles(*args), t_k, id_k)
    if R and t_kind not in ("nan", "nonfinite"):
        assert int((id_k >= 0).sum()) > R // 40  # the scene is really hit
    if t_kind == "inf":
        assert bool((id_k >= 0).all())


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


def _twolevel_case(cuda, n_tris, spread, size, ray_spread, seed, fsub=None):
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
    tl = TT.TwoLevelTris.from_tris(p0, e1, e2, fsub=fsub).to_device(cuda)
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


@pytest.mark.parametrize("case", ["worklists", "dense", "fsub1", "inf",
                                  "empty_and_dead"])
@pytest.mark.gpu
def test_b4_kernel_matches_plain(cuda, case):
    """Same FMA chains in the same order: (t, id) bit-identical on blocks
    with worklists (fsub 4 and 1), on blocks that vote for more than MAXS
    subtiles and walk densely, with t_max = +inf, and on a launch with an
    empty worklist and a block of dead rays."""
    dense = case == "dense"
    args = ((60000, 2.0, 0.1, 3.0, 5) if dense
            else (5000, 10.0, 0.5, 12.0, 6))
    tl, o_p, d_p, tm_p = _twolevel_case(cuda, *args,
                                        fsub=1 if case == "fsub1" else None)
    assert tl.fsub == (1 if case == "fsub1" else 4)
    if case == "inf":
        tm_p = torch.where(tm_p > 0, float("inf"), tm_p)
    elif case == "empty_and_dead":
        tm_p[TT.RT_WALK:2 * TT.RT_WALK] = 0.0  # block 1: no live ray
    vote = TT.cull(tl.bounds, TT.slab_rays(o_p, d_p, tm_p))
    if case == "empty_and_dead":
        vote[0] = False  # block 0: live rays, empty worklist
    order, n_eff, mask = TT.worklists(tl, vote)
    assert bool((n_eff > TT.MAXS).any()) == dense
    walk_args = (tl.table, order, n_eff, mask, TT.block_features(o_p, d_p),
                 tm_p.reshape(-1, TT.RT_WALK), tl.fsub)
    before = TT.walk.launches
    t_k, id_k = TT.walk(*walk_args, tl.packed)
    assert TT.walk.launches == before + 1
    t_p, id_p = TT.walk_plain(*walk_args)
    assert torch.equal(id_k, id_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    t_f, id_f = TT.walk(*walk_args)  # packed on the fly
    assert torch.equal(id_f, id_k) and torch.equal(t_f, t_k)
    if case == "empty_and_dead":  # blocks 2 and 3 are left: 589 rays
        assert int(n_eff[0]) == 0 and not bool((id_k[:2] >= 0).any())
        assert torch.equal(t_k[:2], walk_args[5][:2])
        assert bool((id_k[2:] >= 0).any())
    else:
        assert int((id_k >= 0).sum()) > 100
