"""Kernels B1-B4 against their plain PyTorch versions on the card (B2 in
each of its six forms, and as the backward kernel of denoise/grad.py's
FilterApply), an LD-sampler
render and a textured render on the card against the CPU, the
environment map's sampling search at 2^20 lanes on the card against the
CPU, a volpath render on the card against the CPU and B1 on its walks'
closest-hit calls, BDPT and MLT on the card against the CPU (BDPT's
splats bit for bit in two runs), the exact lockstep replay of
tiny.pbrt on the card against the C++ reference's PFMs, the
albedo-LUT precompute and bsdftest on the card against the CPU, kernel
R1 against its plain version, and the bounce step replayed from CUDA
graphs (render/bounce_graphs.py) against the eager step, bit for bit,
with its three scene queries and its counters.

The CUDA kernels have no CPU mode, so these tests carry the `gpu` marker
and skip without an NVIDIA GPU.  The file imports torch and the port
only (no JAX), so it also runs on a machine without jax, where
``--noconftest`` skips tests/conftest.py (which imports jax):
``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``.
"""
import numpy as np
import pytest
import torch

from statmc_tpu_torch import spans
from statmc_tpu_torch.__main__ import GRAPH_COUNTERS
from statmc_tpu_torch.accel import fused as TF
from statmc_tpu_torch.accel import twolevel as TT
from statmc_tpu_torch.denoise import filter as TFL
from statmc_tpu_torch.denoise import filter_cuda as FC
from statmc_tpu_torch.denoise import grad as TG
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
    (12, 1, "mixed"),          # 1-4 rays: the exact replay's calls
    (12, 3, "mixed"),
    (12, 4, "inf"),
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
    before = spans.counted("kernel.B1")
    t_k, id_k = TF.intersect_tiles(*args, ft.packed, ft.n_tris)
    assert spans.counted("kernel.B1") == before + 1
    _bits_equal(t_k, id_k, *TF.intersect_plain(*args))
    _bits_equal(t_k, id_k, *TF.intersect_plain(*args, ft.n_tris))
    # Packed on the fly, and the padding rows walked like any other.
    _bits_equal(*TF.intersect_tiles(*args), t_k, id_k)
    if R >= 40 and t_kind not in ("nan", "nonfinite"):
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


# (H, W, C, CF, G, r, kind): H and W not multiples of the kernel's tile
# (128 columns x 4 or 2 rows); r = 0, 1, 20, and past the image; C = 1..4,
# CF up to 8, G = 0..16; rows staged in two pieces (W > 256, r = 70);
# valid with zeros; a high accept share (large d2).
B2_CASES = [
    (37, 133, 3, 3, 6, 20, "render_shape"),
    (21, 50, 3, 3, 6, 0, "r0"),
    (30, 131, 1, 1, 0, 1, "r1"),
    (9, 13, 2, 5, 3, 40, "r_past_image"),
    (19, 270, 4, 8, 16, 20, "widest"),
    (23, 300, 3, 3, 6, 70, "pieces"),
    (17, 40, 3, 6, 6, 5, "valid_zeros"),
    (20, 64, 3, 3, 6, 20, "high_accept"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("H,W,C,CF,G,r,kind", B2_CASES)
def test_b2_staged_kernel_matches_plain(cuda, normalize, H, W, C, CF, G, r,
                                        kind):
    """The staged B2 against its plain version on ragged shapes, every
    channel count it takes and radii from 0 to past the image: rtol 1e-4
    / atol 1e-6 (expf against the library exp)."""
    rng = np.random.default_rng(H * W + C)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=cuda)

    d2 = (np.full((H, W, C), 10.0) if kind == "high_accept"
          else rng.gamma(2.0, 0.05, (H, W, C)))
    valid = (rng.random((H, W)) > 0.3 if kind == "valid_zeros"
             else np.ones((H, W)))
    args = (t(rng.standard_normal((H, W, C))), t(d2),
            t(rng.random((H, W, CF))), t(rng.random((H, W, G))), t(valid),
            r, -0.02, tuple((-0.5 if kind == "high_accept" else -50.0)
                            * rng.random(G)))
    before = spans.counted("kernel.B2")
    ok, wk = FC.run_filter(*args, normalize=normalize)
    assert spans.counted("kernel.B2") == before + 1
    op, wp = FC.run_filter_plain(*args, normalize=normalize)
    torch.testing.assert_close(ok, op, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(wk, wp, rtol=1e-4, atol=1e-6)
    if kind == "high_accept":  # every in-image pair accepted
        assert float(wk.min()) > 1.5
    elif kind == "valid_zeros":
        assert float(wk.min()) < 1.0


# B2's other five forms on the render's shape (the exact instantiation),
# G = 0 (the range flag acts not), an odd G (a zero pad plane) with r past
# the image, the widest channel counts, and valid with zeros.
B2_FORM_CASES = [c for c in B2_CASES if c[-1] in (
    "render_shape", "r1", "r_past_image", "widest", "valid_zeros")]


@pytest.mark.gpu
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("H,W,C,CF,G,r,kind", B2_FORM_CASES)
@pytest.mark.parametrize("form", list(FC.FORMS)[1:])
def test_b2_form_kernel_matches_plain(cuda, form, normalize, H, W, C, CF, G,
                                      r, kind):
    """Each of B2's five other forms (range_bf16, accept_expand,
    accept_bf16 and their pairs) launches its own kernel (counted under
    its own form; with G = 0 under its acceptance form) and meets its
    plain version, which rounds at the same places: where expf and the
    library's exp differ, a bf16 weight moves by one bf16 ulp, 2^-8
    relative on the raw sums and 2^-7 on the normalized output (rtol 1e-4
    in the f32 range forms); atol 1e-6."""
    kw = FC.FORMS[form]
    rng = np.random.default_rng(H * W + C + 1)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=cuda)

    valid = (rng.random((H, W)) > 0.3 if kind == "valid_zeros"
             else np.ones((H, W)))
    args = (t(rng.standard_normal((H, W, C))),
            t(rng.gamma(2.0, 0.5, (H, W, C))), t(rng.random((H, W, CF))),
            t(rng.random((H, W, G))), t(valid), r, -0.02,
            tuple(-50.0 * rng.random(G)))
    bf16 = bool(kw.get("range_bf16")) and G > 0
    before = spans.counted("kernel.B2")
    by_form = FC.form_launches()
    by_form[FC.form_of(kw.get("accept_expand", False), bf16,
                       kw.get("accept_bf16", False))] += 1
    ok, wk = FC.run_filter(*args, normalize=normalize, **kw)
    assert spans.counted("kernel.B2") == before + 1
    assert FC.form_launches() == by_form
    op, wp = FC.run_filter_plain(*args, normalize=normalize, **kw)
    rtol = (2.0 ** -7 if normalize else 2.0 ** -8) if bf16 else 1e-4
    torch.testing.assert_close(ok, op, rtol=rtol, atol=1e-6)
    torch.testing.assert_close(wk, wp, rtol=2.0 ** -8 if bf16 else 1e-4,
                               atol=1e-6)
    if kind != "valid_zeros":
        assert float(wk.min()) >= 1.0 - 2.0 ** -8


@pytest.mark.gpu
def test_b2_unbuilt_shape_raises(cuda):
    """A channel count that no instantiation takes (C = 5 > 4) raises on
    the card; it never gives way to the plain version."""
    z = torch.zeros((4, 4, 5), device=cuda)
    with pytest.raises(RuntimeError):
        FC.run_filter(z, z, z, torch.zeros((4, 4, 0), device=cuda),
                      torch.ones((4, 4), device=cuda), 1, -0.02, (),
                      range_bf16=True)


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
    before = spans.counted("kernel.B3")
    vote = TT.cull(tl.bounds, rays)
    assert spans.counted("kernel.B3") == before + 1
    assert torch.equal(vote, TT.cull_plain(tl.bounds, rays))
    assert vote.any() and not vote.all() and not vote[1].any()


CULL_CASES = ["camera", "sorted", "mixed_sign", "fallback_dirs",
              "dead_blocks", "nonfinite_origins", "t_max_special",
              "padding_boxes", "fsub1"]


def cull_case(case, device="cpu"):
    """(bounds, rays, tl) for kernel B3 and its plain reject: random
    triangles (nf = 144, or 8 with 3 padding boxes, or 36 at fsub 1: none a
    multiple of the kernel's 32 boxes a warp) and 4 blocks and a partial
    one of rays through the port's glue, then the case's special values
    written into the slab rays.  Also imported by the CPU tests."""
    rng = np.random.default_rng(CULL_CASES.index(case))
    T = 129 if case == "padding_boxes" else 4500
    p0 = rng.uniform(-10, 10, (T, 3)).astype(np.float32)
    e1, e2 = rng.uniform(-0.5, 0.5, (2, T, 3)).astype(np.float32)
    tl = TT.TwoLevelTris.from_tris(
        p0, e1, e2, fsub=1 if case == "fsub1" else None).to_device(device)
    R = 4 * TT.RT_WALK + 77
    if case == "camera":  # a pinhole's fan of rays, sorted as the path sorts
        o = np.tile(np.float32([0.5, 4.0, -16.0]), (R, 1))
        u = np.arange(R) % 64 / 64.0 - 0.5
        v = np.arange(R) // 64 / 40.0 - 0.5
        d = np.stack([u, v, np.ones(R)], -1).astype(np.float32)
    else:
        o = rng.uniform(-12, 12, (R, 3)).astype(np.float32)
        d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(R) % 3 == 2, 0.0, np.where(
        np.arange(R) % 3 == 1, 9.0, 1e30)).astype(np.float32)
    if case == "fallback_dirs":  # inverse components of +-1e12
        d[0::3, 0] = 0.0
        d[1::3, 1] = -0.0
        d[2::5, 2] = 1e-13
        d[3::7, 0] = -1e-13
    _, o_p, d_p, tm_p = TT.blocks(
        tl, *(torch.as_tensor(x, device=device) for x in (o, d, t_max)),
        sort=case not in ("mixed_sign", "nonfinite_origins"))
    rays = TT.slab_rays(o_p, d_p, tm_p)
    nan, inf = float("nan"), float("inf")
    if case == "dead_blocks":
        rays[0, :, 6] = 0.0  # no live ray
        rays[1, ::2, 6] = -1.0  # partly dead
        rays[1, 1::4, 6] = nan
    elif case == "nonfinite_origins":
        rays[0, ::5, 0] = nan
        rays[1, ::7, 1] = inf
        rays[2, ::9, 2] = -inf
        rays[2, ::9, 5] = 0.0  # -inf * 0: NaN slab times
    elif case == "t_max_special":
        rays[0, :, 6] = inf
        rays[1, ::2, 6] = nan
        rays[2, :, 6] = 1e30
        rays[3, ::3, 6] = inf
    elif case == "padding_boxes":
        # Inverse 1e12 on every axis and t_max = +inf: the slab times of
        # the padding boxes (lo = hi = 1e30) overflow to inf <= inf, so
        # these rays vote for them.
        rays[1, :64, 3:6] = 1e12
        rays[1, :64, 6] = inf
    return tl.bounds, rays.contiguous(), tl


@pytest.mark.gpu
@pytest.mark.parametrize("case", CULL_CASES)
def test_b3_reject_kernel_matches_plain(cuda, case):
    """The redesigned B3 (per sub-block reject, then the per-ray sweep) on
    sorted camera-like blocks, unsorted mixed-octant blocks and special
    rays: votes equal cull_plain's bit for bit."""
    bounds, rays, _ = cull_case(case, cuda)
    before = spans.counted("kernel.B3")
    vote = TT.cull(bounds, rays)
    assert spans.counted("kernel.B3") == before + 1
    assert torch.equal(vote, TT.cull_plain(bounds, rays))
    assert vote.any()
    if case == "dead_blocks":
        assert not vote[0].any()
    if case == "padding_boxes":
        assert vote[1, 5:].all()


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
    before = spans.counted("kernel.B4")
    t_k, id_k = TT.walk(*walk_args, tl.packed)
    assert spans.counted("kernel.B4") == before + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("valid_zeros", [False, True])
def test_b2_backward_kernel_matches_plain(cuda, valid_zeros):
    """FilterApply's backward pass launches B2 with normalize=False on
    g / max(wsum, 1e-20): held to the plain version's VJP on the same
    inputs (rtol 1e-4 / atol 1e-6), and, with valid all ones, to the
    autodiff twin (rtol 1e-3 / atol 1e-5, tests/test_filter_grads.py)."""
    rng = np.random.default_rng(5)
    H, W, C, G, r = 40, 72, 3, 6, 5

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=cuda)

    fm = t(rng.random((H, W, C)))
    mc, d2 = t(rng.random((H, W, C))), t(0.5 + rng.random((H, W, C)))
    gb, g = t(rng.random((H, W, G))), t(rng.standard_normal((H, W, C)))
    valid = np.ones((H, W), np.float32)
    if valid_zeros:
        valid[:, -4:] = 0.0
    valid = t(valid)
    gf, ds = (-0.5 / 0.3 ** 2,) * G, -0.5 / 4.0
    x = fm.clone().requires_grad_(True)
    before = spans.counted("kernel.B2")
    out = TG.filter_apply(x, mc, d2, gb, valid, r, ds, gf)
    out.backward(g)
    assert spans.counted("kernel.B2") == before + 2  # forward + backward
    _, wsum = FC.run_filter_plain(mc, d2, fm, gb, valid, r, ds, gf)
    grad_p, _ = FC.run_filter_plain(
        mc, d2, (g / torch.clamp(wsum, min=1e-20)[..., None]).contiguous(),
        gb, valid, r, ds, gf, normalize=False)
    torch.testing.assert_close(x.grad, grad_p, rtol=1e-4, atol=1e-6)
    if not valid_zeros:
        y = fm.clone().requires_grad_(True)
        TG.filter_apply_diff(y, mc, d2, gb, valid, r, ds, gf).backward(g)
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-3, atol=1e-5)


def _small_staircase(tmp_path, sampler):
    from statmc_tpu_torch.testscenes import scene_text

    text = scene_text(width=16, height=12, spp=2, iterations=2, maxdepth=3,
                      denoise=True, filterradius=2)
    path = tmp_path / "s.pbrt"
    path.write_text(text.replace('Sampler "random"', f'Sampler "{sampler}"'))
    return str(path)


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["halton", "sobol"])
def test_ld_render_card_matches_cpu(cuda, sampler, tmp_path):
    """An LD-sampler render on the card against the CPU: equal sample
    counts and ray totals, every buffer within rtol 1e-4 on 98% of its
    pixels (chip_smoke.py's rule for a small render)."""
    from statmc_tpu_torch.driver import load

    path = _small_staircase(tmp_path, sampler)
    runs = {}
    for dev in ("cuda", "cpu"):
        r = load(path, device=dev)
        r.progress = False
        runs[dev] = (r.render(verbose=False)[-1]["rays_total"], r.buffers())
    assert runs["cuda"][0] == runs["cpu"][0]
    gpu, cpu = runs["cuda"][1], runs["cpu"][1]
    assert gpu.keys() == cpu.keys()
    for k in cpu:
        if k.endswith("-n"):
            np.testing.assert_array_equal(gpu[k], cpu[k])
            continue
        close = np.isclose(gpu[k], cpu[k], rtol=1e-4, atol=1e-6)
        assert (close.all(-1) if close.ndim == 3 else close).mean() >= 0.98


@pytest.mark.gpu
def test_exact_replay_of_tiny_on_the_card(cuda):
    """tiny.pbrt's exact lockstep replay on the card against the C++
    reference's PFMs, at tests/test_refparity.py's tolerances."""
    import os

    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.io.pfm import read_pfm
    from statmc_tpu_torch.render.lockstep_exact import moments_from_samples

    fix = os.path.join(os.path.dirname(__file__), "fixtures", "refparity")

    def ref(name):
        return read_pfm(os.path.join(fix, f"tiny-4-{name}.pfm"))

    before = spans.counted("kernel.B1")
    rep = load(os.path.join(fix, "tiny.pbrt"), device=cuda
               ).render_lockstep_exact(spp=4)
    assert spans.counted("kernel.B1") > before
    np.testing.assert_allclose(rep.film.reshape(16, 16, 3), ref("film"),
                               atol=2e-6, rtol=0)
    n, mean, m2, m3 = moments_from_samples(rep.radiance)
    np.testing.assert_array_equal(n.reshape(16, 16), ref("t0-b0-n"))
    for name, x in (("mean", mean), ("m2", m2), ("m3", m3)):
        np.testing.assert_allclose(x.reshape(16, 16, 3), ref(f"t0-b0-{name}"),
                                   atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_textured_render_card_matches_cpu(cuda, tmp_path):
    """The textured staircase (every texture kind, an environment map, a
    goniometric light) on the card against the CPU: equal sample counts
    and ray totals, every buffer within rtol 1e-4 on 99% of its pixels;
    kernels B1 and B2 launched on the card."""
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.testscenes import textured_scene_text

    path = tmp_path / "s.pbrt"
    path.write_text(textured_scene_text(str(tmp_path), width=32, height=24))
    runs = {}
    for dev in ("cuda", "cpu"):
        b1, b2 = spans.counted("kernel.B1"), spans.counted("kernel.B2")
        r = load(str(path), device=dev)
        r.progress = False
        runs[dev] = (r.render(verbose=False)[-1]["rays_total"], r.buffers())
        if dev == "cuda":
            assert spans.counted("kernel.B1") > b1
            assert spans.counted("kernel.B2") > b2
    assert runs["cuda"][0] == runs["cpu"][0]
    gpu, cpu = runs["cuda"][1], runs["cpu"][1]
    assert gpu.keys() == cpu.keys()
    for k in cpu:
        if k.endswith("-n"):
            np.testing.assert_array_equal(gpu[k], cpu[k])
            continue
        assert np.isfinite(gpu[k]).all(), k
        close = np.isclose(gpu[k], cpu[k], rtol=1e-4, atol=1e-6)
        assert (close.all(-1) if close.ndim == 3 else close).mean() >= 0.99


@pytest.mark.gpu
def test_env_map_search_at_full_width(cuda):
    """render/lights.py's environment-map search on 2^20 lanes over a
    2048x1024 map: rows and columns on the card equal the CPU's, and the
    call's peak memory is far below the 8.6 GB that gathering one CDF
    row per lane would take."""
    from types import SimpleNamespace

    from statmc_tpu_torch.render import lights as TL

    rng = np.random.default_rng(0)
    He, We, R = 1024, 2048, 1 << 20
    w = rng.random((He, We)) ** 4 + 1e-12
    marg = w.sum(1)
    tables = dict(
        env_marginal_cdf=(np.cumsum(marg) / marg.sum()).astype(np.float32),
        env_cond_cdf=(np.cumsum(w, 1) / w.sum(1, keepdims=True)
                      ).astype(np.float32))
    u = rng.random((R, 2)).astype(np.float32)
    u[:4096, 0] = tables["env_cond_cdf"][rng.integers(0, He, 4096),
                                         rng.integers(0, We, 4096)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene = SimpleNamespace(**{k: torch.as_tensor(v, device=dev)
                                   for k, v in tables.items()})
        u_d = torch.as_tensor(u, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out[dev.type] = [x.cpu() for x in TL._env_sample(scene, u_d)]
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated() - base
            assert peak < 1 << 30, peak
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    assert out["cpu"][1].max() <= We - 1 and out["cpu"][0].max() <= He - 1


@pytest.mark.gpu
def test_hair_sss_render_card_matches_cpu(cuda, tmp_path):
    """The hair + SSS staircase (128 curves, kdsubsurface and subsurface
    spheres and boxes) at 32x24 on the card against the CPU: equal sample
    counts and ray totals, every buffer within rtol 1e-4 on 97% of its
    pixels (measured 97.79% at worst, its m3; the other scenes' 98-99%
    is not reached: the hair ribbons turn the card's ulps into larger
    differences, chip_smoke.py HAIR_SMALL_SHARE); kernels B1 and B2
    launched on the card."""
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.testscenes import hair_sss_scene_text

    path = tmp_path / "s.pbrt"
    path.write_text(hair_sss_scene_text(width=32, height=24, spp=2,
                                        iterations=2, maxdepth=4,
                                        filterradius=2, curves=128))
    runs = {}
    for dev in ("cuda", "cpu"):
        b1, b2 = spans.counted("kernel.B1"), spans.counted("kernel.B2")
        r = load(str(path), device=dev)
        r.progress = False
        runs[dev] = (r.render(verbose=False)[-1]["rays_total"], r.buffers())
        if dev == "cuda":
            assert spans.counted("kernel.B1") > b1
            assert spans.counted("kernel.B2") > b2
    assert runs["cuda"][0] == runs["cpu"][0]
    gpu, cpu = runs["cuda"][1], runs["cpu"][1]
    assert gpu.keys() == cpu.keys()
    for k in cpu:
        if k.endswith("-n"):
            np.testing.assert_array_equal(gpu[k], cpu[k])
            continue
        assert np.isfinite(gpu[k]).all(), k
        close = np.isclose(gpu[k], cpu[k], rtol=1e-4, atol=1e-6)
        assert (close.all(-1) if close.ndim == 3 else close).mean() >= 0.97


@pytest.mark.gpu
def test_b1_on_probe_chain_inputs(cuda, tmp_path):
    """B1 against its plain version, bit for bit, on the inputs of every
    intersect call that Sample_Sp's probe chain and the exit vertex's
    NEE make in one hair + SSS staircase iteration on the card: few live
    rays, starting just inside a surface, with short t_max."""
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.render import intersect as TX
    from statmc_tpu_torch.render import sss as TSS
    from statmc_tpu_torch.testscenes import hair_sss_scene_text

    path = tmp_path / "s.pbrt"
    path.write_text(hair_sss_scene_text(width=64, height=48, spp=1,
                                        iterations=1, maxdepth=4,
                                        denoise=False, curves=128))
    r = load(str(path), device="cuda")
    r.progress = False
    calls, inside = [], [False]
    real_fused = TX.intersect_fused

    def record(ft, o, d, t_max):
        if inside[0]:
            calls.append((ft, o.clone(), d.clone(), t_max.clone()))
        return real_fused(ft, o, d, t_max)

    def within(fn):
        def wrapped(*a, **k):
            inside[0] = True
            try:
                return fn(*a, **k)
            finally:
                inside[0] = False
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(TX, "intersect_fused", record)
    mp.setattr(TSS, "sample_sp", within(TSS.sample_sp))
    mp.setattr(TSS, "estimate_direct_sw", within(TSS.estimate_direct_sw))
    try:
        r.render(verbose=False)
    finally:
        mp.undo()
    assert len(calls) >= TSS.PROBE_STEPS + 2
    lives = []
    for ft, o, d, t_max in calls:
        raye, rayp = (x.contiguous() for x in TF.ray_features(o, d))
        args = (ft.edge_table, ft.plane_table, raye, rayp, t_max)
        t_k, id_k = TF.intersect_tiles(*args, ft.packed, ft.n_tris)
        t_p, id_p = TF.intersect_plain(*args, ft.n_tris)
        _bits_equal(t_k, id_k, t_p, id_p)
        lives.append(int((t_max > 0).sum()))
    assert 0 < max(lives) < 64 * 48  # few of the film's lanes fire


@pytest.mark.gpu
def test_volpath_render_card_matches_cpu(cuda, tmp_path):
    """The volpath staircase (haze, a 16^3 smoke behind a null box,
    Fourier spheres and boxes) at 32x24 on the card against the CPU:
    equal sample counts, ray totals within 0.1%, every buffer within rtol
    1e-4 on 98% of its pixels; kernels B1 and B2 launched on the card."""
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.testscenes import volpath_scene_text

    path = tmp_path / "s.pbrt"
    path.write_text(volpath_scene_text(str(tmp_path), width=32, height=24,
                                       spp=2, iterations=1, maxdepth=4,
                                       grid=16, filterradius=2))
    runs = {}
    for dev in ("cuda", "cpu"):
        b1, b2 = spans.counted("kernel.B1"), spans.counted("kernel.B2")
        r = load(str(path), device=dev)
        r.progress = False
        assert r.s.icfg.volumetric and r.s.scene.fourier is not None
        runs[dev] = (r.render(verbose=False)[-1]["rays_total"], r.buffers())
        if dev == "cuda":
            assert spans.counted("kernel.B1") > b1
            assert spans.counted("kernel.B2") > b2
    assert abs(runs["cuda"][0] - runs["cpu"][0]) <= 1e-3 * runs["cpu"][0]
    gpu, cpu = runs["cuda"][1], runs["cpu"][1]
    assert gpu.keys() == cpu.keys()
    for k in cpu:
        if k.endswith("-n"):
            np.testing.assert_array_equal(gpu[k], cpu[k])
            continue
        assert np.isfinite(gpu[k]).all(), k
        close = np.isclose(gpu[k], cpu[k], rtol=1e-4, atol=1e-6)
        assert (close.all(-1) if close.ndim == 3 else close).mean() >= 0.98, k


@pytest.mark.gpu
def test_b1_on_volpath_walk_inputs(cuda, tmp_path):
    """B1 against its plain version, bit for bit, on the inputs of every
    closest-hit call that the transmittance walks (shadow, phase-MIS and
    BSDF-MIS rays crossing null boundaries) make in the first bounce
    step of a volpath render on the card."""
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.render import intersect as TX
    from statmc_tpu_torch.render import volume as TV
    from statmc_tpu_torch.testscenes import volpath_scene_text

    path = tmp_path / "s.pbrt"
    path.write_text(volpath_scene_text(str(tmp_path), width=64, height=48,
                                       spp=1, iterations=1, maxdepth=4,
                                       grid=16, denoise=False))
    r = load(str(path), device="cuda")
    r.progress = False
    calls, inside = [], [False]
    real_fused, real_walk = TX.intersect_fused, TV.transmittance_walk
    real_step = TV._volpath_step

    def record(ft, o, d, t_max):
        if inside[0]:
            calls.append((ft, o.clone(), d.clone(), t_max.clone()))
        return real_fused(ft, o, d, t_max)

    def walk(*a, **k):
        inside[0] = True
        try:
            return real_walk(*a, **k)
        finally:
            inside[0] = False

    class Stop(Exception):
        pass

    def first_step(*a, **k):
        real_step(*a, **k)
        raise Stop()

    mp = pytest.MonkeyPatch()
    mp.setattr(TX, "intersect_fused", record)
    mp.setattr(TV, "transmittance_walk", walk)
    mp.setattr(TV, "_volpath_step", first_step)
    try:
        with pytest.raises(Stop):
            r.run_iteration(1)
    finally:
        mp.undo()
    assert len(calls) >= 4  # four walks, some of several segments
    for ft, o, d, t_max in calls:
        raye, rayp = (x.contiguous() for x in TF.ray_features(o, d))
        args = (ft.edge_table, ft.plane_table, raye, rayp, t_max)
        t_k, id_k = TF.intersect_tiles(*args, ft.packed, ft.n_tris)
        t_p, id_p = TF.intersect_plain(*args, ft.n_tris)
        _bits_equal(t_k, id_k, t_p, id_p)
    assert max(int((c[3] > 0).sum()) for c in calls) > 0


def _card_against_cpu(path, share=0.98):
    """load(path).render() on the card and on the CPU: equal ray totals,
    every buffer within rtol 1e-4 on >= share of its pixels; returns the
    card's renderer."""
    from statmc_tpu_torch.driver import load

    runs = {}
    for dev in ("cuda", "cpu"):
        r = load(path, device=dev)
        runs[dev] = (r, [x["rays_total"] for x in r.render(verbose=False)],
                     r.buffers())
    assert runs["cuda"][1] == runs["cpu"][1]
    gpu, cpu = runs["cuda"][2], runs["cpu"][2]
    assert gpu.keys() == cpu.keys()
    for k in cpu:
        close = np.isclose(gpu[k], cpu[k], rtol=1e-4, atol=1e-6)
        assert (close.all(-1) if close.ndim == 3 else close).mean() >= share
    return runs["cuda"][0]


def _launch_counts(reset=False):
    from statmc_tpu_torch.__main__ import launches

    return launches(reset)


@pytest.mark.gpu
def test_realistic_render_card_matches_cpu(cuda, tmp_path):
    """The realistic staircase (tests/fixtures/biconvex.dat) at 32x24 on
    the card against the CPU (chip_smoke.py's small rule); B1 and B2
    launch."""
    import os

    from statmc_tpu_torch import testscenes as TS

    lens = os.path.join(os.path.dirname(__file__), "fixtures",
                        "biconvex.dat")
    path = tmp_path / "s.pbrt"
    path.write_text(TS.realistic_scene_text(
        lens, width=32, height=24, spp=2, iterations=2, maxdepth=4,
        filterradius=2))
    _launch_counts(reset=True)
    r = _card_against_cpu(str(path))
    n = _launch_counts()
    assert r.s.cam.lens is not None and n["B1"] > 0 and n["B2"] > 0


@pytest.mark.gpu
def test_kdtree_render_card_matches_cpu(cuda, tmp_path):
    """The kd-tree staircase at 16x12 on the card against the CPU: the
    walk replaces B1, so B1 never launches; B2 does."""
    from statmc_tpu_torch import testscenes as TS
    from statmc_tpu_torch.accel.kdtree import KdTreeTris

    path = tmp_path / "s.pbrt"
    path.write_text(TS.kdtree_scene_text(width=16, height=12, spp=1,
                                         iterations=1, maxdepth=3,
                                         filterradius=2))
    _launch_counts(reset=True)
    r = _card_against_cpu(str(path))
    n = _launch_counts()
    assert isinstance(r.s.bvh, KdTreeTris)
    assert n["B1"] == 0 and n["B2"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cossample", [True, False])
def test_ao_render_card_matches_cpu(cuda, cossample, tmp_path):
    from statmc_tpu_torch import testscenes as TS

    path = tmp_path / "s.pbrt"
    path.write_text(TS.ao_scene_text(nsamples=8, cossample=cossample,
                                     width=16, height=12, spp=2,
                                     iterations=2))
    _launch_counts(reset=True)
    _card_against_cpu(str(path))
    assert _launch_counts()["B1"] > 0


@pytest.mark.gpu
def test_sppm_render_card_matches_cpu(cuda, tmp_path):
    """Two SPPM passes at 16x12 on the card against the CPU, and the
    grid deposit run twice on the card, bit for bit."""
    from statmc_tpu_torch import testscenes as TS
    from statmc_tpu_torch.driver import load

    path = tmp_path / "s.pbrt"
    path.write_text(TS.sppm_scene_text(width=16, height=12, spp=1,
                                       photons=4096, radius=0.3))
    _launch_counts(reset=True)
    _card_against_cpu(str(path))
    assert _launch_counts()["B1"] > 0
    films = []
    for _ in range(2):
        r = load(str(path), device="cuda")
        r.run_iteration(1)
        films.append((r.tau.cpu(), r.n_acc.cpu()))
    assert torch.equal(films[0][0], films[1][0])
    assert torch.equal(films[0][1], films[1][1])


@pytest.mark.gpu
def test_bdpt_render_card_matches_cpu(cuda, tmp_path):
    """The bdpt staircase at 32x24 (maxdepth 4, 2 iterations) on the card
    against the CPU (B1 launches), and iteration 1 run twice on the card
    (two renderers) bit for bit: the t = 1 splats are summed in lane
    order, without atomics."""
    from statmc_tpu_torch import testscenes as TS
    from statmc_tpu_torch.driver import load

    path = tmp_path / "s.pbrt"
    path.write_text(TS.bdpt_scene_text(width=32, height=24, spp=1,
                                       maxdepth=4, iterations=2))
    _launch_counts(reset=True)
    _card_against_cpu(str(path))
    assert _launch_counts()["B1"] > 0
    runs = []
    for _ in range(2):
        r = load(str(path), device="cuda")
        r.run_iteration(1)
        runs.append((r.film_sum.cpu(), r.splat_sum.cpu()))
    assert runs[0][1].sum() > 0
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("bidirectional", [True, False])
def test_mlt_first_step_card_matches_cpu(cuda, bidirectional, tmp_path,
                                         monkeypatch):
    """MLT at 32x24 with 512 chains and a 4,096-path bootstrap on the card
    and on the CPU: the bootstrap's seeded chains and b, then the first
    mutation step's proposals equal and its accepts and splat per pixel
    close; the card repeats itself bit for bit."""
    from statmc_tpu_torch import testscenes as TS
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.render import pssmlt as PM

    monkeypatch.setattr(PM, "N_CHAINS", 512)
    monkeypatch.setattr(PM, "N_BOOTSTRAP", 4096)
    path = tmp_path / "s.pbrt"
    path.write_text(TS.mlt_scene_text(bidirectional, width=32, height=24,
                                      spp=1, maxdepth=4))
    out = {}
    for dev in ("cuda", "cpu", "cuda"):
        r = load(str(path), device=dev)
        r._bootstrap()
        ch = r.step(r._chains, _mlt_key(dev))
        out.setdefault(dev, []).append(
            (r.b, [x.cpu() for x in ch], r.splat.cpu()))
    (b_g, ch_g, sp_g), (b_g2, ch_g2, sp_g2) = out["cuda"]
    b_c, ch_c, sp_c = out["cpu"][0]
    assert b_g == b_g2 and all(torch.equal(a, b) for a, b in zip(ch_g, ch_g2))
    assert torch.equal(sp_g, sp_g2)
    assert abs(b_g - b_c) <= 1e-4 * b_c
    same = (ch_g[0] == ch_c[0]).all(-1).float().mean()
    assert same >= 0.98
    close = np.isclose(sp_g.numpy(), sp_c.numpy(), rtol=1e-4, atol=1e-6)
    assert close.all(-1).mean() >= 0.98


def _mlt_key(dev):
    from statmc_tpu_torch.core import rng as crng

    return crng.base_key(17, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n_spp,n_px", [(1, 1), (2, 2)])
def test_mesh_on_the_card_matches_one_device(cuda, n_spp, n_px, tmp_path):
    """Renderer(mesh=) on the card: a world of one over NCCL, and 2x2 with
    four ranks on cuda:0 over gloo (row slabs with a halo exchange),
    against the one-device render of a 32x24 staircase with ACRR, SMIS
    and a denoise: n exact; after iteration 1 film within rtol 1e-4 /
    atol 1e-5 on every pixel; after iteration 2 film, film-f and the ACRR
    feedback on >= 99.5% (the filter's skew correction and an RR or ACRR
    decision may turn on the rounding of Chan's merge against Meng's);
    B1 and B2 launched on every rank."""
    from statmc_tpu_torch import driver as TD
    from statmc_tpu_torch.parallel import launch
    from statmc_tpu_torch.testscenes import scene_text

    path = tmp_path / "s.pbrt"
    path.write_text(scene_text(
        width=32, height=24, spp=2, iterations=2, maxdepth=4, denoise=True,
        filterradius=2, extra_integrator='"bool acrr" ["true"] '
        '"integer trackedbounces" [3] "bool smis" ["true"] '))
    out = tmp_path / "mesh.pt"
    launch.run_world(launch.render_task, n_spp, n_px, (str(path), str(out)),
                     devices=[cuda] * (n_spp * n_px), timeout=600)
    got = torch.load(out, weights_only=False)
    assert all(c["B1"] > 0 and c["B2"] > 0 for c in got["launches"])
    r = TD.load(str(path))
    r.progress = False
    for i, it in enumerate(got["iterations"], 1):
        r.run_iteration(i)
        assert torch.equal(it["n"], r.states[0]["n"].cpu())
        for k in (("film",) if i == 1 else ("film", "film_f", "avg_ls")):
            ref = (r.film_mean if k == "film" else getattr(r, k)).cpu()
            close = torch.isclose(it[k], ref.reshape(it[k].shape),
                                  rtol=1e-4, atol=1e-5)
            share = float(close.reshape(close.shape[0], -1).all(-1).float()
                          .mean())
            assert share == 1.0 if i == 1 else share >= 0.995, (i, k, share)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["matte", "metal", "glass", "hair"])
def test_albedo_lut_card_matches_cpu(cuda, family):
    """precompute_family_nd at 3 texels an axis and 64 samples on the
    card and on the CPU (the same threefry draws): every texel within
    1e-3, as chip_smoke.py holds, and >= 95% within rtol 1e-4 (the card
    rounds its transcendentals otherwise; chip_smoke.py measured 100%
    for matte, metal and hair and 96.98% for glass, whose small table
    has 144 texels in (0, 1e-3)); the lookup of 4,096 coordinates within
    1e-5 of the CPU's on the CPU's table."""
    from statmc_tpu_torch.render import albedo_lut as TA

    sizes = (3,) * len(TA.FAMILY_AXES[family])
    gpu = TA.precompute_family_nd(family, sizes, n_samples=64, seed=3,
                                  device=cuda).data.cpu()
    cpu = TA.precompute_family_nd(family, sizes, n_samples=64, seed=3,
                                  device="cpu")
    close = torch.isclose(gpu, cpu.data, rtol=1e-4, atol=0.0)
    assert float(close.float().mean()) >= 0.95
    assert float((gpu - cpu.data).abs().max()) <= 1e-3
    c = torch.rand((4096, len(sizes)), generator=torch.Generator()
                   .manual_seed(1))
    on_card = TA.LookupTable(cpu.data.to(cuda), sizes).lookup(c.to(cuda))
    torch.testing.assert_close(on_card.cpu(), cpu.lookup(c), rtol=0,
                               atol=1e-5)


@pytest.mark.gpu
def test_precompute_tool_and_bsdftest_on_the_card(cuda, tmp_path, capsys):
    """The two tools without --device run on the card: the precompute's
    self-tests pass on a small mirror table, bsdftest's five materials
    are consistent."""
    from statmc_tpu_torch.tools import bsdftest, precomputealbedo

    assert precomputealbedo.main(["--family", "mirror", "--sizes", "3", "5",
                                  "--samples", "64", "--compare",
                                  "--testlut"]) == 0
    assert "testlut: grid round trip OK" in capsys.readouterr().out
    for name in bsdftest.MATERIALS:
        assert bsdftest.main([name]) == 0


_R1_EDGE_KEYS = ((0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0, 0xFFFFFFFF),
                 (0xFFFFFFFF, 0))


def _r1_inputs(index, P):
    """Keys [P, 2] of uint32 words (the first lanes' 0 and 0xFFFFFFFF),
    the index (0xFFFFFFFF as a Python int, or int32 / int64 [P] holding
    0, -1 and the type's largest value among random ones) and pixel ids
    [P] int32, on the CPU."""
    rng = np.random.default_rng(P)
    keys = rng.integers(0, 1 << 32, size=(P, 2), dtype=np.int64)
    n = min(P, len(_R1_EDGE_KEYS))
    keys[:n] = _R1_EDGE_KEYS[:n]
    idx = 0xFFFFFFFF
    if index != "scalar":
        dt = np.int32 if index == "int32" else np.int64
        top = int(np.iinfo(dt).max)
        x = rng.integers(-(1 << 31), 1 << 31, size=P, dtype=np.int64)
        x[:min(P, 3)] = (0, -1, top)[:min(P, 3)]
        idx = torch.as_tensor(x.astype(dt))
    pid = torch.as_tensor(rng.integers(0, 1 << 31, size=P, dtype=np.int64)
                          .astype(np.int32))
    return torch.as_tensor(keys), idx, pid


def _r1_call(entry, index, keys, idx, pid):
    from statmc_tpu_torch.core import rng as crng

    if entry == "uniform_1d":
        return crng.uniform_1d(keys, idx, crng.SLOT_RR)
    if entry == "uniform_2d":
        return crng.uniform_2d(keys, idx, crng.SLOT_BSDF)
    if entry == "pixel_keys":
        return crng.pixel_keys(keys[min(1, keys.shape[0] - 1)], pid, idx)
    if entry == "fold_in":
        return crng.fold_in(keys, idx)
    # uniform(key, (k,)): one key's k = P counters (spread over threads),
    # or 5 counters of every key.
    if index == "scalar":
        return crng.uniform(keys[min(1, keys.shape[0] - 1)],
                            (keys.shape[0],))
    return crng.uniform(keys, (5,))


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 1000, 921600])
@pytest.mark.parametrize("index", ["scalar", "int32", "int64"])
@pytest.mark.parametrize("entry", ["uniform_1d", "uniform_2d", "pixel_keys",
                                   "fold_in", "uniform"])
def test_r1_kernel_matches_plain(cuda, entry, index, P):
    """Kernel R1 against the plain int64 version on the CPU, bit for bit
    (keys as int64, uniforms as their float32 bits), one launch a call."""
    cpu = _r1_inputs(index, P)
    card = [x.to(cuda) if torch.is_tensor(x) else x for x in cpu]
    before = spans.counted("kernel.R1")
    got = _r1_call(entry, index, *card)
    assert spans.counted("kernel.R1") == before + 1
    want = _r1_call(entry, index, *cpu)
    got = got.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_r1_broadcast_operands_match_plain(cuda):
    """The callers' other shapes through R1, against the plain version:
    volume.py's [L, C] fold (keys over a new axis, a row of iteration
    words), keys at an offset and with their words apart, strided words,
    a 0-d word on the card and one on the CPU, uint8 words, and a shaped
    uniform of per-lane keys (albedo_lut.py)."""
    from statmc_tpu_torch.core import rng as crng

    keys, idx, pid = _r1_inputs("int64", 1000)
    its = torch.arange(3, 11)
    cases = [
        lambda k, i, p, d: crng.fold_in(k[:, None, :], its.to(d)[None, :]),
        lambda k, i, p, d: crng.fold_in(k[7:507], p[:500]),
        lambda k, i, p, d: crng.uniform_2d(k.t().contiguous().t(), i, 4),
        lambda k, i, p, d: crng.uniform_1d(k[:500], i[::2], 3),
        lambda k, i, p, d: crng.uniform_2d(k, torch.tensor(6, device=d), 2),
        lambda k, i, p, d: crng.uniform_2d(k, torch.tensor(6), 2),
        lambda k, i, p, d: crng.fold_in(k, p.to(torch.uint8)),
        lambda k, i, p, d: crng.uniform(crng.fold_in(k[:64], 1), (7, 2)),
    ]
    for n, case in enumerate(cases):
        got = case(*(x.to(cuda) for x in (keys, idx, pid)), cuda).cpu()
        want = case(keys, idx, pid, "cpu")
        if want.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert got.shape == want.shape and torch.equal(got, want), n


@pytest.mark.gpu
def test_r1_launches_are_the_draws_and_pixel_keys(cuda, tmp_path,
                                                  monkeypatch):
    """A random-mode render on the card: kernel.R1 counts every launch,
    one for each site_hash call (each draw site and pixel_keys call) the
    same render makes on the CPU, plus the draws of the one step each
    graph key runs op by op before it captures (render/bounce_graphs.py);
    every bounce step replays, and the render matches the CPU's sample
    counts and ray total."""
    from statmc_tpu_torch.core import rng as crng
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.render import bounce_graphs as BG

    path = _small_staircase(tmp_path, "random")
    calls = [0]
    site_hash = crng.site_hash

    def counted(*a, **k):
        calls[0] += 1
        return site_hash(*a, **k)

    runs = {}
    for dev in ("cpu", "cuda"):
        r = load(path, device=dev)
        r.progress = False
        if dev == "cuda":
            cpu_calls = calls[0]
            BG.clear()
            spans.disable()
            spans.reset()
            spans.enable()
        else:
            monkeypatch.setattr(crng, "site_hash", counted)
        try:
            runs[dev] = (r.render(verbose=False)[-1]["rays_total"],
                         r.buffers())
            snap = spans.snapshot()
        finally:
            monkeypatch.undo()
            spans.disable()
            spans.reset()
    c = snap["counters"]
    steps = sum(s["name"] == "integrator.bounce_step" for s in snap["spans"])
    draws = sum(s["name"] == "rng.draw" for s in snap["spans"])
    twins = sum(sum(g.r1) for g in BG._CACHE.values())
    assert cpu_calls > 0 and draws > 0 and twins > 0 and steps > 0
    assert c["kernel.R1"] == cpu_calls + twins
    assert c["graph.bounce.replay"] == steps
    assert c["graph.bounce.capture"] == 4 * len(BG._CACHE)
    assert c.get("graph.bounce.eager", 0) == 0
    assert runs["cuda"][0] == runs["cpu"][0]
    for k, v in runs["cpu"][1].items():
        if k.endswith("-n"):
            np.testing.assert_array_equal(runs["cuda"][1][k], v)


def _bounce_run(s, cfg, driver, feedback_on):
    """Two samples a lane of the small scene `s` through trace_wavefront
    (a [P] step; every record_fn call's outputs) or through trace (an int
    step; each sample's outputs)."""
    import test_torch_bounce_graphs as TB

    from statmc_tpu_torch.core import rng as crng
    from statmc_tpu_torch.render import camera as CAM
    from statmc_tpu_torch.render import integrator as INT

    if driver == "trace":
        outs = []
        for sample in (0, 1):
            carry, keys, avg, wb, wl, ld = TB.step_inputs(s, cfg, sample)
            outs.append(tuple(INT.trace(
                s.scene, s.bvh, s.dist, cfg, carry["o"], carry["d"], keys,
                avg, wb, wl, feedback_on, albedo_luts=s.albedo_luts,
                ld_stream=ld)))
        return tuple(outs)
    P, dev = s.width * s.height, s.device
    _, _, avg, wb, wl, _ = TB.step_inputs(s, cfg)
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    pxy = torch.stack([(ids % s.width).to(torch.float32),
                       (ids // s.width).to(torch.float32)], -1)
    recs = []

    def record(out, done):
        recs.append((tuple(t.clone() for t in out), done.clone()))

    INT.trace_wavefront(s.scene, s.bvh, s.dist, cfg,
                        lambda u: CAM.generate_rays(s.cam, pxy + u), ids,
                        crng.base_key(7, dev), 0, 2, avg, wb, wl,
                        feedback_on, record, albedo_luts=s.albedo_luts)
    return tuple(recs)


@pytest.mark.gpu
@pytest.mark.parametrize("feedback_on", [False, True])
@pytest.mark.parametrize("driver", ["wavefront", "trace"])
@pytest.mark.parametrize("scene", ["staircase", "terrain"])
def test_bounce_graphs_match_eager_step(cuda, scene, driver, feedback_on,
                                        tmp_path, monkeypatch):
    """The bounce step replayed from CUDA graphs against the eager step
    on the card, bit for bit, on the small staircase (B1) and terrain (B3
    + B4): two samples through trace_wavefront and through trace, with
    ACRR and SMIS configured and feedback off and on.  Counters: the
    four segments captured once, every step replayed, none eager (and
    every step eager where the rule is made to refuse)."""
    import test_torch_bounce_graphs as TB

    from statmc_tpu_torch.render import bounce_graphs as BG

    s = TB.setup(tmp_path, scene, device="cuda")
    cfg = TB.feedback_config(s.icfg)
    runs = {}
    for mode in ("graph", "eager"):
        BG.clear()
        spans.reset("graph.")
        if mode == "eager":
            monkeypatch.setattr(BG, "eager_reason", lambda *a: "compared")
        out = _bounce_run(s, cfg, driver, feedback_on)
        runs[mode] = (out, [spans.counted(k) for k in GRAPH_COUNTERS])
    assert TB.same(runs["graph"][0], runs["eager"][0])
    steps = runs["eager"][1][2]
    assert steps > 0 and runs["eager"][1] == [0, 0, steps]
    assert runs["graph"][1] == [4, steps, 0]


@pytest.mark.gpu
def test_bounce_graphs_make_every_query(cuda, tmp_path, monkeypatch):
    """With wrappers over integrator.intersect_scene and occluded_scene,
    as the benchmark's check installs them, the replayed step makes its
    three queries a step through them (two-level terrain, trace), with
    the same arguments and answers as the eager step."""
    import test_torch_bounce_graphs as TB

    from statmc_tpu_torch.render import bounce_graphs as BG
    from statmc_tpu_torch.render import integrator as INT

    s = TB.setup(tmp_path, "terrain", device="cuda")
    cfg = s.icfg
    isect, occl = INT.intersect_scene, INT.occluded_scene
    logs = {}
    for mode in ("graph", "eager"):
        kinds, seen = [], []

        def intersect_scene(scene, o, d, t_max, bvh, *a, **kw):
            hit = isect(scene, o, d, t_max, bvh, *a, **kw)
            kinds.append("lean" if kw.get("lean") else "closest")
            seen.append((o.clone(), d.clone(), t_max.clone(),
                         tuple(x.clone() for x in hit if x is not None)))
            return hit

        def occluded_scene(scene, o, d, t_max, bvh, *a, **kw):
            blocked = occl(scene, o, d, t_max, bvh, *a, **kw)
            kinds.append("occluded")
            seen.append((o.clone(), d.clone(), t_max.clone(),
                         (blocked.clone(),)))
            return blocked

        monkeypatch.setattr(INT, "intersect_scene", intersect_scene)
        monkeypatch.setattr(INT, "occluded_scene", occluded_scene)
        if mode == "eager":
            monkeypatch.setattr(BG, "eager_reason", lambda *a: "compared")
        BG.clear()
        _bounce_run(s, cfg, "trace", False)
        logs[mode] = (kinds, tuple(seen))
    steps = 2 * (cfg.max_depth + 1 + cfg.null_extra)
    assert logs["graph"][0] == ["closest", "occluded", "lean"] * steps
    assert logs["eager"][0] == logs["graph"][0]
    assert TB.same(logs["graph"][1], logs["eager"][1])
