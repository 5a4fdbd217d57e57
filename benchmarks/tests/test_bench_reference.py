"""The plain reference against direct loops, and the B2 count."""
import itertools
import math

import numpy as np
import pytest
import torch

from statbench import peaks, reference as ref


def _frame(H, W, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((4, H, W, 3), generator=g, dtype=torch.float64) * 3
    x[:, : H // 2] *= 8  # an edge, so that some pairs are rejected
    st = ref.moments(x.reshape(4, H * W, 3).transpose(0, 1),
                     torch.ones((H * W, 4), dtype=torch.bool), True)
    mc, d = ref.corrected_stats(st["n"], st["mean"], st["m2"], st["m3"],
                                ref.t_quantiles())
    gb = torch.rand((H, W, 6), generator=g, dtype=torch.float64)
    return (mc.reshape(H, W, 3), d.reshape(H, W, 3),
            st["film_mean"].reshape(H, W, 3), gb)


def test_filter_matches_double_loop():
    H, W, r = 12, 16, 3
    mc, d, fm, gb = _frame(H, W, 1)
    sds, fsd = [0.1] * 3 + [0.02] * 3, 2.0
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    out, acc, ins = ref.filter_at(ys.reshape(-1), xs.reshape(-1), mc, d, fm,
                                  gb, sds, r, fsd)
    for y, x in itertools.product(range(H), range(W)):
        num, den, n_acc = np.zeros(3), 0.0, 0
        for dy, dx in itertools.product(range(-r, r + 1), repeat=2):
            j, i = y + dy, x + dx
            if not (0 <= j < H and 0 <= i < W):
                continue
            ok = all((mc[y, x, c] - mc[j, i, c]) ** 2
                     <= d[y, x, c] ** 2 + d[j, i, c] ** 2 + 1e-20
                     for c in range(3))
            if not ok:
                continue
            n_acc += 1
            arg = -0.5 * (dy * dy + dx * dx) / fsd ** 2
            arg += sum(-0.5 / sds[g] ** 2 * float(gb[y, x, g] - gb[j, i, g])
                       ** 2 for g in range(6))
            w = math.exp(arg)
            num += w * fm[j, i].numpy()
            den += w
        k = y * W + x
        assert int(acc[k]) == n_acc
        np.testing.assert_allclose(out[k].numpy(), num / max(den, 1e-20),
                                   rtol=1e-12)
    assert 0 < int(acc.sum()) < int(ins.sum())


def test_b2_count_matches_brute_force():
    H, W, r = 12, 16, 3
    mc, d, _, _ = _frame(H, W, 2)
    pairs = accepted = 0
    for y, x in itertools.product(range(H), range(W)):
        for dy, dx in itertools.product(range(-r, r + 1), repeat=2):
            j, i = y + dy, x + dx
            if 0 <= j < H and 0 <= i < W:
                pairs += 1
                accepted += all(
                    (mc[y, x, c] - mc[j, i, c]) ** 2
                    <= d[y, x, c] ** 2 + d[j, i, c] ** 2 + 1e-20
                    for c in range(3))
    assert ref.accepted_pairs(mc, d, r) == (pairs, accepted)
    assert peaks.b2_ops(pairs, accepted) == 15 * pairs + 43 * accepted
    assert peaks.b2_bytes(H * W, 3, 3, 6) == 4 * H * W * (3 + 3 + 3 + 6 + 1
                                                           + 3 + 1)


def test_moments_two_pass():
    g = np.random.default_rng(3)
    x = g.random((5, 7, 3)) * 4
    mask = g.random((5, 7)) > 0.3
    st = ref.moments(torch.as_tensor(x), torch.as_tensor(mask), True)
    for k in range(5):
        s = x[k][mask[k]]
        y = 2 * (np.sqrt(s) - 1)
        mu = y.mean(0)
        assert st["n"][k] == mask[k].sum()
        np.testing.assert_allclose(st["mean"][k], mu, rtol=1e-12)
        np.testing.assert_allclose(st["m2"][k], ((y - mu) ** 2).sum(0),
                                   rtol=1e-12)
        np.testing.assert_allclose(st["m3"][k], ((y - mu) ** 3).sum(0),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(st["film_mean"][k], s.mean(0), rtol=1e-12)


def test_closest_hits_direct():
    tris = torch.tensor([[[0., 0, 5], [2, 0, 5], [0, 2, 5]],
                         [[0., 0, 3], [2, 0, 3], [0, 2, 3]]],
                        dtype=torch.float64)
    centres = torch.tensor([[5., 5, 4]], dtype=torch.float64)
    radii = torch.tensor([1.0], dtype=torch.float64)
    o = torch.tensor([[0.5, 0.5, 0], [0.5, 0.5, 0], [5, 5, 0], [9, 9, 0],
                      [0.5, 0.5, 4]], dtype=torch.float64)
    d = torch.tensor([[0., 0, 1]] * 5, dtype=torch.float64)
    tm = torch.tensor([1e30, 2.0, 1e30, 1e30, 1e30], dtype=torch.float64)
    t, kind, _ = ref.closest_hits(o, d, tm, tris, centres, radii)
    assert kind.tolist() == [1, 0, 2, 0, 1]
    assert t[0] == 3 and t[2] == 3 and t[4] == 1
    t16, k16, _ = ref.closest_hits(o, d, tm, tris, centres, radii,
                                torch.bfloat16)
    assert k16.tolist() == kind.tolist()


@pytest.mark.parametrize("key, ctr, want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    """The path reference's threefry-2x32 (20 rounds) against Random123's
    known-answer vectors."""
    from statbench import pathref

    got = pathref.threefry2x32(key[0], key[1], ctr[0], ctr[1])
    assert (int(got[0]), int(got[1])) == want


def test_camera_centre_ray_looks_at_the_target():
    """The reference camera's ray through the image's centre points from
    the eye to LookAt's target; rays through the corners spread by the
    fov along the shorter axis."""
    from statbench import pathref

    W, H, fov = 64, 36, 55.0
    cam = pathref._camera([6.5, 4.5, -7.5], [-1, 2.5, 0], [0, 1, 0], fov, W,
                          H)
    sc = type("S", (), {"camera": cam, "width": W})()
    # The centre of the image is the corner of its four middle pixels.
    o, d = pathref.camera_rays(sc, np.array([(H // 2) * W + W // 2]),
                               np.zeros((1, 2)))
    want = np.array([-7.5, -2.0, 7.5])
    assert np.allclose(d[0], want / np.linalg.norm(want), atol=1e-12)
    assert np.allclose(o[0], [6.5, 4.5, -7.5])
    _, top = pathref.camera_rays(sc, np.array([W // 2]), np.array([[0, 0]]))
    assert math.degrees(math.acos(float(top[0] @ d[0]))) == \
        pytest.approx(fov / 2, abs=1e-9)
