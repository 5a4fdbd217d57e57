"""statmc_tpu_torch.core.rng against jax.random: bit-exact keys and
uniforms (random mode), under the JAX package's threefry setting
(jax_threefry_partitionable=True, set in conftest)."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statmc_tpu.core import rng as J
from statmc_tpu_torch.core import rng as T

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_base_and_pixel_keys_bit_exact(seed):
    rng = np.random.default_rng(seed % 1000)
    pid = rng.integers(0, 1 << 21, size=257).astype(np.int32)
    kj, kt = J.base_key(seed), T.base_key(seed)
    np.testing.assert_array_equal(np.asarray(kj).astype(np.int64), kt.numpy())
    for s in (0, 3, 1 << 20):
        np.testing.assert_array_equal(
            np.asarray(J.pixel_keys(kj, jnp.asarray(pid), s)),
            T.pixel_keys(kt, torch.as_tensor(pid), s).numpy())
    svec = rng.integers(0, 64, size=257).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(J.pixel_keys(kj, jnp.asarray(pid), jnp.asarray(svec))),
        T.pixel_keys(kt, torch.as_tensor(pid), torch.as_tensor(svec)).numpy())


@pytest.mark.parametrize("slot", [0, 1, 2, 5, 7])
def test_site_draws_bit_exact(slot):
    rng = np.random.default_rng(slot)
    pid = jnp.arange(300, dtype=jnp.int32)
    keys = J.pixel_keys(J.base_key(11), pid, 2)
    bounce = rng.integers(0, 9, size=300).astype(np.int32)
    for b in (0, 4, jnp.asarray(bounce)):
        bt = torch.as_tensor(np.asarray(b)) if not isinstance(b, int) else b
        np.testing.assert_array_equal(
            np.asarray(J._site_keys(keys, b, slot)),
            T._site_keys(_t(keys), bt, slot).numpy())
        np.testing.assert_array_equal(
            np.asarray(J.draw_1d(keys, None, J.MODE_RANDOM, b, slot)),
            T.uniform_1d(_t(keys), bt, slot).numpy())
        np.testing.assert_array_equal(
            np.asarray(J.draw_2d(keys, None, J.MODE_RANDOM, b, slot)),
            T.uniform_2d(_t(keys), bt, slot).numpy())


def test_shaped_uniform_of_albedo_precompute_bit_exact():
    """albedo_lut._mc_albedo draws uniform(fold_in(key, i), (G, 2)) and
    uniform(fold_in(fold_in(key, i), 1), (G,))."""
    key = jax.random.PRNGKey(3)
    kt = T.base_key(3)
    for i in (0, 1, 511):
        k = jax.random.fold_in(key, i)
        ktt = T.fold_in(kt, i)
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(k, (37, 2))),
            T.uniform(ktt, (37, 2)).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (37,))),
            T.uniform(T.fold_in(ktt, 1), (37,)).numpy())
    # Batched keys, as _mc_albedo draws them.
    ks = T.fold_in(kt.expand(4, 2), torch.arange(4))
    for i in range(4):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (5, 2))),
            T.uniform(ks, (5, 2))[i].numpy())


@pytest.mark.parametrize("key, ctr, want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_plain_threefry_known_answers(key, ctr, want):
    """The plain threefry2x32 (20 rounds), kernel R1's reference, against
    Random123's known-answer vectors for Threefry-2x32-20, on int64
    tensors of uint32 values as the port keeps them."""
    a, b = T.threefry2x32(*(torch.tensor([v], dtype=torch.int64)
                            for v in (*key, *ctr)))
    assert (int(a), int(b)) == want


def _strided_rows(x, div, mod, batch, inner):
    """What kernel R1 reads for each lane of `batch`: row (l // div) % mod
    of the rows of `inner` elements laid out from x's first element."""
    rows = x.as_strided((mod, inner), (inner, 1))
    lanes = torch.arange(int(np.prod(batch, dtype=np.int64)))
    return rows[(lanes // div) % mod]


_P, _I = 6, 5
_BIG = torch.arange(40 * 2, dtype=torch.int64).reshape(40, 2)
_W = torch.arange(40, dtype=torch.int32)


@pytest.mark.parametrize("name, x, batch, inner, copied", [
    ("per-lane keys", _BIG[:_P], (_P,), 2, False),
    ("keys at an offset", _BIG[7:7 + _P], (_P,), 2, False),
    ("one key", _BIG[3], (_P,), 2, False),
    ("expanded key", _BIG[3].expand(_P, 2), (_P,), 2, False),
    ("keys over a new axis", _BIG[:_P, None, :], (_P, _I), 2, False),
    ("keys with a middle 1", _BIG[:_P].reshape(3, 1, 2, 2), (3, 1, 2), 2,
     False),
    ("keys, words apart", _BIG[:_P].t().contiguous().t(), (_P,), 2, True),
    ("per-lane words", _W[:_P], (_P,), 1, False),
    ("words over a new axis", _W[None, :_I], (_P, _I), 1, False),
    ("words over the first axis", _W[:_P, None], (_P, _I), 1, False),
    ("a 0-d word", _W[2], (_P, _I), 1, False),
    ("every other word", _W[:2 * _P:2], (_P,), 1, True),
    ("words on two axes apart", _W[:12].reshape(3, 1, 4), (3, 2, 4), 1,
     True),
])
def test_r1_operand_rows(name, x, batch, inner, copied):
    """R1's wrapper reads a broadcast key or word in place, by (l // div)
    % mod, and copies only an operand whose dimensions it cannot index
    so: every lane reads what the broadcast operand holds there."""
    xp, div, mod = T._rows(x, batch, inner, int(np.prod(batch)))
    want = (x.expand(*batch, inner) if inner > 1
            else x.expand(batch)).reshape(-1, inner)
    assert torch.equal(_strided_rows(xp, div, mod, batch, inner), want), name
    assert (xp.data_ptr() != x.data_ptr()) == copied, name


@pytest.mark.parametrize("shapes", [
    [(6,), (6,)], [(6,), ()], [(), ()], [(6, 1), (1, 5)], [(6, 1), (5,)],
    [(3, 1, 2), (2,), ()], [(0,), ()], [(6,), (1,)], [(6,), (5,)],
    [(6, 1), (1, 5), (4, 1)],
])
def test_r1_broadcast_shapes(shapes):
    """The wrapper's shape broadcast equals torch.broadcast_shapes, and
    refuses what it refuses."""
    try:
        want = tuple(torch.broadcast_shapes(*shapes))
    except RuntimeError:
        with pytest.raises(ValueError):
            T._broadcast(shapes)
        return
    assert T._broadcast(shapes) == want


def test_every_random_draw_is_one_site_hash(monkeypatch):
    """In a random-mode render each rng.draw and each pixel_keys call is
    one site_hash call, one launch of R1 on the card, and nothing else
    hashes: the count the card's kernel.R1 shows."""
    from statmc_tpu_torch import spans
    from statmc_tpu_torch.driver import load
    from statmc_tpu_torch.testscenes import scene_text

    calls = {"site_hash": 0, "pixel_keys": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.pbrt")
        with open(path, "w") as f:
            f.write(scene_text(width=8, height=6, spp=2, iterations=1,
                               maxdepth=3, denoise=False))
        r = load(path, device="cpu")  # the albedo curves hash at load
    r.progress = False
    monkeypatch.setattr(T, "site_hash", counted("site_hash", T.site_hash))
    monkeypatch.setattr(T, "pixel_keys", counted("pixel_keys", T.pixel_keys))
    spans.disable()
    spans.reset()
    spans.enable()
    try:
        r.render(verbose=False)
        draws = sum(s["name"] == "rng.draw"
                    for s in spans.snapshot()["spans"])
    finally:
        spans.disable()
        spans.reset()
    assert draws > 0 and calls["pixel_keys"] > 0
    assert calls["site_hash"] == draws + calls["pixel_keys"]
