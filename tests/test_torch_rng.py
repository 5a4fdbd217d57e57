"""statmc_tpu_torch.core.rng against jax.random: bit-exact keys and
uniforms (random mode), under the JAX package's threefry setting
(jax_threefry_partitionable=True, set in conftest)."""
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
