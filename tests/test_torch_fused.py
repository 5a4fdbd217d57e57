"""Kernel B1's plain PyTorch version (statmc_tpu_torch/accel/fused.py)
against the JAX package's fused intersector: the pure-jnp reference
_intersect_ref and the Pallas kernel in interpret mode, on
tests/test_fused.py's random 500-triangle scene with 1,024 rays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statmc_tpu.accel import fused as JF
from statmc_tpu_torch import convert
from statmc_tpu_torch.accel import fused as TF

torch.set_num_threads(2)


def _scene(rng, n_tris=500, n_rays=1024):
    p0 = ((rng.random((n_tris, 3)) * 2 - 1) * 4.0).astype(np.float32)
    e1 = ((rng.random((n_tris, 3)) * 2 - 1) * 0.8).astype(np.float32)
    e2 = ((rng.random((n_tris, 3)) * 2 - 1) * 0.8).astype(np.float32)
    o = ((rng.random((n_rays, 3)) * 2 - 1) * 6.0).astype(np.float32)
    d = (rng.random((n_rays, 3)) * 2 - 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # t_max mix: unbounded (the integrator's INF), cut short, dead lanes.
    kind = np.arange(n_rays) % 4
    t_max = np.where(kind == 0, 1e30, np.where(
        kind == 1, rng.uniform(0.5, 6.0, n_rays), np.where(
            kind == 2, 0.0, 1e30))).astype(np.float32)
    return (p0, e1, e2), o, d, t_max


def test_tables_identical_to_jax():
    tris, *_ = _scene(np.random.default_rng(5))
    jf, tf = JF.FusedTris.from_tris(*tris), TF.FusedTris.from_tris(*tris)
    for name in ("edge_table", "plane_table", "tile_bounds", "perm"):
        np.testing.assert_array_equal(np.asarray(getattr(jf, name)),
                                      np.asarray(getattr(tf, name)))
    assert jf.n_tris == tf.n_tris
    cf = convert.fused_tris(jf)
    np.testing.assert_array_equal(cf.edge_table.numpy(), tf.edge_table)


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_b1_matches_jax_ref_and_pallas_interpret(seed):
    """Ids equal on >= 99.9% of rays and t within rtol 1e-6 where they
    agree.  The plain version evaluates each dot as the fused
    multiply-add chain that XLA's CPU dot also uses, so in practice
    both agree exactly."""
    tris, o, d, t_max = _scene(np.random.default_rng(seed))
    jf = JF.FusedTris.from_tris(*tris)
    tf = convert.fused_tris(jf)
    raye_j, rayp_j, rayb_j = JF.ray_features(jnp.asarray(o), jnp.asarray(d))
    t_ref, id_ref = (np.asarray(x) for x in JF._intersect_ref(
        jf, raye_j, rayp_j, jnp.asarray(t_max)))
    G = o.shape[0] // JF.RAY_TILE

    def tiles(x):
        return x.reshape(G, JF.RAY_TILE, JF._K).transpose(0, 2, 1)

    t_pal, id_pal = JF._intersect_pallas(
        jf.edge_table, jf.plane_table, jf.tile_bounds, tiles(raye_j),
        tiles(rayp_j), tiles(rayb_j), jnp.asarray(t_max).reshape(
            G, JF.RAY_TILE), n_tiles=jf.edge_table.shape[0], interpret=True)
    t_pal, id_pal = np.asarray(t_pal).reshape(-1), np.asarray(
        id_pal).reshape(-1)

    raye, rayp = TF.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(raye.numpy(), np.asarray(raye_j))
    t_pl, id_pl = TF.intersect_tiles(tf.edge_table, tf.plane_table,
                                     raye, rayp, torch.as_tensor(t_max))
    t_pl, id_pl = t_pl.numpy(), id_pl.numpy()
    assert (id_pl >= 0).sum() > 100  # the scene is really hit
    for t_j, id_j in ((t_ref, id_ref), (t_pal, id_pal)):
        same = id_pl == id_j
        assert same.mean() >= 0.999
        np.testing.assert_allclose(t_pl[same], t_j[same], rtol=1e-6)
    dead = t_max == 0
    assert (id_pl[dead] == -1).all() and (t_pl[dead] == 0).all()


def test_intersect_fused_remaps_and_cuts():
    """Original triangle ids and t_max cuts, as statmc_tpu's
    intersect_fused returns them on the CPU."""
    tris, o, d, t_max = _scene(np.random.default_rng(7), n_tris=300,
                               n_rays=512)
    jt, jid, jhit = JF.intersect_fused(JF.FusedTris.from_tris(*tris),
                                       jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t_max))
    tf = TF.FusedTris.from_tris(*tris).to_device("cpu")
    assert tf.perm is not None  # random order: the remap is exercised
    tt, tid, thit = TF.intersect_fused(tf, torch.as_tensor(o),
                                       torch.as_tensor(d),
                                       torch.as_tensor(t_max))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
