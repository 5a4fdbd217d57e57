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
from statmc_tpu_torch.accel import plucker as PL
from statmc_tpu_torch.accel import twolevel as TT

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


@pytest.mark.parametrize("n_tris,seed", [(500, 5), (256, 6), (1070, 7)])
def test_packed_table_keeps_every_nonzero_coefficient(n_tris, seed):
    """to_device's packed [2*Ntt, 25, 128] table, which kernel B1 reads:
    the edge and plane tables rebuilt from it equal the originals, so it
    reproduces every non-zero coefficient exactly and drops only zeros;
    ids map as tile * 256 + k = subtile * 128 + column."""
    tris, *_ = _scene(np.random.default_rng(seed), n_tris=n_tris)
    tf = TF.FusedTris.from_tris(*tris).to_device("cpu")
    ntt = tf.edge_table.shape[0]
    pk = tf.packed
    assert pk.shape == (2 * ntt, 25, 128) and pk.is_contiguous()
    cols = pk.reshape(ntt, 2, 25, 128).permute(0, 2, 1, 3).reshape(
        ntt, 25, TF.TRI_TILE)  # [tile, packed row, triangle of the tile]
    edge = torch.zeros_like(tf.edge_table)
    plane = torch.zeros_like(tf.plane_table)
    for e in range(3):
        edge[:, e, :, 0:6] = cols[:, 6 * e:6 * e + 6].transpose(1, 2)
    plane[:, 0, :, 3:7] = cols[:, 18:22].transpose(1, 2)
    plane[:, 1, :, 0:3] = cols[:, 22:25].transpose(1, 2)
    assert torch.equal(edge, tf.edge_table)
    assert torch.equal(plane, tf.plane_table)
    assert int((pk != 0).sum()) == int((tf.edge_table != 0).sum()) + int(
        (tf.plane_table != 0).sum()) > 20 * n_tris


@pytest.mark.parametrize("seed", [5, 6])
def test_walk_plain_over_fused_subtiles_equals_intersect_plain(seed):
    """B1's triangles laid out as B4's subtiles (every subtile in the
    worklist, fsub = 1): walk_plain gives intersect_plain's (t, id) bit
    for bit, which is what lets the two kernels share one device core."""
    tris, o, d, t_max = _scene(np.random.default_rng(seed), n_rays=1024)
    t_max[3::8] = np.inf  # the first tested triangle's 1e30 wins
    tf = TF.FusedTris.from_tris(*tris).to_device("cpu")
    raye, rayp = TF.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    t_f, id_f = TF.intersect_plain(tf.edge_table, tf.plane_table, raye, rayp,
                                   torch.as_tensor(t_max))
    table = PL.fused_subtiles(tf.edge_table, tf.plane_table)
    assert torch.equal(PL.pack_subtiles(table), tf.packed)
    nst, G = table.shape[0], 1024 // TT.RT_WALK
    order = torch.arange(TT.MAXS, dtype=torch.int32).repeat(G, 1)
    feat = TT.block_features(torch.as_tensor(o), torch.as_tensor(d))
    t_w, id_w = TT.walk_plain(
        table, order, torch.full((G,), nst, dtype=torch.int32),
        torch.zeros((G, 1), dtype=torch.int32), feat,
        torch.as_tensor(t_max).reshape(G, TT.RT_WALK), 1)
    np.testing.assert_array_equal(id_w.reshape(-1).numpy(), id_f.numpy())
    np.testing.assert_array_equal(t_w.reshape(-1).numpy().view(np.int32),
                                  t_f.numpy().view(np.int32))
    assert (id_f >= 0).sum() > 100 and (id_f[3::8] >= 0).all()


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_b1_bits_equal_jax_ref(seed):
    """With the zero columns skipped, intersect_plain still evaluates the
    chain of XLA's CPU dot over the non-zero ones: ids equal and t equal
    as bits on every ray, against _intersect_ref."""
    tris, o, d, t_max = _scene(np.random.default_rng(seed))
    jf = JF.FusedTris.from_tris(*tris)
    tf = convert.fused_tris(jf)
    raye_j, rayp_j, _ = JF.ray_features(jnp.asarray(o), jnp.asarray(d))
    t_ref, id_ref = (np.asarray(x) for x in JF._intersect_ref(
        jf, raye_j, rayp_j, jnp.asarray(t_max)))
    raye, rayp = TF.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    t_pl, id_pl = TF.intersect_plain(tf.edge_table, tf.plane_table, raye,
                                     rayp, torch.as_tensor(t_max))
    np.testing.assert_array_equal(id_pl.numpy(), id_ref)
    np.testing.assert_array_equal(t_pl.numpy().view(np.int32),
                                  t_ref.view(np.int32))


@pytest.mark.parametrize("case", ["inf_t_max", "nan_t_max", "inf_origin",
                                  "nan_origin"])
def test_plain_b1_special_rays_match_jax_ref(case):
    """Rays a caller should not send give what the JAX reference gives:
    t_max = +inf lets the first tested triangle's 1e30 win (t = 1e30 with
    its id unless a real hit is closer); a NaN t_max, a NaN origin and an
    infinite origin never hit and keep t_max."""
    tris, o, d, t_max = _scene(np.random.default_rng(8))
    t_max[:] = np.where(np.arange(len(t_max)) % 2 == 0, 1e30, 7.0)
    if case == "inf_t_max":
        t_max[:] = np.inf
    elif case == "nan_t_max":
        t_max[::2] = np.nan
    elif case == "inf_origin":
        o[::2, 0] = np.inf
        o[1::4, 2] = -np.inf
    else:
        o[::2, 1] = np.nan
    jf = JF.FusedTris.from_tris(*tris)
    tf = convert.fused_tris(jf)
    raye_j, rayp_j, _ = JF.ray_features(jnp.asarray(o), jnp.asarray(d))
    t_ref, id_ref = (np.asarray(x) for x in JF._intersect_ref(
        jf, raye_j, rayp_j, jnp.asarray(t_max)))
    raye, rayp = TF.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    t_pl, id_pl = TF.intersect_tiles(tf.edge_table, tf.plane_table, raye,
                                     rayp, torch.as_tensor(t_max))
    np.testing.assert_array_equal(id_pl.numpy(), id_ref)
    np.testing.assert_array_equal(t_pl.numpy().view(np.int32),
                                  t_ref.view(np.int32))
    if case == "inf_t_max":
        assert (id_ref >= 0).all() and (t_ref <= 1e30).all()
        assert (t_ref == np.float32(1e30)).sum() > 100
    elif case == "nan_t_max":
        assert (id_ref[::2] == -1).all() and np.isnan(t_ref[::2]).all()
    else:
        assert (id_ref[::2] == -1).all() and (id_ref >= 0).sum() > 20


@pytest.mark.parametrize("n_tris", [1, 12, 256, 300])
def test_plain_b1_skips_padding_rows(n_tris):
    """intersect_plain given n_tris (the rows past it are zero padding)
    gives the (t, id) of the walk over every row, bit for bit."""
    rng = np.random.default_rng(n_tris)
    (p0, e1, e2), o, d, t_max = _scene(rng, n_tris=n_tris, n_rays=600)
    tf = TF.FusedTris.from_tris(p0, e1, e2).to_device("cpu")
    raye, rayp = TF.ray_features(torch.as_tensor(o), torch.as_tensor(d))
    args = (tf.edge_table, tf.plane_table, raye, rayp, torch.as_tensor(t_max))
    t_a, id_a = TF.intersect_plain(*args)
    t_b, id_b = TF.intersect_plain(*args, tf.n_tris)
    assert torch.equal(id_a, id_b)
    assert torch.equal(t_a.view(torch.int32), t_b.view(torch.int32))
    assert int((id_a >= 0).sum()) > 0 or n_tris == 1
