"""`Accelerator "kdtree"` (statmc_tpu_torch/accel/kdtree.py) against the
JAX package's accel/kdtree.py.

The SAH build is a copy of the host code and its node and leaf tables
are equal.  The kd-restart walk runs on the live lanes only and tests a
leaf's (lane, triangle) pairs flattened; its Moller-Trumbore dots round
as XLA's do (core/math.py dot_fused).  On the soups and rays of
tests/test_kdtree.py every id and every t is equal (measured), which
this file holds at ids on >= 99.9% of rays and t within rtol 1e-6.  Both
reference defects are mirrored (ROADMAP.md section C): a direction
component in (-1e-12, 0) gets inv_d = 0, and the advance band
eps * max(1, |t_hi|) steps over a cell thinner than itself; each is shown
on rays built to hit it.  End to end, the 16x12 kd-tree staircase holds
the JAX package's buffers as the fused path does (tests/test_torch_slice.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.accel import kdtree as JK
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.accel import kdtree as TK
from statmc_tpu_torch.accel.fused import FusedTris

from test_kdtree import _dense_ref, _rays, _soup
from test_torch_hair_sss import hold_to_jax

torch.set_num_threads(2)
SOUPS = [(40, 0), (300, 2), (1500, 3)]


def _both(p0, e1, e2):
    jk = JK.build_kdtree(p0, e1, e2)
    return jk, TK.build_kdtree(p0, e1, e2).to_device("cpu")


def _walk(jk, tk, o, d, t_max, any_hit):
    tj, ij, hj = (np.asarray(x) for x in JK.intersect_kdtree(
        jk, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        any_hit=any_hit))
    tt, it, ht = (x.numpy() for x in TK.intersect_kdtree(
        tk, torch.tensor(o), torch.tensor(d), torch.tensor(t_max),
        any_hit=any_hit))
    return (tj, ij, hj), (tt, it, ht)


@pytest.mark.parametrize("n,seed", SOUPS)
def test_build_matches_jax(n, seed):
    """Node rows, split positions, leaf lists, node count, widest leaf."""
    jk, tk = _both(*_soup(n, seed))
    np.testing.assert_array_equal(tk.node_i.numpy(), np.asarray(jk.node_i))
    np.testing.assert_array_equal(tk.node_f.numpy(), np.asarray(jk.node_f))
    np.testing.assert_array_equal(tk.leaf_prims.numpy(),
                                  np.asarray(jk.leaf_prims))
    np.testing.assert_array_equal(tk.world_lo.numpy(),
                                  np.asarray(jk.world_lo))
    assert (tk.n_nodes, tk.max_leaf) == (jk.n_nodes, jk.max_leaf)
    assert tk.depth() <= int(round(8 + 1.3 * np.log2(n)))


def test_build_of_converted_tables():
    """The JAX package's tables carried across walk as the port's own."""
    p0, e1, e2 = _soup(300, 2)
    jk, tk = _both(p0, e1, e2)
    ck = convert.kdtree_tris(jk)
    o, d = (np.asarray(x) for x in _rays(512, 12))
    t_max = np.full(512, 1e9, np.float32)
    a = TK.intersect_kdtree(ck, torch.tensor(o), torch.tensor(d),
                            torch.tensor(t_max))
    b = TK.intersect_kdtree(tk, torch.tensor(o), torch.tensor(d),
                            torch.tensor(t_max))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n,seed", SOUPS)
def test_walk_matches_jax(n, seed, any_hit):
    """Closest and any hit on 4,096 rays: ids equal on >= 99.9% of rays,
    hit flags equal, t within rtol 1e-6; the walk's step count within
    its cap."""
    jk, tk = _both(*_soup(n, seed))
    o, d = (np.asarray(x) for x in _rays(4096, seed + 10))
    t_max = np.full(4096, 6.0 if any_hit else 1e9, np.float32)
    TK.walk_stats = []
    try:
        (tj, ij, hj), (tt, it, ht) = _walk(jk, tk, o, d, t_max, any_hit)
        stats = TK.walk_stats[0]
    finally:
        TK.walk_stats = None
    np.testing.assert_array_equal(ht, hj)
    assert (it == ij).mean() >= 0.999
    np.testing.assert_allclose(tt, tj, rtol=1e-6)
    assert 0 < stats["steps"] < stats["cap"] == 8 * tk.n_nodes + 64
    if not any_hit:
        # Against the brute-force reference (tests/test_kdtree.py).
        _, _, hit_ref = _dense_ref(*_soup(n, seed), o, d, t_max)
        np.testing.assert_array_equal(ht, hit_ref)


def test_axis_parallel_rays_match_jax():
    """Zero direction components take the inv_d fallback in both."""
    jk, tk = _both(*_soup(120, 7))
    m = 512
    rng = np.random.default_rng(9)
    o = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    d = np.zeros((m, 3), np.float32)
    d[np.arange(m), rng.integers(0, 3, m)] = np.where(
        rng.random(m) < 0.5, 1.0, -1.0)
    (tj, ij, hj), (tt, it, ht) = _walk(jk, tk, o, d,
                                       np.full(m, 1e9, np.float32), False)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(tt, tj)


def test_inv_d_defect_mirrored():
    """A direction component in (-1e-12, 0) gets inv_d = 0
    (statmc_tpu/accel/kdtree.py:195-196): the scene's slab along that
    axis collapses to t = 0, so the walk tests only the leaf at the ray's
    origin.  Rays along x with a y component of -1e-13 miss most of what
    the same rays with +1e-13 (inv_d = 2e12) hit; both packages give the
    same answer lane for lane, and with +1e-13 the brute-force
    reference's."""
    p0, e1, e2 = _soup(300, 2)
    jk, tk = _both(p0, e1, e2)
    rng = np.random.default_rng(4)
    o = rng.uniform(-4, 4, (512, 3)).astype(np.float32)
    sx = np.where(rng.random(512) < 0.5, 1.0, -1.0)
    hits = {}
    for sy in (-1e-13, 1e-13):
        d = np.zeros((512, 3), np.float32)
        d[:, 0] = sx
        d[:, 1] = sy
        t_max = np.full(512, 1e9, np.float32)
        (tj, ij, hj), (tt, it, ht) = _walk(jk, tk, o, d, t_max, False)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(tt, tj)
        hits[sy] = ht
        if sy > 0:
            np.testing.assert_array_equal(
                ht, _dense_ref(p0, e1, e2, o, d, t_max)[2])
    assert hits[-1e-13].sum() < hits[1e-13].sum() / 2
    assert not (hits[-1e-13] & ~hits[1e-13]).any()


def _thin_cell_tables(mod):
    """A hand-built tree: the root splits x at 0; its above child splits
    x at 5e-5, and the thin cell [0, 5e-5] holds triangle 0, which stands
    in the plane x = 2e-5."""
    p0 = np.array([[2e-5, -1.0, -1.0]], np.float32)
    e1 = np.array([[0.0, 2.0, 0.0]], np.float32)
    e2 = np.array([[0.0, 0.0, 2.0]], np.float32)
    node_f = np.array([[0.0], [0.0], [5e-5], [0.0], [0.0]], np.float32)
    node_i = np.array([[0, 2, 0, 0], [3, -1, 0, 0], [0, 4, 0, 0],
                       [3, -1, 0, 1], [3, -1, 1, 0]], np.int32)
    kw = dict(node_f=node_f, node_i=node_i,
              leaf_prims=np.array([0], np.int32), tri_p0=p0, tri_e1=e1,
              tri_e2=e2, world_lo=np.full(3, -2.0, np.float32),
              world_hi=np.full(3, 2.0, np.float32), n_nodes=5, max_leaf=1)
    if mod is JK:
        kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        return JK.KdTreeTris(**kw), (p0, e1, e2)
    return TK.KdTreeTris(**kw).to_device("cpu"), (p0, e1, e2)


def test_advance_band_defect_mirrored():
    """After the empty leaf below x = 0 the walk restarts at
    t_hi + 1e-4 max(1, |t_hi|) (statmc_tpu/accel/kdtree.py:270), past the
    5e-5-thin cell that holds the triangle: both packages miss it, the
    brute-force reference hits it at t = 1.00002."""
    jk, tris = _thin_cell_tables(JK)
    tk, _ = _thin_cell_tables(TK)
    o = np.array([[-1.0, -0.5, -0.5]], np.float32)
    d = np.array([[1.0, 0.0, 0.0]], np.float32)
    t_max = np.full(1, 1e9, np.float32)
    (tj, ij, hj), (tt, it, ht) = _walk(jk, tk, o, d, t_max, False)
    t_ref, _, hit_ref = _dense_ref(*tris, o, d, t_max)
    assert hit_ref[0] and abs(t_ref[0] - 1.00002) < 1e-6
    assert not hj[0] and not ht[0]
    assert ij[0] == it[0] == -1


@pytest.fixture(scope="module")
def staircase(tmp_path_factory):
    """The kd-tree staircase at 16x12, 1 spp, 1 iteration, maxdepth 3,
    denoised: (path, JAX setup, JAX render)."""
    path = tmp_path_factory.mktemp("kd") / "scene.pbrt"
    path.write_text(TS.kdtree_scene_text(
        width=16, height=12, spp=1, iterations=1, maxdepth=3,
        filterradius=2))
    rj = JD.load(str(path))
    totals = [x["rays_total"] for x in rj.render(verbose=False)]
    return str(path), rj.s, (totals, {k: np.asarray(v)
                                      for k, v in rj.buffers().items()})


def test_staircase_end_to_end(staircase):
    """load(...).render() through the kd walk: the tables equal the JAX
    package's, equal ray totals, every buffer within rtol 1e-4 on >=
    98.5% of its pixels."""
    path, js, jax_render = staircase
    rt = TD.load(path, device="cpu")
    assert isinstance(rt.s.bvh, TK.KdTreeTris)
    assert not isinstance(rt.s.bvh, FusedTris)
    np.testing.assert_array_equal(rt.s.bvh.node_i.numpy(),
                                  np.asarray(js.bvh.node_i))
    hold_to_jax(jax_render, rt, 0.985)
