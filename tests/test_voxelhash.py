import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.ops import nn as brute
from perception.ops.voxelhash import (
    build,
    nearest_neighbor_voxelhash,
    query,
    sort_by_cell,
)


def test_matches_brute_force_within_radius():
    rng = np.random.RandomState(0)
    ref = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    q = (ref[:300] + rng.randn(300, 3) * 0.01).astype(np.float32)
    mask = np.ones(5000, bool)
    radius = 0.05
    nbr, d2, found = nearest_neighbor_voxelhash(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask), radius
    )
    bidx, bd2 = brute.nearest_neighbor(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask))
    bd2 = np.asarray(bd2)
    within = bd2 <= radius * radius
    assert found.sum() >= within.sum() * 0.99
    got = np.asarray(d2)[np.asarray(found) & within]
    exp = bd2[np.asarray(found) & within]
    # atol 1e-6: the brute-force |q|^2 - 2qr + |r|^2 expansion loses a
    # few ULPs vs the hash path's direct (p - q)^2.
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-6)


def test_index_exact_vs_kdtree_oracle():
    """Index-exact agreement against a float64 KD-tree (VERDICT r3
    item 1b: compare indices, not rtol on near-zero distances)."""
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(3)
    ref = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    q = (ref[rng.randint(0, 20000, 2000)]
         + rng.randn(2000, 3).astype(np.float32) * 0.005)
    radius = 0.05
    vh = build(jnp.asarray(ref), jnp.ones(20000, bool), cell_size=radius)
    idx, d2 = query(vh, jnp.asarray(q))
    od, oi = cKDTree(ref.astype(np.float64)).query(q.astype(np.float64))
    in_r = od <= radius
    order = np.asarray(vh.order)
    agree = np.mean(order[np.asarray(idx)][in_r] == oi[in_r])
    assert agree >= 0.999


def test_dense_gaussian_stress():
    """Gaussian-concentrated cloud (VERDICT r3 item 1c): the dense
    center must not truncate candidates. The dynamic per-tile chunk
    counts absorb the skewed range-length distribution."""
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(4)
    m = 32768
    ref = rng.randn(m, 3).astype(np.float32)
    ref[:, 2] = 0.2 * np.sin(ref[:, 0] * 3) * np.cos(ref[:, 1] * 3)
    q = (ref[rng.randint(0, m, 4096)]
         + rng.randn(4096, 3).astype(np.float32) * 0.01)
    radius = 0.06
    vh = build(jnp.asarray(ref), jnp.ones(m, bool), cell_size=radius)
    idx, d2, overflow = query(vh, jnp.asarray(q), return_stats=True)
    assert float(overflow) == 0.0
    od, oi = cKDTree(ref.astype(np.float64)).query(q.astype(np.float64))
    in_r = od <= radius
    order = np.asarray(vh.order)
    agree = np.mean(order[np.asarray(idx)][in_r] == oi[in_r])
    assert agree >= 0.99


def test_warm_path_presorted():
    """sort_by_cell + sort=False returns results in the caller's
    (sorted) layout — the production ICP inner-loop pattern."""
    rng = np.random.RandomState(5)
    ref = rng.uniform(-1, 1, (8000, 3)).astype(np.float32)
    q = (ref[:500] + rng.randn(500, 3) * 0.005).astype(np.float32)
    vh = build(jnp.asarray(ref), jnp.ones(8000, bool), cell_size=0.05)
    q_sorted, order_q = sort_by_cell(vh, jnp.asarray(q))
    wi, wd = query(vh, q_sorted, sort=False)
    ci, cd = query(vh, jnp.asarray(q), sort=True)
    # Same answers, warm in sorted layout.
    np.testing.assert_array_equal(
        np.asarray(wi), np.asarray(ci)[np.asarray(order_q)]
    )
    np.testing.assert_allclose(
        np.asarray(wd), np.asarray(cd)[np.asarray(order_q)], rtol=1e-6
    )


def test_miss_beyond_radius():
    ref = jnp.asarray(np.array([[0.0, 0, 0]], np.float32))
    q = jnp.asarray(np.array([[1.0, 1.0, 1.0]], np.float32))
    _, d2, found = nearest_neighbor_voxelhash(q, ref, jnp.ones(1, bool), radius=0.1)
    assert not bool(found[0])


def test_respects_ref_mask():
    ref = jnp.asarray(np.array([[0.0, 0, 0], [0.01, 0, 0]], np.float32))
    mask = jnp.asarray(np.array([False, True]))
    q = jnp.asarray(np.array([[0.0, 0, 0]], np.float32))
    nbr, d2, found = nearest_neighbor_voxelhash(q, ref, mask, radius=0.05)
    assert bool(found[0])
    np.testing.assert_allclose(np.asarray(nbr[0]), [0.01, 0, 0], atol=1e-6)


def test_query_tiling_unaligned():
    rng = np.random.RandomState(1)
    ref = rng.uniform(-1, 1, (777, 3)).astype(np.float32)
    q = ref[:123] + 0.001
    vh = build(jnp.asarray(ref), jnp.ones(777, bool), cell_size=0.05)
    idx, d2 = query(vh, jnp.asarray(q), tile=128)
    assert idx.shape == (123,)
    assert (np.asarray(d2) < 0.05**2).mean() > 0.95


def test_large_cloud_smoke():
    rng = np.random.RandomState(2)
    ref = rng.uniform(-2, 2, (100_000, 3)).astype(np.float32)
    q = (ref[::50] + rng.randn(2000, 3) * 0.005).astype(np.float32)
    nbr, d2, found = nearest_neighbor_voxelhash(
        jnp.asarray(q), jnp.asarray(ref), jnp.ones(100_000, bool), radius=0.05
    )
    assert float(np.asarray(found).mean()) > 0.95
