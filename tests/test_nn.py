import jax
import jax.numpy as jnp
import numpy as np

from perception.ops import nn


def brute_numpy(query, ref, ref_mask):
    d = ((query[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    d[:, ~ref_mask] = np.inf
    return d.argmin(1), d.min(1)


def test_nearest_neighbor_matches_numpy():
    rng = np.random.RandomState(0)
    q = rng.randn(200, 3).astype(np.float32)
    r = rng.randn(300, 3).astype(np.float32)
    m = np.ones(300, bool)
    m[::7] = False
    idx, d2 = nn.nearest_neighbor(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m))
    eidx, ed2 = brute_numpy(q, r, m)
    np.testing.assert_allclose(np.asarray(d2), ed2, atol=1e-4)
    # Indices may differ on exact ties; distances decide.
    np.testing.assert_array_equal(np.asarray(idx), eidx)


def test_nearest_neighbor_tiling_boundary():
    # ref size not a multiple of the tile; force several tiles.
    rng = np.random.RandomState(1)
    q = rng.randn(50, 3).astype(np.float32)
    r = rng.randn(1000, 3).astype(np.float32)
    m = np.ones(1000, bool)
    idx, d2 = nn.nearest_neighbor(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), tile=256)
    eidx, ed2 = brute_numpy(q, r, m)
    np.testing.assert_allclose(np.asarray(d2), ed2, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(idx), eidx)


def test_nearest_neighbor_exact_hit():
    r = jnp.asarray(np.random.RandomState(2).randn(64, 3), jnp.float32)
    idx, d2 = nn.nearest_neighbor(r, r, jnp.ones(64, bool))
    np.testing.assert_array_equal(np.asarray(idx), np.arange(64))
    np.testing.assert_allclose(np.asarray(d2), np.zeros(64), atol=1e-5)


def test_all_refs_masked():
    q = jnp.zeros((4, 3))
    r = jnp.ones((8, 3))
    idx, d2 = nn.nearest_neighbor(q, r, jnp.zeros(8, bool))
    assert bool((d2 > 1e10).all())  # sentinel distances: no valid neighbor


def test_radius_count():
    q = jnp.array([[0.0, 0, 0]])
    r = jnp.array([[0.05, 0, 0], [0.2, 0, 0], [0, 0.09, 0], [5, 5, 5]])
    c = nn.radius_count(q, r, jnp.ones(4, bool), radius=0.1)
    assert int(c[0]) == 2


def test_knn_matches_numpy():
    rng = np.random.RandomState(3)
    q = rng.randn(60, 3).astype(np.float32)
    r = rng.randn(150, 3).astype(np.float32)
    m = np.ones(150, bool)
    m[10:20] = False
    k = 5
    idx, d2 = nn.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), k=k, tile=64)
    d = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    d[:, ~m] = np.inf
    expected = np.sort(d, axis=1)[:, :k]
    np.testing.assert_allclose(np.sort(np.asarray(d2), axis=1), expected, rtol=1e-4, atol=1e-4)


def test_nn_vmap_over_batch():
    rng = np.random.RandomState(4)
    q = jnp.asarray(rng.randn(2, 30, 3), jnp.float32)
    r = jnp.asarray(rng.randn(2, 40, 3), jnp.float32)
    m = jnp.ones((2, 40), bool)
    idx, d2 = jax.vmap(nn.nearest_neighbor)(q, r, m)
    assert idx.shape == (2, 30)
    for b in range(2):
        ei, ed = brute_numpy(np.asarray(q[b]), np.asarray(r[b]), np.asarray(m[b]))
        np.testing.assert_array_equal(np.asarray(idx[b]), ei)
