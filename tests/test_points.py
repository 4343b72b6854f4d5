import jax
import jax.numpy as jnp
import numpy as np

from perception.ops import points as P


def make_cloud(key, n=500, scale=1.0):
    pts = jax.random.normal(key, (n, 3)) * scale
    mask = jnp.ones(n, bool)
    return pts, mask


def test_passthrough_matches_numpy():
    pts, mask = make_cloud(jax.random.key(0))
    m = P.passthrough(pts, mask, 2, 0.0, 0.9)
    expected = (np.asarray(pts)[:, 2] >= 0.0) & (np.asarray(pts)[:, 2] <= 0.9)
    np.testing.assert_array_equal(np.asarray(m), expected)


def test_passthrough_respects_input_mask():
    pts, mask = make_cloud(jax.random.key(1))
    mask = mask.at[:100].set(False)
    m = P.passthrough(pts, mask, 0, -10.0, 10.0)
    assert not bool(m[:100].any())


def test_centroid_masked():
    pts = jnp.array([[1.0, 0, 0], [3.0, 0, 0], [100.0, 100, 100]])
    mask = jnp.array([True, True, False])
    np.testing.assert_allclose(P.centroid(pts, mask), [2.0, 0, 0], atol=1e-6)


def test_centroid_empty_is_zero():
    pts = jnp.ones((5, 3))
    mask = jnp.zeros(5, bool)
    np.testing.assert_allclose(P.centroid(pts, mask), jnp.zeros(3))


def test_voxel_downsample_merges_points():
    # Two tight clumps far apart -> exactly 2 output voxels at clump means.
    # Clumps centered inside cells (0.02 offset) so they don't straddle
    # a voxel boundary (grid origin -5, leaf 0.05 puts boundaries at 0.05k).
    rng = np.random.RandomState(0)
    a = rng.randn(50, 3) * 0.001 + 0.02
    b = rng.randn(50, 3) * 0.001 + 3.02
    pts = jnp.asarray(np.concatenate([a, b]), jnp.float32)
    mask = jnp.ones(100, bool)
    out, out_mask = P.voxel_downsample(pts, mask, 0.05)
    assert int(out_mask.sum()) == 2
    got = np.sort(np.asarray(out)[np.asarray(out_mask)], axis=0)
    expected = np.sort(np.stack([a.mean(0), b.mean(0)]), axis=0)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_voxel_downsample_keeps_spread_cloud():
    # Points farther apart than the leaf never merge.
    pts = jnp.asarray(np.mgrid[0:5, 0:5, 0:5].reshape(3, -1).T * 0.1, jnp.float32)
    mask = jnp.ones(len(pts), bool)
    out, out_mask = P.voxel_downsample(pts, mask, 0.05)
    assert int(out_mask.sum()) == len(pts)


def test_voxel_downsample_ignores_invalid():
    pts = jnp.zeros((10, 3))
    mask = jnp.zeros(10, bool).at[0].set(True)
    out, out_mask = P.voxel_downsample(pts, mask, 0.1)
    assert int(out_mask.sum()) == 1


def test_compact_moves_valid_first():
    pts = jnp.arange(30, dtype=jnp.float32).reshape(10, 3)
    mask = jnp.array([False, True, False, True, True, False, False, False, True, False])
    out, out_mask = P.compact(pts, mask, 6)
    assert int(out_mask.sum()) == 4
    np.testing.assert_allclose(np.asarray(out[:4]), np.asarray(pts)[[1, 3, 4, 8]])


def test_compact_exact_at_capacity():
    # cnt == capacity must keep every valid point (the float grid test
    # is bypassed below capacity — ADVICE.md round 1).
    n, cap = 200, 50
    pts = jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3)
    mask = (jnp.arange(n) % 4) == 0  # exactly 50 valid
    out, out_mask = P.compact(pts, mask, cap)
    assert int(out_mask.sum()) == cap
    np.testing.assert_allclose(
        np.asarray(out[:cap]), np.asarray(pts)[np.asarray(mask)]
    )


def test_compact_over_capacity_decimates_evenly():
    # cnt > capacity: kept count is capacity (or capacity-1 from float
    # grid rounding), the subset spans the full extent, and relative
    # order is preserved.
    n, cap = 500, 10
    pts = jnp.stack(
        [jnp.arange(n, dtype=jnp.float32), jnp.zeros(n), jnp.zeros(n)], axis=-1
    )
    mask = jnp.ones(n, bool).at[::7].set(False)  # cnt = 429
    out, out_mask = P.compact(pts, mask, cap)
    kept = int(out_mask.sum())
    assert kept in (cap - 1, cap)
    xs = np.asarray(out[:kept, 0])
    # Spans the extent (not a prefix): first kept near 0, last near n.
    assert xs[0] < n * 0.2 and xs[-1] > n * 0.8
    # Order preserved and roughly evenly spaced.
    assert np.all(np.diff(xs) > 0)
    gaps = np.diff(xs)
    assert gaps.max() < 3.0 * gaps.min() + 1


def test_compact_observed_advice_case():
    # The exact shape from ADVICE.md: capacity=10, cnt=50.
    n, cap = 50, 10
    pts = jnp.stack(
        [jnp.arange(n, dtype=jnp.float32), jnp.zeros(n), jnp.zeros(n)], axis=-1
    )
    out, out_mask = P.compact(pts, jnp.ones(n, bool), cap)
    assert int(out_mask.sum()) in (cap - 1, cap)


def test_bounds():
    pts = jnp.array([[0.0, 0, 0], [1, 2, 3], [-1, 5, -2], [999, 999, 999]])
    mask = jnp.array([True, True, True, False])
    lo, hi = P.bounds(pts, mask)
    np.testing.assert_allclose(lo, [-1, 0, -2])
    np.testing.assert_allclose(hi, [1, 5, 3])


def test_jit_voxel_downsample():
    f = jax.jit(lambda p, m: P.voxel_downsample(p, m, 0.05))
    pts, mask = make_cloud(jax.random.key(2), 256)
    out, om = f(pts, mask)
    out2, om2 = P.voxel_downsample(pts, mask, 0.05)
    np.testing.assert_allclose(out, out2)


def test_voxel_downsample_with_attrs_weights():
    """Recency-weighted fusion: per-point weights steer the voxel
    centroid and attr mean toward the heavier contributors; the
    unweighted path is unchanged (odometry map_decay support)."""
    pts = jnp.array([[0.0, 0.0, 0.0], [0.01, 0.0, 0.0], [5.0, 5.0, 5.0]])
    mask = jnp.array([True, True, False])
    attrs = jnp.array([[1.0, 0.0], [0.0, 1.0], [9.0, 9.0]])
    w = jnp.array([0.25, 1.0, 1.0])
    c, a, m = P.voxel_downsample_with_attrs(pts, mask, attrs, 0.05, weights=w)
    assert int(m.sum()) == 1
    np.testing.assert_allclose(c[m][0, 0], 0.01 / 1.25, atol=1e-6)
    np.testing.assert_allclose(a[m][0], [0.25 / 1.25, 1.0 / 1.25], atol=1e-6)
    # A voxel whose total weight is far below 1 must still produce the
    # weighted mean (guards the denom-floor bug: max(counts, 1.0)
    # would shrink the centroid by the weight).
    c2, a2, m2 = P.voxel_downsample_with_attrs(
        pts, mask, attrs, 0.05, weights=jnp.array([0.1, 0.1, 1.0])
    )
    np.testing.assert_allclose(c2[m2][0, 0], 0.005, atol=1e-6)
    # weights=None reproduces the plain centroid.
    c3, a3, m3 = P.voxel_downsample_with_attrs(pts, mask, attrs, 0.05)
    np.testing.assert_allclose(c3[m3][0, 0], 0.005, atol=1e-6)
