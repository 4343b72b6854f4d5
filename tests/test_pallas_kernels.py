"""The fused RANSAC hypothesis scorer (``ops.ransac._score``) against a
numpy oracle: exact counts, padding-free odd sizes, masking, and the
production width (N = work_capacity 8192, K = 1024 hypotheses)."""

import jax
import jax.numpy as jnp
import numpy as np

from perception.ops import ransac as R


def oracle_score(points, mask, normals, d, tau):
    dist = np.abs(points.astype(np.float64) @ normals.T.astype(np.float64) + d[None, :])
    inl = (dist <= tau) & mask[:, None]
    return inl.sum(0)


def random_case(seed, n, k):
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32)
    mask = rng.rand(n) > 0.2
    normals = rng.randn(k, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    d = rng.randn(k).astype(np.float32) * 0.5
    return pts, mask, normals, d


def score(pts, mask, normals, d, tau):
    return np.asarray(jax.jit(R._score)(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(normals), jnp.asarray(d), tau))


def test_matches_oracle_small():
    pts, mask, normals, d = random_case(0, 1000, 64)
    got = score(pts, mask, normals, d, 0.1)
    np.testing.assert_array_equal(got, oracle_score(pts, mask, normals, d, 0.1))


def test_matches_oracle_unaligned_sizes():
    # N and K with no power-of-two factor.
    pts, mask, normals, d = random_case(1, 777, 100)
    got = score(pts, mask, normals, d, 0.05)
    np.testing.assert_array_equal(got, oracle_score(pts, mask, normals, d, 0.05))


def test_matches_jnp_score_in_ransac_module():
    # The scorer and the inlier test of ransac_plane agree per plane.
    pts, mask, normals, d = random_case(2, 2000, 128)
    scores = score(pts, mask, normals, d, 0.08)
    for k in (0, 17, 127):
        coeffs = jnp.asarray(np.append(normals[k], d[k]))
        dist = np.abs(np.asarray(R.point_plane_distance(jnp.asarray(pts), coeffs)))
        assert scores[k] == int(((dist <= 0.08) & mask).sum())


def test_all_masked_scores_zero():
    pts, _, normals, d = random_case(3, 500, 32)
    got = score(pts, np.zeros(500, bool), normals, d, 0.1)
    np.testing.assert_array_equal(got, np.zeros(32, np.int32))


def test_exact_counts_at_production_width():
    # N = 8192 points, K = 1024 hypotheses. Every point sits at
    # +-tau +- margin from the plane of its hypothesis family, so the
    # count is decided by a margin (1e-4 m) far above f32 rounding at
    # these coordinates (~1e-7 m) and must match numpy exactly.
    n, k, tau, margin = 8192, 1024, 0.015, 1e-4
    rng = np.random.RandomState(4)
    normals = rng.randn(k, 3)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    d = rng.uniform(-1.0, 1.0, k)
    # Place every point relative to hypothesis 0's plane at one of the
    # four offsets; for the other hypotheses the oracle decides.
    base = rng.uniform(-1.5, 1.5, (n, 3))
    base -= (base @ normals[0] + d[0])[:, None] * normals[0]
    offs = np.array([tau - margin, tau + margin, -tau + margin, -tau - margin])
    pts = base + offs[np.arange(n) % 4][:, None] * normals[0]
    mask = rng.rand(n) > 0.1
    pts, normals, d = pts.astype(np.float32), normals.astype(np.float32), d.astype(np.float32)
    got = score(pts, mask, normals, d, tau)
    want = oracle_score(pts, mask, normals, d, tau)
    # Hypothesis 0 counts exactly the points at |offset| = tau - margin.
    assert want[0] == int((mask & (np.arange(n) % 4 % 2 == 0)).sum())
    # The rest: exact wherever no point lies within 2e-6 m of +-tau
    # (f32 rounding of a distance at these coordinates is < 1e-6 m).
    dist = np.abs(pts.astype(np.float64) @ normals.T.astype(np.float64) + d[None, :])
    clear = ~np.any(mask[:, None] & (np.abs(dist - tau) < 2e-6), axis=0)
    assert clear.sum() > 0.95 * k
    np.testing.assert_array_equal(got[clear], want[clear])
