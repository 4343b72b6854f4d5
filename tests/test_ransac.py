import jax
import jax.numpy as jnp
import numpy as np

from perception.ops.ransac import ransac_plane, point_plane_distance


def plane_cloud(key, n=1000, normal=(0, 0, 1.0), d=-0.5, noise=0.002, outliers=200):
    """n inlier points on plane n.p + d = 0 plus uniform outliers."""
    normal = np.asarray(normal, np.float64)
    normal = normal / np.linalg.norm(normal)
    rng = np.random.RandomState(int(jax.random.randint(key, (), 0, 2**31 - 1)))
    # Basis in the plane.
    a = np.cross(normal, [1.0, 0.0, 0.0])
    if np.linalg.norm(a) < 1e-6:
        a = np.cross(normal, [0.0, 1.0, 0.0])
    a /= np.linalg.norm(a)
    b = np.cross(normal, a)
    uv = rng.uniform(-0.5, 0.5, (n, 2))
    pts = uv[:, :1] * a + uv[:, 1:] * b - d * normal
    pts += rng.randn(n, 3) * noise
    out = rng.uniform(-1, 1, (outliers, 3))
    all_pts = np.concatenate([pts, out]).astype(np.float32)
    mask = np.ones(len(all_pts), bool)
    return jnp.asarray(all_pts), jnp.asarray(mask), normal, d


def canon(coeffs):
    c = np.asarray(coeffs, np.float64)
    if c[2] < 0 or (c[2] == 0 and c[0] < 0):
        c = -c
    return c


def test_recovers_known_plane():
    pts, mask, n_true, d_true = plane_cloud(jax.random.key(0))
    fit = ransac_plane(pts, mask, jax.random.key(1), threshold=0.01, num_hypotheses=512)
    assert bool(fit.valid)
    c = canon(fit.coefficients)
    expected = canon(np.concatenate([n_true, [d_true]]))
    np.testing.assert_allclose(c, expected, atol=0.01)
    assert int(fit.num_inliers) >= 950


def test_tilted_plane():
    pts, mask, n_true, d_true = plane_cloud(jax.random.key(2), normal=(0.2, -0.3, 1.0), d=0.7)
    fit = ransac_plane(pts, mask, jax.random.key(3), threshold=0.01, num_hypotheses=512)
    c = canon(fit.coefficients)
    expected = canon(np.concatenate([n_true, [d_true]]))
    np.testing.assert_allclose(c, expected, atol=0.02)


def test_inliers_are_near_plane():
    pts, mask, _, _ = plane_cloud(jax.random.key(4))
    fit = ransac_plane(pts, mask, jax.random.key(5), threshold=0.01)
    dist = np.abs(np.asarray(point_plane_distance(pts, fit.coefficients)))
    inl = np.asarray(fit.inliers)
    assert (dist[inl] <= 0.0101).all()


def test_respects_input_mask():
    pts, mask, _, _ = plane_cloud(jax.random.key(6))
    mask = mask.at[:500].set(False)
    fit = ransac_plane(pts, mask, jax.random.key(7), threshold=0.01)
    assert not bool(np.asarray(fit.inliers)[:500].any())


def test_perpendicular_constraint():
    # Dominant plane is vertical (normal ~x), small horizontal plane too.
    key = jax.random.key(8)
    big_v, mv, _, _ = plane_cloud(jax.random.key(10), n=2000, normal=(1.0, 0, 0), d=-0.3, outliers=0)
    small_h, mh, _, _ = plane_cloud(jax.random.key(11), n=600, normal=(0, 0, 1.0), d=-0.8, outliers=0)
    pts = jnp.concatenate([big_v, small_h])
    mask = jnp.concatenate([mv, mh])
    # Unconstrained RANSAC picks the bigger (vertical) plane...
    fit_any = ransac_plane(pts, mask, key, threshold=0.01, num_hypotheses=1024)
    assert abs(float(fit_any.coefficients[0])) > 0.9
    # ...but constrained to normals ~z it must pick the horizontal one
    # (SACMODEL_PERPENDICULAR_PLANE semantics, surface_normal_estimation.cpp:105-165).
    fit_z = ransac_plane(
        pts, mask, key, threshold=0.01, num_hypotheses=1024,
        model="perpendicular", axis=jnp.array([0.0, 0, 1.0]), eps_angle=0.1,
    )
    assert bool(fit_z.valid)
    assert abs(float(fit_z.coefficients[2])) > 0.99
    np.testing.assert_allclose(abs(float(fit_z.coefficients[3])), 0.8, atol=0.02)


def test_parallel_constraint():
    # Only accept planes parallel to z (normal perpendicular to z).
    big_h, mh, _, _ = plane_cloud(jax.random.key(12), n=2000, normal=(0, 0, 1.0), d=-0.5, outliers=0)
    small_v, mv, _, _ = plane_cloud(jax.random.key(13), n=600, normal=(0, 1.0, 0), d=-0.2, outliers=0)
    pts = jnp.concatenate([big_h, small_v])
    mask = jnp.concatenate([mh, mv])
    fit = ransac_plane(
        pts, mask, jax.random.key(14), threshold=0.01, num_hypotheses=1024,
        model="parallel", axis=jnp.array([0.0, 0, 1.0]), eps_angle=0.1,
    )
    assert bool(fit.valid)
    assert abs(float(fit.coefficients[2])) < 0.1
    assert abs(float(fit.coefficients[1])) > 0.99


def test_no_plane_in_pure_noise_low_inliers():
    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.uniform(-1, 1, (300, 3)), jnp.float32)
    mask = jnp.ones(300, bool)
    fit = ransac_plane(pts, mask, jax.random.key(15), threshold=0.001, num_hypotheses=64)
    # Pure noise: few inliers (can't assert invalid — some plane always
    # fits a little — but the count stays tiny).
    assert int(fit.num_inliers) < 50


def test_jit_compiles_once_and_runs():
    pts, mask, _, _ = plane_cloud(jax.random.key(16))
    f = jax.jit(lambda p, m, k: ransac_plane(p, m, k, threshold=0.01, num_hypotheses=256))
    fit1 = f(pts, mask, jax.random.key(17))
    fit2 = f(pts, mask, jax.random.key(18))
    assert bool(fit1.valid) and bool(fit2.valid)
