import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry import se3
from perception.io.templates import cuboid_template
from perception.ops.icp import icp_point_to_point, icp_point_to_plane, icp_batched
from perception.ops.normals import normals_knn


def make_pair(key, twist, n=800, noise=0.0):
    """Target cloud + source = inverse-transformed target (so ICP
    source->target should recover ``twist``'s transform)."""
    pts = jax.random.uniform(key, (n, 3), minval=-0.3, maxval=0.3)
    # Give the cloud 3-D structure (3 perpendicular-ish planes).
    pts = pts.at[: n // 3, 2].set(0.0)
    pts = pts.at[n // 3 : 2 * n // 3, 1].set(0.0)
    pts = pts.at[2 * n // 3 :, 0].set(0.0)
    T = se3.se3_exp(jnp.asarray(twist, jnp.float32))
    src = se3.transform_points(se3.inverse(T), pts)
    if noise:
        src = src + noise * jax.random.normal(jax.random.key(99), src.shape)
    mask = jnp.ones(n, bool)
    return src, mask, pts, mask, T


def test_p2p_identity():
    src, sm, tgt, tm, _ = make_pair(jax.random.key(0), [0, 0, 0, 0, 0, 0])
    res = icp_point_to_point(src, sm, tgt, tm, max_iterations=10)
    np.testing.assert_allclose(res.transform, jnp.eye(4), atol=1e-5)
    assert float(res.fitness) < 1e-8


def test_p2p_recovers_small_transform():
    src, sm, tgt, tm, T = make_pair(jax.random.key(1), [0.02, -0.01, 0.03, 0.05, -0.04, 0.06])
    res = icp_point_to_point(src, sm, tgt, tm, max_iterations=60)
    np.testing.assert_allclose(res.transform, T, atol=2e-3)
    assert float(res.fitness) < 1e-5
    assert bool(res.converged)


def test_p2p_fitness_is_mean_sq_dist():
    # Identical clouds offset by a known amount with huge corr distance:
    # after 0 iterations (max_iterations=0) fitness = mean sq NN dist.
    tgt = jnp.asarray(np.random.RandomState(0).randn(100, 3), jnp.float32)
    src = tgt + jnp.array([0.1, 0.0, 0.0])
    res = icp_point_to_point(src, jnp.ones(100, bool), tgt, jnp.ones(100, bool), max_iterations=0)
    # each source point's NN is its own counterpart at distance 0.1 --
    # unless another target point is closer; allow <= 0.01.
    assert float(res.fitness) <= 0.01 + 1e-6
    assert float(res.fitness) > 1e-4


def test_p2p_template_pose_convention():
    # Reference semantics (iterative_closest_point.cpp:170-182): source =
    # segmented scene cloud, target = template at origin; object pose =
    # inverse of ICP transform.
    template = jnp.asarray(cuboid_template(0.2, 0.1, 0.03, 0.004))
    pose = se3.se3_exp(jnp.array([0.03, -0.02, 0.01, 0.0, 0.0, 0.15]))
    scene = se3.transform_points(pose, template)
    m = jnp.ones(len(template), bool)
    res = icp_point_to_point(scene, m, template, m, max_iterations=200)
    recovered_pose = se3.inverse(res.transform)
    # Template grid pitch is 4 mm; ICP's basin is flat below that scale,
    # so allow ~2x pitch (well inside the reference's fitness<0.0004 gate).
    np.testing.assert_allclose(recovered_pose, pose, atol=8e-3)
    assert float(res.fitness) < 0.0004  # the launch-file acceptance gate


def test_p2plane_converges_faster():
    src, sm, tgt, tm, T = make_pair(jax.random.key(2), [0.05, 0.02, -0.04, 0.08, 0.05, -0.07])
    normals, _ = normals_knn(tgt, tm, k=10)
    res = icp_point_to_plane(src, sm, tgt, normals, tm, max_iterations=20)
    np.testing.assert_allclose(res.transform, T, atol=3e-3)
    assert int(res.iterations) <= 15


def test_p2plane_with_noise():
    src, sm, tgt, tm, T = make_pair(jax.random.key(3), [0.03, 0.01, -0.02, 0.04, -0.03, 0.05], noise=0.002)
    normals, _ = normals_knn(tgt, tm, k=10)
    res = icp_point_to_plane(src, sm, tgt, normals, tm, max_iterations=25)
    # Rotation/translation within noise-commensurate tolerance.
    err = se3.se3_log(res.transform @ se3.inverse(T))
    assert float(jnp.linalg.norm(err)) < 0.02


def test_icp_respects_masks():
    src, sm, tgt, tm, T = make_pair(jax.random.key(4), [0.02, 0, 0, 0, 0, 0.03])
    # Corrupt masked-out source points badly; result must be unaffected.
    n = src.shape[0]
    src_bad = src.at[: n // 4].add(10.0)
    sm_bad = sm.at[: n // 4].set(False)
    res = icp_point_to_point(src_bad, sm_bad, tgt, tm, max_iterations=60)
    np.testing.assert_allclose(res.transform, T, atol=5e-3)


def test_icp_batched_multi_restart():
    template = jnp.asarray(cuboid_template(0.2, 0.1, 0.03, 0.006))
    m = jnp.ones(len(template), bool)
    pose = se3.se3_exp(jnp.array([0.02, 0.01, -0.02, 0.0, 0.0, 0.2]))
    scene = se3.transform_points(pose, template)
    sources = jnp.stack([scene, scene])
    masks = jnp.stack([m, m])
    inits = jnp.stack([jnp.eye(4), se3.se3_exp(jnp.array([0.0, 0, 0, 0, 0, 0.1]))])
    res = icp_batched(sources, masks, template, m, init_transforms=inits, max_iterations=60)
    assert res.transform.shape == (2, 4, 4)
    for b in range(2):
        np.testing.assert_allclose(se3.inverse(res.transform[b]), pose, atol=1e-2)
