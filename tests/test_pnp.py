"""PnP (reprojection pose refinement) tests: exact recovery, robustness
to outliers, and the RANSAC variant. Capability analog: Ceres
reprojection refinement, poseTriangulation.cpp:228-269."""

import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry import se3
from perception.ops.pnp import pnp_gn, pnp_ransac

FX = FY = 300.0
CX, CY = 160.0, 120.0


def make_problem(key, n=120, twist=(0.1, -0.05, 0.02, 0.03, -0.02, 0.05)):
    pts = jax.random.uniform(key, (n, 3), minval=-1.0, maxval=1.0).at[:, 2].add(3.0)
    T = se3.se3_exp(jnp.asarray(twist, jnp.float32))
    pc = se3.transform_points(T, pts)
    uv = jnp.stack(
        [FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], axis=-1
    )
    return pts, uv, T


def test_pnp_gn_exact_recovery_from_perturbed_init():
    pts, uv, T_true = make_problem(jax.random.key(0))
    T0 = se3.se3_exp(jnp.asarray([0.08, -0.03, 0.0, 0.02, 0.0, 0.03]))
    res = pnp_gn(pts, uv, jnp.ones(len(pts), bool), FX, FY, CX, CY,
                 T_init=T0, iterations=8)
    np.testing.assert_allclose(np.asarray(res.transform), np.asarray(T_true), atol=1e-5)
    assert float(res.mean_px_error) < 1e-3


def test_pnp_gn_converges_from_identity():
    pts, uv, T_true = make_problem(jax.random.key(1))
    res = pnp_gn(pts, uv, jnp.ones(len(pts), bool), FX, FY, CX, CY, iterations=10)
    np.testing.assert_allclose(np.asarray(res.transform), np.asarray(T_true), atol=1e-4)


def test_pnp_gn_huber_downweights_outliers():
    pts, uv, T_true = make_problem(jax.random.key(2))
    uv_bad = uv.at[:18].add(60.0)  # 15% gross outliers
    res = pnp_gn(pts, uv_bad, jnp.ones(len(pts), bool), FX, FY, CX, CY,
                 T_init=T_true, iterations=8)
    # Translation stays within ~mm despite the outliers.
    np.testing.assert_allclose(
        np.asarray(res.transform[:3, 3]), np.asarray(T_true[:3, 3]), atol=5e-3
    )


def test_pnp_gn_respects_mask():
    pts, uv, T_true = make_problem(jax.random.key(3))
    # Corrupt masked-out entries arbitrarily; the solve must not care.
    uv_bad = uv.at[:30].set(0.0)
    mask = jnp.ones(len(pts), bool).at[:30].set(False)
    res = pnp_gn(pts, uv_bad, mask, FX, FY, CX, CY, iterations=10)
    np.testing.assert_allclose(np.asarray(res.transform), np.asarray(T_true), atol=1e-4)


def test_pnp_ransac_rejects_outliers_and_validates():
    pts, uv, T_true = make_problem(jax.random.key(4))
    uv_bad = uv.at[:25].add(80.0)
    res, inliers, valid = pnp_ransac(
        pts, uv_bad, jnp.ones(len(pts), bool), jax.random.key(5),
        FX, FY, CX, CY, threshold_px=3.0,
    )
    assert bool(valid)
    assert int(jnp.sum(inliers)) >= 90
    # The corrupted points are not inliers.
    assert int(jnp.sum(inliers[:25])) == 0
    np.testing.assert_allclose(
        np.asarray(res.transform), np.asarray(T_true), atol=2e-3
    )


def test_pnp_gn_masked_empty_is_finite():
    pts, uv, _ = make_problem(jax.random.key(6))
    res = pnp_gn(pts, uv, jnp.zeros(len(pts), bool), FX, FY, CX, CY)
    assert bool(jnp.all(jnp.isfinite(res.transform)))
    assert int(res.num_used) == 0
