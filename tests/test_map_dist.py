"""Map-block-partitioned odometry GN (parallel/map_dist.py) on the
virtual 8-device CPU mesh: sharded == single-device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.geometry import se3
from perception.ops.normals import normals_knn


def _mesh(n, axis="mp"):
    devs = jax.devices()[:n]
    return jax.sharding.Mesh(np.array(devs), (axis,))


def _scene(key, m=4096, n=1024):
    k1, k2, k3 = jax.random.split(key, 3)
    tgt = jax.random.uniform(k1, (m, 3), minval=-0.5, maxval=0.5)
    # Three orthogonal planes: anything less leaves a translation DOF
    # unconstrained for point-to-plane.
    tgt = tgt.at[: m // 3, 2].set(0.0)
    tgt = tgt.at[m // 3 : 2 * m // 3, 1].set(0.0)
    tgt = tgt.at[2 * m // 3 :, 0].set(0.0)
    tmask = jnp.ones(m, bool)
    tnrm, _ = normals_knn(tgt, tmask, k=8)
    T_gt = se3.se3_exp(jax.random.normal(k2, (6,)) * 0.02)
    sel = jax.random.randint(k3, (n,), 0, m)
    src = se3.transform_points(se3.inverse(T_gt), tgt[sel])
    return tgt, tnrm, tmask, src, jnp.ones(n, bool), T_gt


def _single_gn(map_pts, map_nrm, map_mask, src, src_mask, T0,
               iterations=8, max_corr=0.25, huber=0.02, damping=1e-5):
    from perception.ops import nn as _nn
    from perception.ops.icp import _huber_weight

    max_d2 = max_corr * max_corr

    def gn_body(T, _):
        src_t = se3.transform_points(T, src)
        idx, d2 = _nn.nearest_neighbor(src_t, map_pts, map_mask)
        gate = src_mask & (d2 <= max_d2)
        q = map_pts[idx]
        nrm = map_nrm[idx]
        r = jnp.sum(nrm * (src_t - q), axis=-1)
        w = gate.astype(src.dtype) * _huber_weight(r, huber)
        J = jnp.concatenate([nrm, jnp.cross(src_t, nrm)], axis=-1)
        Jw = J * w[:, None]
        A = Jw.T @ J + damping * jnp.eye(6, dtype=src.dtype)
        b = -(Jw.T @ r)
        return se3.se3_exp(jnp.linalg.solve(A, b)) @ T, None

    T, _ = jax.lax.scan(gn_body, T0, None, length=iterations)
    return T


@pytest.mark.parametrize("n_dev", [4, 8])
def test_map_sharded_matches_single(n_dev):
    if len(jax.devices()) < n_dev:
        pytest.skip("needs virtual device mesh")
    from perception.parallel.map_dist import (
        make_map_sharded_gn,
        map_sharding,
    )

    mesh = _mesh(n_dev)
    tgt, tnrm, tmask, src, smask, T_gt = _scene(jax.random.key(0))
    T0 = jnp.eye(4)

    step = make_map_sharded_gn(mesh, iterations=8)
    ms = map_sharding(mesh)
    res = step(
        jax.device_put(tgt, ms), jax.device_put(tnrm, ms),
        jax.device_put(tmask, ms), src, smask, T0,
    )
    T_ref = _single_gn(tgt, tnrm, tmask, src, smask, T0)

    np.testing.assert_allclose(
        np.asarray(res.transform), np.asarray(T_ref), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(res.transform), np.asarray(T_gt), atol=5e-3
    )
    assert float(res.fitness) < 1e-4


def test_map_sharded_trajectory():
    """Integrated mini-trajectory: sequential frames tracked against a
    static sharded map, trajectory == single-device to tolerance."""
    if len(jax.devices()) < 8:
        pytest.skip("needs virtual device mesh")
    from perception.parallel.map_dist import (
        make_map_sharded_gn,
        map_sharding,
    )

    mesh = _mesh(8)
    tgt, tnrm, tmask, _, _, _ = _scene(jax.random.key(1), m=4096)
    ms = map_sharding(mesh)
    tgt_s = jax.device_put(tgt, ms)
    tnrm_s = jax.device_put(tnrm, ms)
    tmask_s = jax.device_put(tmask, ms)
    step = make_map_sharded_gn(mesh, iterations=6)

    key = jax.random.key(2)
    T_prev_s = jnp.eye(4)
    T_prev_r = jnp.eye(4)
    for f in range(4):
        key, ka, kb = jax.random.split(key, 3)
        T_gt = se3.se3_exp(
            jnp.asarray([0.02 * (f + 1), 0.01 * f, 0.0, 0.0, 0.01 * f, 0.0])
        )
        sel = jax.random.randint(kb, (1024,), 0, tgt.shape[0])
        src = se3.transform_points(se3.inverse(T_gt), tgt[sel])
        smask = jnp.ones(1024, bool)
        res = step(tgt_s, tnrm_s, tmask_s, src, smask, T_prev_s)
        T_ref = _single_gn(tgt, tnrm, tmask, src, smask, T_prev_r,
                           iterations=6)
        np.testing.assert_allclose(
            np.asarray(res.transform), np.asarray(T_ref), atol=5e-4
        )
        T_prev_s = res.transform
        T_prev_r = T_ref
