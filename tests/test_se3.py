import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.geometry import se3


def random_twists(key, n, rot_scale=1.0, trans_scale=1.0):
    k1, k2 = jax.random.split(key)
    rho = jax.random.normal(k1, (n, 3)) * trans_scale
    omega = jax.random.normal(k2, (n, 3)) * rot_scale
    return jnp.concatenate([rho, omega], axis=-1)


def test_hat_vee_roundtrip():
    w = jnp.array([[0.1, -0.2, 0.3], [1.0, 2.0, 3.0]])
    np.testing.assert_allclose(se3.vee(se3.hat(w)), w, atol=1e-6)


def test_so3_exp_is_rotation():
    key = jax.random.key(0)
    omega = jax.random.normal(key, (64, 3)) * 2.0
    R = se3.so3_exp(omega)
    eye = jnp.broadcast_to(jnp.eye(3), R.shape)
    np.testing.assert_allclose(R @ jnp.swapaxes(R, -1, -2), eye, atol=1e-5)
    np.testing.assert_allclose(jnp.linalg.det(R), jnp.ones(64), atol=1e-5)


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1.0, 3.0])
def test_so3_exp_log_roundtrip(scale):
    key = jax.random.key(1)
    omega = jax.random.normal(key, (32, 3))
    omega = omega / jnp.linalg.norm(omega, axis=-1, keepdims=True) * scale
    back = se3.so3_log(se3.so3_exp(omega))
    np.testing.assert_allclose(back, omega, atol=max(1e-5, scale * 1e-4))


def test_so3_log_near_pi():
    # Rotation by pi - small around an arbitrary axis: trace route degenerates.
    axis = jnp.array([1.0, 2.0, -0.5])
    axis = axis / jnp.linalg.norm(axis)
    for theta in [np.pi - 1e-4, np.pi - 1e-2, 3.0]:
        omega = axis * theta
        R = se3.so3_exp(omega)
        back = se3.so3_log(R)
        np.testing.assert_allclose(back, omega, atol=1e-3)


def test_se3_exp_log_roundtrip():
    # log returns the wrapped (|omega| <= pi) twist, so compare in the
    # group: exp(log(T)) == T for arbitrary T.
    xi = random_twists(jax.random.key(2), 32)
    T = se3.se3_exp(xi)
    T2 = se3.se3_exp(se3.se3_log(T))
    np.testing.assert_allclose(T2, T, atol=1e-4)
    # And exact twist roundtrip within the injectivity radius.
    xi_small = random_twists(jax.random.key(9), 32, rot_scale=0.5)
    np.testing.assert_allclose(se3.se3_log(se3.se3_exp(xi_small)), xi_small, atol=1e-4)


def test_se3_exp_small_angle_is_translation():
    xi = jnp.array([0.5, -0.25, 0.125, 0.0, 0.0, 0.0])
    T = se3.se3_exp(xi)
    np.testing.assert_allclose(T[:3, :3], jnp.eye(3), atol=1e-6)
    np.testing.assert_allclose(T[:3, 3], xi[:3], atol=1e-6)


def test_inverse():
    xi = random_twists(jax.random.key(3), 16)
    T = se3.se3_exp(xi)
    TT = T @ se3.inverse(T)
    np.testing.assert_allclose(TT, jnp.broadcast_to(jnp.eye(4), TT.shape), atol=1e-5)


def test_transform_points_matches_homogeneous():
    T = se3.se3_exp(random_twists(jax.random.key(4), 1))[0]
    pts = jax.random.normal(jax.random.key(5), (100, 3))
    out = se3.transform_points(T, pts)
    hom = jnp.concatenate([pts, jnp.ones((100, 1))], axis=-1)
    expected = (hom @ T.T)[:, :3]
    np.testing.assert_allclose(out, expected, atol=1e-5)


def test_quat_matrix_roundtrip():
    key = jax.random.key(6)
    q = jax.random.normal(key, (64, 4))
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    R = se3.quat_to_matrix(q)
    q2 = se3.matrix_to_quat(R)
    # q and -q encode the same rotation; compare via |dot| = 1.
    dots = jnp.abs(jnp.sum(q * q2, axis=-1))
    np.testing.assert_allclose(dots, jnp.ones(64), atol=1e-5)


def test_orthonormalize_projects_noise():
    R0 = se3.so3_exp(jnp.array([0.3, -0.4, 0.5]))
    noisy = R0 + 0.01 * jax.random.normal(jax.random.key(7), (3, 3))
    R = se3.orthonormalize(noisy)
    np.testing.assert_allclose(R @ R.T, jnp.eye(3), atol=1e-5)
    assert jnp.linalg.det(R) > 0
    assert jnp.abs(R - R0).max() < 0.05


def test_jit_and_vmap_compose():
    f = jax.jit(jax.vmap(se3.se3_exp))
    xi = random_twists(jax.random.key(8), 8)
    np.testing.assert_allclose(f(xi), se3.se3_exp(xi), atol=1e-6)
