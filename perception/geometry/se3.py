"""SO(3)/SE(3) Lie-group utilities, pure jnp (f32, batch-friendly).

The reference stack represents rigid transforms as Eigen 4x4 matrices and
tf quaternions (e.g. pose assembly in
``cuboid_detection/src/surface_normal_estimation.cpp:221-225`` and the
quaternion helpers in ``openface2_ros/src/openface2_ros.cpp:53-79``).
Here the canonical representation is a 4x4 homogeneous matrix plus the
tangent-space (twist) parameterization needed by Gauss-Newton ICP and
bundle adjustment; all functions broadcast over leading batch dims so
``vmap``/``pjit`` compose cleanly.

Twist convention: xi = (rho, omega) in R^6 — translation part first,
rotation part second; se3_exp uses the full closed-form (V-matrix) map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from perception.geometry import f32

_EPS = 1e-8


def hat(omega: jax.Array) -> jax.Array:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = jnp.zeros_like(ox)
    return jnp.stack(
        [
            jnp.stack([zeros, -oz, oy], axis=-1),
            jnp.stack([oz, zeros, -ox], axis=-1),
            jnp.stack([-oy, ox, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(omega_hat: jax.Array) -> jax.Array:
    """Inverse of hat: (..., 3, 3) skew -> (..., 3)."""
    return jnp.stack(
        [omega_hat[..., 2, 1], omega_hat[..., 0, 2], omega_hat[..., 1, 0]],
        axis=-1,
    )


def so3_exp(omega: jax.Array) -> jax.Array:
    """Rodrigues' formula: (..., 3) axis-angle -> (..., 3, 3) rotation.

    Numerically safe at theta -> 0 via Taylor fallbacks (branchless
    jnp.where so it jits and differentiates cleanly).
    """
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta_sq + _EPS * _EPS)  # guarded; exact value masked below
    small = theta_sq < 1e-8

    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta_sq, _EPS * _EPS))

    K = hat(omega)
    KK = f32.matmul(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Routes through the branchless Shepperd quaternion (robust at every
    angle, including theta ~ pi where the trace formula degenerates):
    omega = 2 * atan2(|v|, w) * v / |v| for q = (v, w).
    """
    q = matrix_to_quat(R)
    v, w = q[..., :3], q[..., 3]
    # Force the shorter rotation (w >= 0) so theta in [0, pi].
    v = jnp.where(w[..., None] < 0, -v, v)
    w = jnp.abs(w)
    vnorm = jnp.linalg.norm(v, axis=-1)
    theta = 2.0 * jnp.arctan2(vnorm, w)
    # theta/sin(theta/2) = theta/vnorm with Taylor fallback 2/w-ish near 0.
    scale = jnp.where(vnorm < 1e-6, 2.0 / jnp.maximum(w, _EPS), theta / jnp.maximum(vnorm, _EPS))
    return scale[..., None] * v


def _so3_left_jacobian(omega: jax.Array) -> jax.Array:
    """V matrix of SE(3) exp: integrates rotation along the twist."""
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8

    b = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta_sq, _EPS * _EPS))
    c = jnp.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - jnp.sin(theta)) / jnp.maximum(theta_sq * theta, _EPS),
    )
    K = hat(omega)
    KK = f32.matmul(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * KK


def se3_exp(xi: jax.Array) -> jax.Array:
    """Twist (..., 6) = (rho, omega) -> (..., 4, 4) homogeneous transform."""
    rho, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    V = _so3_left_jacobian(omega)
    t = f32.einsum("...ij,...j->...i", V, rho)
    return make_T(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """Homogeneous transform (..., 4, 4) -> twist (..., 6) = (rho, omega)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    V = _so3_left_jacobian(omega)
    rho = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([rho, omega], axis=-1)


def make_T(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def orthonormalize_T(T: jax.Array) -> jax.Array:
    """Project the rotation block of (..., 4, 4) back onto SO(3)
    (Gram-Schmidt). See also ``orthonormalize`` for bare (..., 3, 3)
    rotations (SVD projection).

    Long products of f32 transforms drift off the manifold; worse,
    ``inverse`` (a transpose) *doubles* any symmetric deviation S per
    round trip — inverse(Q(I+S)) @ Q(I+S) = I + 2S + O(S^2) — so a
    pose-tracking loop that composes inverse(kf_pose) @ pose every
    frame amplifies float seed error exponentially (measured: 1e-6
    doubling per frame blew up SLAM odometry by frame ~17). Every
    long-lived pose must round-trip through this projection.
    """
    R = T[..., :3, :3]
    c0 = R[..., :, 0]
    c0 = c0 / jnp.maximum(jnp.linalg.norm(c0, axis=-1, keepdims=True), _EPS)
    c1 = R[..., :, 1]
    c1 = c1 - jnp.sum(c0 * c1, axis=-1, keepdims=True) * c0
    c1 = c1 / jnp.maximum(jnp.linalg.norm(c1, axis=-1, keepdims=True), _EPS)
    c2 = jnp.cross(c0, c1)
    return make_T(jnp.stack([c0, c1, c2], axis=-1), T[..., :3, 3])


def inverse(T: jax.Array) -> jax.Array:
    """Closed-form SE(3) inverse (mirrors Eigen ``.inverse()`` use at
    ``cuboid_detection/src/iterative_closest_point.cpp:179``)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -f32.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: jax.Array, points: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return f32.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def rotate_points(T: jax.Array, vectors: jax.Array) -> jax.Array:
    """Apply only the rotation of (..., 4, 4) to vectors (..., N, 3)."""
    return f32.einsum("...ij,...nj->...ni", T[..., :3, :3], vectors)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Quaternion (..., 4) in (x, y, z, w) order (tf convention) -> (..., 3, 3)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], axis=-1),
            jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], axis=-1),
            jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), (x, y, z, w).

    Shepperd's method, branchless: compute all four candidate encodings
    and select the best-conditioned one by the largest pivot.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    # Candidate 0: w-dominant
    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = jnp.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, s0 / 4.0], axis=-1)
    # Candidate 1: x-dominant
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([s1 / 4.0, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], axis=-1)
    # Candidate 2: y-dominant
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = jnp.stack([(m01 + m10) / s2, s2 / 4.0, (m12 + m21) / s2, (m02 - m20) / s2], axis=-1)
    # Candidate 3: z-dominant
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = jnp.stack([(m02 + m20) / s3, (m12 + m21) / s3, s3 / 4.0, (m10 - m01) / s3], axis=-1)

    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(qs, best[..., None, None] * jnp.ones_like(qs[..., :1, :], dtype=jnp.int32), axis=-2)[..., 0, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def orthonormalize(R: jax.Array) -> jax.Array:
    """Project (..., 3, 3) back onto SO(3) via SVD (det +1 enforced)."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(f32.matmul(U, Vt))
    D = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), U.shape).at[..., 2, 2].multiply(0).at[..., 2, 2].add(det)
    return f32.matmul(f32.matmul(U, D), Vt)
