"""Camera calibration: homographies, Zhang intrinsics, extrinsics.

Capability parity with the reference's calibration module
(``openpose/src/openpose/calibration/cameraParameterEstimation.cpp``:
chessboard intrinsics, pairwise multi-camera extrinsics). The math is
batched jnp (Zhang's method); chessboard *detection* is in-house
(``ops/chessboard.py``: device saddle response + host lattice ordering),
with a cv2 backend kept for cross-validation.

Pipeline: per-view DLT homographies (normalized), the IAC constraint
system -> closed-form K, per-view extrinsics from H and K, and
pairwise camera-to-camera extrinsics by averaging per-view relative
poses (rotation averaging via quaternion eigen-mean).
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry import se3


def homography_dlt(obj_xy: jax.Array, img_uv: jax.Array) -> jax.Array:
    """Planar DLT homography H (3, 3): img ~ H [X, Y, 1], with Hartley
    normalization for conditioning."""

    def normalizer(pts):
        c = pts.mean(axis=0)
        s = jnp.sqrt(2.0) / jnp.maximum(jnp.linalg.norm(pts - c, axis=1).mean(), 1e-9)
        T = jnp.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        return T

    To = normalizer(obj_xy)
    Ti = normalizer(img_uv)
    o = jnp.concatenate([obj_xy, jnp.ones_like(obj_xy[:, :1])], axis=1) @ To.T
    i = jnp.concatenate([img_uv, jnp.ones_like(img_uv[:, :1])], axis=1) @ Ti.T

    n = obj_xy.shape[0]
    zeros = jnp.zeros((n, 3))
    r1 = jnp.concatenate([o, zeros, -i[:, 0:1] * o], axis=1)
    r2 = jnp.concatenate([zeros, o, -i[:, 1:2] * o], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2n, 9)
    _, V = jnp.linalg.eigh(A.T @ A)
    h = V[:, 0]
    H = h.reshape(3, 3)
    H = jnp.linalg.inv(Ti) @ H @ To
    return H / H[2, 2]


def _v_ij(H, i, j):
    return jnp.array(
        [
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ]
    )


def intrinsics_zhang(homographies: jax.Array) -> jax.Array:
    """(V, 3, 3) homographies (>= 3 views) -> K (3, 3) by the IAC
    constraints (Zhang 2000, closed form)."""

    def rows(H):
        return jnp.stack([_v_ij(H, 0, 1), _v_ij(H, 0, 0) - _v_ij(H, 1, 1)])

    Vm = jax.vmap(rows)(homographies).reshape(-1, 6)
    _, evecs = jnp.linalg.eigh(Vm.T @ Vm)
    b11, b12, b22, b13, b23, b33 = evecs[:, 0]

    v0 = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + v0 * (b12 * b13 - b11 * b23)) / b11
    alpha = jnp.sqrt(jnp.abs(lam / b11))
    beta = jnp.sqrt(jnp.abs(lam * b11 / (b11 * b22 - b12 * b12)))
    gamma = -b12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - b13 * alpha * alpha / lam
    return jnp.array([[alpha, gamma, u0], [0.0, beta, v0], [0.0, 0.0, 1.0]])


def extrinsics_from_homography(K: jax.Array, H: jax.Array) -> jax.Array:
    """Board pose (camera <- board, (4, 4)) from K and the view's H."""
    Kinv = jnp.linalg.inv(K)
    h1 = Kinv @ H[:, 0]
    h2 = Kinv @ H[:, 1]
    h3 = Kinv @ H[:, 2]
    lam = 1.0 / jnp.maximum(jnp.linalg.norm(h1), 1e-12)
    # The homography scale sign is arbitrary; a board behind the camera
    # (t_z < 0) means it was flipped — negate r1, r2, t.
    flip = jnp.sign(h3[2] * lam)
    flip = jnp.where(flip == 0, 1.0, flip)
    r1 = h1 * lam * flip
    r2 = h2 * lam * flip
    t = h3 * lam * flip
    r3 = jnp.cross(r1, r2)
    R = se3.orthonormalize(jnp.stack([r1, r2, r3], axis=1))
    return se3.make_T(R, t)


def average_rotations(Rs: jax.Array) -> jax.Array:
    """Chordal L2 rotation average via the quaternion eigen-method."""
    qs = jax.vmap(se3.matrix_to_quat)(Rs)  # (V, 4)
    # Align hemispheres to the first quaternion.
    ref = qs[0]
    signs = jnp.sign(jnp.sum(qs * ref, axis=1, keepdims=True))
    signs = jnp.where(signs == 0, 1.0, signs)
    qs = qs * signs
    M = qs.T @ qs
    _, V = jnp.linalg.eigh(M)
    q = V[:, -1]
    return se3.quat_to_matrix(q)


def pairwise_extrinsics(T_cam0_board: jax.Array, T_cam1_board: jax.Array) -> jax.Array:
    """(V, 4, 4) board poses in two cameras -> averaged T_cam0_cam1."""
    rel = T_cam0_board @ se3.inverse(T_cam1_board)  # (V, 4, 4)
    R = average_rotations(rel[:, :3, :3])
    t = rel[:, :3, 3].mean(axis=0)
    return se3.make_T(R, t)


def chessboard_object_points(rows: int, cols: int, square: float) -> np.ndarray:
    """(rows*cols, 2) planar board model (meters)."""
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return np.stack([xs.ravel() * square, ys.ravel() * square], 1).astype(np.float32)


def detect_chessboard(gray: np.ndarray, rows: int, cols: int, backend: str = "native"):
    """Corner detection; returns (rows*cols, 2) row-major or None.

    ``backend='native'`` (default) uses the in-house saddle detector +
    lattice ordering (``ops/chessboard.py`` — the gridPatternFunctions
    capability); ``backend='cv2'`` delegates to OpenCV at the host edge."""
    if backend == "native":
        from perception.ops.chessboard import detect_chessboard_native

        g = np.asarray(gray, np.float32)
        if g.max() > 1.5:  # uint8-scaled input
            g = g / 255.0
        return detect_chessboard_native(g, rows, cols)

    import cv2

    found, corners = cv2.findChessboardCorners(
        gray.astype(np.uint8), (cols, rows),
        flags=cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE,
    )
    if not found:
        return None
    corners = cv2.cornerSubPix(
        gray.astype(np.uint8), corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3),
    )
    return corners.reshape(-1, 2)


def calibrate_camera(
    object_xy: jax.Array,
    image_uvs: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """(N, 2) board model + (V, N, 2) corner observations ->
    (K (3, 3), board poses (V, 4, 4))."""
    Hs = jax.vmap(lambda uv: homography_dlt(object_xy, uv))(image_uvs)
    K = intrinsics_zhang(Hs)
    Ts = jax.vmap(lambda H: extrinsics_from_homography(K, H))(Hs)
    return K, Ts


def joint_extrinsics_refine(
    T_rig_cam: jax.Array,     # (C, 4, 4) rig <- camera initial extrinsics
    T_rig_board: jax.Array,   # (B, 4, 4) rig <- board initial poses
    Ks: jax.Array,            # (C, 3, 3) per-camera intrinsics
    obj_pts: jax.Array,       # (P, 3) board-frame corner points
    obs_uv: jax.Array,        # (C, B, P, 2) detected corners
    obs_mask: jax.Array,      # (C, B) board visible in camera
    iterations: int = 10,
    damping: float = 1e-4,
    huber_px: float = 2.0,
):
    """Joint bundle-adjustment-flavored refinement of a multi-camera
    rig: ALL camera extrinsics and ALL board poses optimized together
    over every corner reprojection (the reference's
    ``cameraParameterEstimation.cpp`` refinement stage, after its
    pairwise-SVD initialization — here the init is
    ``pairwise_extrinsics``/``average_rotations``).

    Gauss-Newton over se(3) twists with camera 0 gauge-fixed; the
    full Jacobian comes from one ``jacfwd`` over the stacked
    (C + B) x 6 update (rig problems are tiny: C <= ~8 cameras,
    B <= ~64 boards). Returns (T_rig_cam', T_rig_board',
    initial_rms_px, final_rms_px).
    """
    C = T_rig_cam.shape[0]
    B = T_rig_board.shape[0]
    mask_f = obs_mask.astype(jnp.float32)[:, :, None, None]

    def residuals(T_cams, T_boards):
        # point in camera c: T_cam^-1 T_board X
        T_cb = jnp.einsum("cij,bjk->cbik", se3.inverse(T_cams), T_boards)
        pc = (
            jnp.einsum("cbij,pj->cbpi", T_cb[..., :3, :3], obj_pts)
            + T_cb[:, :, None, :3, 3]
        )
        z = jnp.maximum(pc[..., 2], 1e-6)
        u = Ks[:, None, None, 0, 0] * pc[..., 0] / z + Ks[:, None, None, 0, 2]
        v = Ks[:, None, None, 1, 1] * pc[..., 1] / z + Ks[:, None, None, 1, 2]
        r = (jnp.stack([u, v], axis=-1) - obs_uv) * mask_f
        return r  # (C, B, P, 2)

    def apply(delta, T_cams, T_boards):
        dc = delta[: C * 6].reshape(C, 6)
        dc = dc.at[0].set(0.0)  # gauge: camera 0 frozen
        db = delta[C * 6:].reshape(B, 6)
        return se3.se3_exp(dc) @ T_cams, se3.se3_exp(db) @ T_boards

    n_obs = jnp.maximum(jnp.sum(mask_f) * obj_pts.shape[0] * 2, 1.0)

    def rms(T_cams, T_boards):
        r = residuals(T_cams, T_boards)
        return jnp.sqrt(jnp.sum(r * r) / n_obs)

    def step(carry, _):
        T_cams, T_boards = carry

        def r_of(delta):
            tc, tb = apply(delta, T_cams, T_boards)
            return residuals(tc, tb).reshape(-1)

        d0 = jnp.zeros((C + B) * 6)
        r = r_of(d0)
        J = jax.jacfwd(r_of)(d0)          # (N, (C+B)*6)
        # Huber IRLS on per-corner residual norms.
        rn = jnp.sqrt(r[0::2] ** 2 + r[1::2] ** 2)
        w = jnp.where(rn <= huber_px, 1.0, huber_px / jnp.maximum(rn, 1e-9))
        w2 = jnp.repeat(w, 2)
        Jw = J * w2[:, None]
        A = Jw.T @ J + damping * jnp.eye(J.shape[1])
        # Gauge rows/cols for camera 0.
        g = jnp.arange(6)
        A = A.at[g].set(0.0).at[:, g].set(0.0)
        A = A.at[g, g].set(1.0)
        b = -(Jw.T @ r)
        b = b.at[g].set(0.0)
        delta = jnp.linalg.solve(A, b)
        tc, tb = apply(delta, T_cams, T_boards)
        better = rms(tc, tb) < rms(T_cams, T_boards)
        return (
            jnp.where(better, tc, T_cams),
            jnp.where(better, tb, T_boards),
        ), None

    rms0 = rms(T_rig_cam, T_rig_board)
    (Tc, Tb), _ = jax.lax.scan(
        step, (T_rig_cam, T_rig_board), None, length=iterations
    )
    Tc = se3.orthonormalize_T(Tc)
    Tb = se3.orthonormalize_T(Tb)
    return Tc, Tb, rms0, rms(Tc, Tb)
