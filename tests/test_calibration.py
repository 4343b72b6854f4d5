import jax
import pytest
import jax.numpy as jnp
import numpy as np

from perception.geometry import se3
from perception.ops.calibration import (
    average_rotations,
    calibrate_camera,
    chessboard_object_points,
    extrinsics_from_homography,
    homography_dlt,
    intrinsics_zhang,
    pairwise_extrinsics,
)

K_TRUE = np.array([[600.0, 0, 320], [0, 590.0, 240], [0, 0, 1]], np.float32)


def board_views(n_views=6, rows=5, cols=7, square=0.03, noise=0.0, seed=0):
    rng = np.random.RandomState(seed)
    obj = chessboard_object_points(rows, cols, square)  # (N, 2)
    obj3 = np.concatenate([obj, np.zeros((len(obj), 1))], 1)
    uvs, Ts = [], []
    for v in range(n_views):
        tw = np.array([
            rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), rng.uniform(0.4, 0.7),
            rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(-0.5, 0.5),
        ], np.float32)
        T = np.asarray(se3.se3_exp(jnp.asarray(tw)))  # camera <- board
        pc = obj3 @ T[:3, :3].T + T[:3, 3]
        uv = (pc @ K_TRUE.T)
        uv = uv[:, :2] / uv[:, 2:]
        uv += rng.randn(*uv.shape) * noise
        uvs.append(uv.astype(np.float32))
        Ts.append(T)
    return jnp.asarray(obj), jnp.asarray(np.stack(uvs)), np.stack(Ts)


def test_homography_exact():
    obj, uvs, Ts = board_views(1)
    H = homography_dlt(obj, uvs[0])
    hom = jnp.concatenate([obj, jnp.ones((obj.shape[0], 1))], axis=1)
    proj = hom @ H.T
    uv_h = proj[:, :2] / proj[:, 2:]
    np.testing.assert_allclose(np.asarray(uv_h), np.asarray(uvs[0]), atol=1e-2)


def test_zhang_recovers_intrinsics():
    obj, uvs, _ = board_views(8, noise=0.0)
    K, Ts = calibrate_camera(obj, uvs)
    K = np.asarray(K)
    assert abs(K[0, 0] - 600) < 2.0
    assert abs(K[1, 1] - 590) < 2.0
    assert abs(K[0, 2] - 320) < 2.0
    assert abs(K[1, 2] - 240) < 2.0


def test_zhang_with_pixel_noise():
    obj, uvs, _ = board_views(10, noise=0.3, seed=1)
    K, _ = calibrate_camera(obj, uvs)
    K = np.asarray(K)
    assert abs(K[0, 0] - 600) < 15
    assert abs(K[1, 2] - 240) < 10


def test_extrinsics_recovered():
    obj, uvs, Ts_true = board_views(6, seed=2)
    K, Ts = calibrate_camera(obj, uvs)
    for v in range(6):
        est = np.asarray(Ts[v])
        assert np.linalg.norm(est[:3, 3] - Ts_true[v][:3, 3]) < 0.01
        dR = np.degrees(np.arccos(np.clip((np.trace(est[:3, :3].T @ Ts_true[v][:3, :3]) - 1) / 2, -1, 1)))
        assert dR < 1.0


def test_average_rotations():
    base = np.asarray(se3.so3_exp(jnp.asarray([0.2, -0.1, 0.3])))
    rng = np.random.RandomState(0)
    Rs = []
    for _ in range(20):
        pert = np.asarray(se3.so3_exp(jnp.asarray(rng.randn(3) * 0.02, jnp.float32)))
        Rs.append(base @ pert)
    R_avg = np.asarray(average_rotations(jnp.asarray(np.stack(Rs), jnp.float32)))
    dR = np.degrees(np.arccos(np.clip((np.trace(R_avg.T @ base) - 1) / 2, -1, 1)))
    assert dR < 0.5


def test_pairwise_extrinsics():
    # Two cameras with a known relative pose observing the same boards.
    obj, uvs0, Ts0 = board_views(6, seed=3)
    T_01 = np.asarray(se3.se3_exp(jnp.asarray([0.1, 0.0, 0.02, 0.0, 0.15, 0.0], jnp.float32)))
    # Board pose in cam1: T_c1_b = T_01^-1 @ T_c0_b  (cam0 <- cam1 = T_01)
    Ts1 = np.einsum("ij,vjk->vik", np.linalg.inv(T_01), Ts0)
    est = np.asarray(pairwise_extrinsics(jnp.asarray(Ts0), jnp.asarray(Ts1)))
    np.testing.assert_allclose(est, T_01, atol=1e-4)


@pytest.mark.slow  # ~10-13 s on the 2-core CI host (CI-budget triage, r5)
def test_joint_extrinsics_refine_recovers_rig():
    """Joint multi-camera refinement (cameraParameterEstimation.cpp's
    BA-flavored stage): noisy pairwise-style inits converge to the GT
    rig to sub-mm from 0.3-px corner noise."""
    from perception.geometry import se3
    from perception.ops.calibration import (
        chessboard_object_points,
        joint_extrinsics_refine,
    )

    rng = np.random.RandomState(0)
    C, B = 3, 6
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    Ks = jnp.asarray(np.stack([K] * C))
    obj = np.asarray(chessboard_object_points(4, 5, 0.03), np.float32)
    if obj.shape[1] == 2:  # planar board: z = 0
        obj = np.concatenate([obj, np.zeros((len(obj), 1), np.float32)], 1)
    obj3 = jnp.asarray(obj, jnp.float32)

    # GT rig: cameras spread on a small arc; boards in front.
    cam_twists = np.zeros((C, 6), np.float32)
    cam_twists[:, 0] = np.arange(C) * 0.15
    cam_twists[:, 4] = np.arange(C) * -0.1
    T_cam_gt = np.array(se3.se3_exp(jnp.asarray(cam_twists)))
    board_twists = rng.randn(B, 6).astype(np.float32) * 0.1
    board_twists[:, 2] += 0.0
    T_board_gt = np.array(se3.se3_exp(jnp.asarray(board_twists)))
    T_board_gt[:, 2, 3] += 0.8  # boards ~0.8 m in front of the rig

    # Observations with pixel noise.
    def project(Tc, Tb):
        X = (np.linalg.inv(Tc) @ Tb @ np.concatenate(
            [obj, np.ones((len(obj), 1))], 1).T).T[:, :3]
        return (X[:, :2] / X[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    obs = np.zeros((C, B, len(obj), 2), np.float32)
    for c in range(C):
        for b in range(B):
            obs[c, b] = project(T_cam_gt[c], T_board_gt[b])
    obs += rng.randn(*obs.shape).astype(np.float32) * 0.3
    mask = np.ones((C, B), bool)

    # Perturbed init (what noisy pairwise estimation gives).
    pert_c = rng.randn(C, 6).astype(np.float32) * 0.01
    pert_c[0] = 0.0
    pert_b = rng.randn(B, 6).astype(np.float32) * 0.01
    T_cam0 = np.asarray(se3.se3_exp(jnp.asarray(pert_c))) @ T_cam_gt
    T_board0 = np.asarray(se3.se3_exp(jnp.asarray(pert_b))) @ T_board_gt

    Tc, Tb, rms0, rms1 = joint_extrinsics_refine(
        jnp.asarray(T_cam0), jnp.asarray(T_board0), Ks, obj3,
        jnp.asarray(obs), jnp.asarray(mask), iterations=8,
    )
    assert float(rms1) < float(rms0) * 0.5
    assert float(rms1) < 0.5  # at the injected noise floor
    # Camera extrinsics: sub-mm translation error relative to camera 0.
    err = np.abs(np.asarray(Tc)[:, :3, 3] - T_cam_gt[:, :3, 3]).max()
    assert err < 2e-3, err
