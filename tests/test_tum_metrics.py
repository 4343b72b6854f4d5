import numpy as np
import pytest

from perception.io.tum import (
    TumSequence,
    associate,
    read_trajectory,
    tum_camera,
    write_trajectory,
)
from perception.utils.metrics import ate, align_umeyama, rpe


def make_tum_dir(tmp_path, n=5):
    import cv2

    (tmp_path / "depth").mkdir()
    (tmp_path / "rgb").mkdir()
    depth_lines, rgb_lines, gt_lines = ["# depth"], ["# rgb"], ["# gt"]
    for i in range(n):
        t = 100.0 + i * 0.033
        d = np.full((48, 64), 5000 + 100 * i, np.uint16)  # 1.0 + 0.02i m
        d[0, 0] = 0
        cv2.imwrite(str(tmp_path / "depth" / f"{t:.6f}.png"), d)
        rgb = np.full((48, 64, 3), i * 10, np.uint8)
        cv2.imwrite(str(tmp_path / "rgb" / f"{t + 0.005:.6f}.png"), rgb)
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
        rgb_lines.append(f"{t + 0.005:.6f} rgb/{t + 0.005:.6f}.png")
        gt_lines.append(f"{t + 0.001:.6f} {0.1 * i:.4f} 0 0 0 0 0 1")
    (tmp_path / "depth.txt").write_text("\n".join(depth_lines))
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines))
    (tmp_path / "groundtruth.txt").write_text("\n".join(gt_lines))
    return tmp_path


def test_sequence_loading(tmp_path):
    root = make_tum_dir(tmp_path)
    seq = TumSequence(root)
    assert len(seq) == 5
    f = seq.frame(2)
    assert f.depth.shape == (48, 64)
    assert abs(f.depth[5, 5] - 1.04) < 1e-6
    assert np.isnan(f.depth[0, 0])  # zero depth -> NaN
    assert f.rgb is not None and f.rgb.shape == (48, 64, 3)
    assert f.gt_pose is not None
    np.testing.assert_allclose(f.gt_pose[:3, 3], [0.2, 0, 0], atol=1e-6)


def test_associate_greedy():
    a = [(1.0, ["x"]), (2.0, ["y"])]
    b = [(1.004, ["p"]), (1.9, ["q"]), (5.0, ["r"])]
    pairs = associate(a, b, max_dt=0.2)
    assert pairs == [(0, 0), (1, 1)]


def test_trajectory_roundtrip(tmp_path):
    import jax.numpy as jnp

    from perception.geometry import se3

    poses = np.asarray(se3.se3_exp(jnp.asarray(np.random.RandomState(0).randn(4, 6) * 0.3, jnp.float32)))
    ts = [1.0, 2.0, 3.0, 4.0]
    p = tmp_path / "traj.txt"
    write_trajectory(p, ts, poses)
    ts2, poses2 = read_trajectory(p)
    np.testing.assert_allclose(ts2, ts)
    np.testing.assert_allclose(poses2, poses, atol=1e-4)


def test_ate_identical_is_zero():
    poses = np.tile(np.eye(4), (10, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 1, 10)
    r = ate(poses, poses)
    assert r.rmse < 1e-9


def test_ate_alignment_removes_rigid_offset():
    rng = np.random.RandomState(0)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = rng.randn(20, 3)
    # Estimate = gt moved by a rigid transform: ATE after alignment ~ 0.
    import jax.numpy as jnp

    from perception.geometry import se3

    W = np.asarray(se3.se3_exp(jnp.asarray([0.5, -0.2, 0.1, 0.3, 0.2, -0.4], jnp.float32)), np.float64)
    est = np.einsum("ij,njk->nik", W, gt)
    r = ate(est, gt)
    assert r.rmse < 1e-5


def test_ate_detects_drift():
    gt = np.tile(np.eye(4), (30, 1, 1))
    gt[:, 0, 3] = np.linspace(0, 3, 30)
    est = gt.copy()
    est[:, 1, 3] += np.linspace(0, 0.7, 30) ** 2  # quadratic drift (max 0.49 m)
    r = ate(est, gt)
    # Rigid alignment absorbs some but not all of a nonlinear drift.
    assert 0.01 < r.rmse < 0.49


def test_rpe():
    gt = np.tile(np.eye(4), (10, 1, 1))
    gt[:, 0, 3] = np.arange(10) * 0.1
    est = gt.copy()
    est[:, 0, 3] *= 1.1  # 10% scale error -> rpe trans = 0.01/frame
    t_rmse, r_rmse = rpe(est, gt, delta=1)
    np.testing.assert_allclose(t_rmse, 0.01, atol=1e-6)
    assert r_rmse < 1e-9


def test_tum_camera_models():
    cam = tum_camera(1)
    assert abs(float(cam.fx) - 517.3) < 1e-3
    assert cam.width == 640
