"""transforms.txt GT protocol: write/read round-trip and parsing of the
reference's exact formatting (object_detection/templates/transforms.txt)."""

import numpy as np

from perception.geometry import se3
from perception.io.gt_transforms import load_gt_transforms, save_gt_transforms


def _random_pose(seed):
    rng = np.random.default_rng(seed)
    import jax.numpy as jnp

    R = np.asarray(se3.so3_exp(jnp.asarray(rng.normal(size=3) * 0.5)))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3) * 0.4
    return T


def test_roundtrip(tmp_path):
    poses = {name: _random_pose(i) for i, name in enumerate(
        ["eraser", "clamp", "screwdriver", "marker"])}
    path = tmp_path / "transforms.txt"
    save_gt_transforms(path, poses)
    back = load_gt_transforms(path)
    assert set(back) == set(poses)
    for name in poses:
        np.testing.assert_allclose(back[name], poses[name], atol=1e-6)


def test_parses_reference_formatting(tmp_path):
    # The reference file's exact indentation/ordering (rotation after
    # translation, seq/stamp noise, quotes on frame ids).
    text = """############# eraser #############
transforms:
  -
    header:
      seq: 0
      stamp:
        secs: 1556767535
        nsecs: 764839887
      frame_id: "/camera_depth_optical_frame"
    child_frame_id: "/cuboid_frame"
    transform:
      translation:
        x: 0.1296
        y: -0.472
        z: -0.3316
      rotation:
        x: -0.348770910586
        y: -0.134146176401
        z: -0.0488837796102
        w: 0.926268876395
"""
    path = tmp_path / "ref_style.txt"
    path.write_text(text)
    poses = load_gt_transforms(path)
    assert list(poses) == ["eraser"]
    T = poses["eraser"]
    np.testing.assert_allclose(T[:3, 3], [0.1296, -0.472, -0.3316], atol=1e-9)
    # Rotation is orthonormal and matches the quaternion.
    R = T[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    q = np.asarray(se3.matrix_to_quat(R))
    expect = np.array([0.926268876395, -0.348770910586, -0.134146176401,
                       -0.0488837796102])
    sign = np.sign(q[0]) * np.sign(expect[0])
    np.testing.assert_allclose(q, expect * sign, atol=1e-6)
