import numpy as np

from perception.io.bvh import save_bvh
from perception.io.camera_params import load_camera_rig, save_camera_rig
from perception.models.pose import BODY_25_PAIRS, BODY_25_PARTS


def test_camera_rig_roundtrip(tmp_path):
    K = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])
    E = np.eye(4)
    E[0, 3] = 0.1
    p = tmp_path / "rig.json"
    save_camera_rig(p, {
        "cam0": {"K": K, "extrinsics": np.eye(4), "width": 640, "height": 480},
        "cam1": {"K": K, "extrinsics": E, "width": 640, "height": 480},
    })
    rig = load_camera_rig(p)
    assert set(rig) == {"cam0", "cam1"}
    np.testing.assert_allclose(float(rig["cam0"]["camera"].fx), 600.0)
    np.testing.assert_allclose(rig["cam1"]["extrinsics"], E)
    # P = K [R|t]
    np.testing.assert_allclose(rig["cam1"]["P"], (K @ E[:3, :4]), atol=1e-5)


def test_bvh_writer(tmp_path):
    rng = np.random.RandomState(0)
    base = rng.rand(25, 3)
    frames = [base + 0.01 * t for t in range(5)]
    p = tmp_path / "motion.bvh"
    save_bvh(p, frames, BODY_25_PAIRS, BODY_25_PARTS, fps=30.0)
    text = p.read_text()
    assert text.startswith("HIERARCHY")
    assert "ROOT MidHip" in text
    assert "MOTION" in text and "Frames: 5" in text
    # Motion lines: root has 6 channels, every other joint 3.
    motion = text.split("Frame Time:")[1].strip().splitlines()[1].split()
    n_joints = text.count("JOINT") + 1
    assert len(motion) == 3 + 3 * n_joints
