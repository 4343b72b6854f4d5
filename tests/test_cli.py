import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_synthetic_depth(tmp_path):
    import cv2

    sys.path.insert(0, REPO)
    from benchmarks.scene import render_depth_tabletop
    from perception.geometry.camera import PinholeCamera

    cam = PinholeCamera.d435_depth()
    depth = render_depth_tabletop(cam, noise=0.001)
    mm = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
    p = tmp_path / "depth.png"
    cv2.imwrite(str(p), mm)
    return p


@pytest.mark.slow
def test_cli_cuboid_end_to_end(tmp_path):
    depth_png = write_synthetic_depth(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "perception.cli", "cuboid",
         "--depth", str(depth_png), "--depth-scale", "0.001"],
        capture_output=True, text=True, timeout=900,
        cwd=REPO,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin",
             "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["accepted"] is True
    assert out["fitness"] < 4e-4
    # Pose translation ~ the rendered cuboid position (0.05, 0.03, 0.80).
    t = np.asarray(out["pose"])[:3, 3]
    assert np.linalg.norm(t - [0.05, 0.03, 0.80]) < 0.05


def test_cli_help():
    proc = subprocess.run(
        [sys.executable, "-m", "perception.cli", "--help"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0
    for cmd in ("cuboid", "objects", "odometry", "slam", "pose", "bench"):
        assert cmd in proc.stdout


@pytest.mark.slow
def test_cli_pose_trained_fixture(tmp_path):
    from perception.models.pose_fixture import fixture_available

    if not fixture_available():
        pytest.skip("pose fixture not trained")
    out_json = tmp_path / "people.json"
    proc = subprocess.run(
        [sys.executable, "-m", "perception.cli", "pose", "--cpu",
         "--seed", "3", "--out-json", str(out_json)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["people"] >= 1
    doc = json.loads(out_json.read_text())
    assert len(doc["people"]) == out["people"]
