"""Config #4 harness wiring from files on disk (VERDICT r2 item 8).

A rendered 30-frame sequence checked in under tests/fixtures/tum_mini
in the standard TUM layout (depth/ 16-bit PNG at 5000 counts/m, rgb/,
index + groundtruth files) drives the real CLI SLAM path end to end:
TumSequence association -> sequence_camera (calibration.txt extension)
-> run_slam -> ATE vs groundtruth.txt.
"""

import json
from pathlib import Path

import numpy as np
import pytest

FIXTURE = Path(__file__).parent / "fixtures" / "tum_mini"

pytestmark = pytest.mark.skipif(
    not (FIXTURE / "depth.txt").exists(), reason="tum_mini fixture missing"
)


def test_tum_sequence_loads_and_associates():
    from perception.io.tum import TumSequence, sequence_camera

    seq = TumSequence(FIXTURE, with_rgb=True)
    assert len(seq) == 30
    f = seq.frame(0)
    cam = sequence_camera(FIXTURE)
    assert (cam.height, cam.width) == f.depth.shape
    assert f.rgb is not None and f.rgb.shape[:2] == f.depth.shape
    assert f.gt_pose is not None
    # Depth decodes back to meters (the room is 0.1-6 m away).
    d = f.depth[np.isfinite(f.depth) & (f.depth > 0)]
    assert 0.1 < d.min() and d.max() < 8.0


@pytest.mark.slow
def test_cli_slam_on_tum_fixture_reports_bounded_ate(capsys):
    """``cli slam --tum tests/fixtures/tum_mini`` — the config #4
    harness — runs from disk and lands ATE under 5 cm."""
    from perception.cli import main

    main(["slam", "--tum", str(FIXTURE), "--cpu"])
    lines = [
        json.loads(line)
        for line in capsys.readouterr().out.splitlines()
        if line.startswith("{")
    ]
    ate_rows = [r for r in lines if r.get("metric") == "ate_rmse_m"]
    assert ate_rows, lines
    assert ate_rows[0]["frames"] == 30
    assert ate_rows[0]["value"] < 0.05, ate_rows[0]


@pytest.mark.slow  # ~58 s on the 2-core CI host (CI-budget triage, r5)
def test_cli_odometry_on_tum_fixture(capsys, tmp_path):
    """The odometry harness consumes the same fixture and writes a
    TUM-format trajectory that round-trips through the loader."""
    from perception.cli import main
    from perception.io.tum import read_file_list

    out = tmp_path / "traj.txt"
    main(["odometry", "--tum", str(FIXTURE), "--cpu", "--out", str(out)])
    lines = [
        json.loads(line)
        for line in capsys.readouterr().out.splitlines()
        if line.startswith("{")
    ]
    ate_rows = [r for r in lines if r.get("metric") == "ate_rmse_m"]
    assert ate_rows and ate_rows[0]["value"] < 0.08, ate_rows
    traj = read_file_list(out)
    assert len(traj) == 30
