"""TUM RGB-D dataset loading + trajectory file I/O.

The accuracy benchmarks (BASELINE.json configs #3/#4) run on TUM fr1/fr2
sequences. Format: a sequence directory with ``rgb.txt`` / ``depth.txt``
/ ``groundtruth.txt`` index files (lines: ``timestamp path...``,
'#' comments), 16-bit PNG depth at 5000 counts/meter, and ground-truth
lines ``t tx ty tz qx qy qz qw``. Association = nearest timestamps
within a tolerance (the standard associate.py algorithm).

Default intrinsics: the TUM Freiburg1/2 calibrated pinhole models.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from perception.geometry.camera import PinholeCamera, depth_from_u16

TUM_DEPTH_SCALE = 1.0 / 5000.0

# Calibrated intrinsics published by the TUM benchmark (ROS default is
# 525/319.5/239.5; fr1/fr2 are the per-Kinect calibrations).
FR1_K = (517.3, 516.5, 318.6, 255.3)
FR2_K = (520.9, 521.0, 325.1, 249.7)
FR3_K = (535.4, 539.2, 320.1, 247.6)
DEFAULT_K = (525.0, 525.0, 319.5, 239.5)


def tum_camera(freiburg: int = 1) -> PinholeCamera:
    fx, fy, cx, cy = {1: FR1_K, 2: FR2_K, 3: FR3_K}.get(freiburg, DEFAULT_K)
    return PinholeCamera.from_K([fx, 0, cx, 0, fy, cy, 0, 0, 1], width=640, height=480)


def sequence_camera(root, freiburg: int = 1) -> PinholeCamera:
    """Camera for a sequence directory: an optional ``calibration.txt``
    (one line: ``fx fy cx cy width height``) overrides the standard
    Freiburg intrinsics — the TUM format itself carries no intrinsics,
    and the in-repo mini fixture (tests/fixtures/tum_mini) is rendered
    at reduced resolution."""
    calib = Path(root) / "calibration.txt"
    if calib.exists():
        for line in calib.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fx, fy, cx, cy, w, h = (float(v) for v in line.split()[:6])
            return PinholeCamera.from_K(
                [fx, 0, cx, 0, fy, cy, 0, 0, 1], width=int(w), height=int(h)
            )
    return tum_camera(freiburg)


def read_file_list(path: Path) -> List[Tuple[float, List[str]]]:
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        out.append((float(parts[0]), parts[1:]))
    return out


def associate(
    a: List[Tuple[float, List[str]]],
    b: List[Tuple[float, List[str]]],
    max_dt: float = 0.02,
    offset: float = 0.0,
) -> List[Tuple[int, int]]:
    """Greedy closest-timestamp association (TUM associate.py semantics):
    all candidate pairs within max_dt sorted by |dt|, matched greedily
    without reuse."""
    cands = []
    for i, (ta, _) in enumerate(a):
        for j, (tb, _) in enumerate(b):
            dt = abs(ta - (tb + offset))
            if dt < max_dt:
                cands.append((dt, i, j))
    cands.sort()
    used_a, used_b, pairs = set(), set(), []
    for _, i, j in cands:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            pairs.append((i, j))
    pairs.sort()
    return pairs


@dataclasses.dataclass
class TumFrame:
    timestamp: float
    depth: np.ndarray              # (H, W) float32 meters, NaN invalid
    rgb: Optional[np.ndarray]      # (H, W, 3) uint8 or None
    gt_pose: Optional[np.ndarray]  # (4, 4) world<-camera or None


def _load_depth(path: Path) -> np.ndarray:
    import cv2

    raw = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(path)
    return depth_from_u16(raw.astype(np.uint16), TUM_DEPTH_SCALE)


def _load_rgb(path: Path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].copy()  # BGR -> RGB


def _pose_from_tum(vals: List[str]) -> np.ndarray:
    tx, ty, tz, qx, qy, qz, qw = (float(v) for v in vals[:7])
    import jax.numpy as jnp

    from perception.geometry import se3

    R = np.asarray(se3.quat_to_matrix(jnp.asarray([qx, qy, qz, qw], jnp.float32)))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = (tx, ty, tz)
    return T


class TumSequence:
    """Lazy frame iterator over a TUM sequence directory."""

    def __init__(self, root, with_rgb: bool = True, max_dt: float = 0.02):
        self.root = Path(root)
        self.depth_list = read_file_list(self.root / "depth.txt")
        self.rgb_list = (
            read_file_list(self.root / "rgb.txt")
            if with_rgb and (self.root / "rgb.txt").exists()
            else []
        )
        gt_path = self.root / "groundtruth.txt"
        self.gt_list = read_file_list(gt_path) if gt_path.exists() else []

        self.rgb_of_depth = dict(
            (i, j) for i, j in associate(self.depth_list, self.rgb_list, max_dt)
        ) if self.rgb_list else {}
        self.gt_of_depth = dict(
            (i, j) for i, j in associate(self.depth_list, self.gt_list, max_dt)
        ) if self.gt_list else {}

    def __len__(self) -> int:
        return len(self.depth_list)

    def frame(self, i: int) -> TumFrame:
        ts, (dpath,) = self.depth_list[i][0], (self.depth_list[i][1][0],)
        depth = _load_depth(self.root / dpath)
        rgb = None
        if i in self.rgb_of_depth:
            rgb = _load_rgb(self.root / self.rgb_list[self.rgb_of_depth[i]][1][0])
        gt = None
        if i in self.gt_of_depth:
            gt = _pose_from_tum(self.gt_list[self.gt_of_depth[i]][1])
        return TumFrame(timestamp=ts, depth=depth, rgb=rgb, gt_pose=gt)

    def frames(self, start: int = 0, stop: Optional[int] = None, step: int = 1) -> Iterator[TumFrame]:
        for i in range(start, stop if stop is not None else len(self), step):
            yield self.frame(i)


def write_trajectory(path, timestamps, poses) -> None:
    """Write a TUM-format trajectory (t tx ty tz qx qy qz qw)."""
    import jax.numpy as jnp

    from perception.geometry import se3

    with open(path, "w") as f:
        for t, T in zip(timestamps, poses):
            T = np.asarray(T)
            q = np.asarray(se3.matrix_to_quat(jnp.asarray(T[:3, :3])))
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def read_trajectory(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM-format trajectory -> (timestamps (N,), poses (N, 4, 4))."""
    ts, poses = [], []
    for t, vals in read_file_list(Path(path)):
        ts.append(t)
        poses.append(_pose_from_tum(vals))
    return np.asarray(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))
