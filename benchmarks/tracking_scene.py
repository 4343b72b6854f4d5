"""Multi-cuboid bag-replay scenes for the streaming tracker (config #2).

Renders a table with K cuboids of distinct dimensions under a moving
camera — the synthetic stand-in for the reference's recorded D435 bags
(`cuboid_detection/launch/play_rosbag.launch:12`; the bags themselves
are git-ignored upstream). World-frame object poses are constant; the
camera trajectory sweeps, so every per-frame camera-frame pose is the
exact GT the tracker is scored against.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

import jax.numpy as jnp

from perception.geometry import se3
from benchmarks.clutter_scene import _raycast_box

# (dims, world pose twist) per tracked cuboid: distinct sizes so the
# scene exercises per-slot templates.
# Spacing rule: inter-object gaps must exceed the sum of the two
# corner half-extents plus the 2 cm cluster tolerance, or Euclidean
# clustering (correctly) merges them into one blob. Entries are
# (dims, (x, y, z, yaw)) with the translation applied literally (NOT a
# twist — se3_exp's V-matrix would couple yaw into the position).
CUBOID_SET: List[Tuple[Tuple[float, float, float], Tuple[float, ...]]] = [
    ((0.20, 0.10, 0.03), (-0.16, 0.04, 0.80, 0.30)),
    ((0.12, 0.08, 0.05), (0.17, 0.00, 0.82, -0.60)),
    ((0.09, 0.06, 0.04), (0.00, -0.17, 0.78, 1.10)),
]


def camera_trajectory(n: int, amp: float = 0.08, yaw_amp: float = 0.06):
    """Smooth world<-camera sweep (small orbit around the table)."""
    Ts = []
    for k in range(n):
        ph = 2.0 * np.pi * k / max(n - 1, 1)
        tw = jnp.asarray(
            [amp * np.sin(ph), 0.5 * amp * np.sin(2 * ph), 0.02 * np.sin(ph),
             0.0, yaw_amp * np.sin(ph), 0.02 * np.cos(ph)],
            jnp.float32,
        )
        Ts.append(np.asarray(se3.se3_exp(tw), np.float64))
    return Ts


def object_world_poses(cuboids=CUBOID_SET):
    poses = []
    for _, (x, y, z, yaw) in cuboids:
        T = np.eye(4)
        T[:3, :3] = np.asarray(se3.so3_exp(jnp.asarray([0.0, 0.0, yaw])), np.float64)
        T[:3, 3] = (x, y, z)
        poses.append(T)
    return poses


def render_depth_cuboids(
    camera,
    T_wc: np.ndarray,
    cuboids=CUBOID_SET,
    table_z: float = 0.85,
    noise: float = 0.0015,
    seed: int = 0,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(depth (H, W), [camera-frame GT pose per cuboid])."""
    H, W = camera.height, camera.width
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack(
        [(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1
    )

    T_cw = np.linalg.inv(np.asarray(T_wc, np.float64))
    # Table plane z_world = table_z rendered in the camera frame.
    n_w = np.array([0.0, 0.0, 1.0])
    n_c = T_cw[:3, :3] @ n_w
    d0 = table_z - n_w @ T_wc[:3, 3]
    denom = rays @ n_c
    with np.errstate(divide="ignore", invalid="ignore"):
        t = d0 / denom
    depth = np.where((t > 0.05) & (denom != 0), t * rays[..., 2], np.inf)

    gt_poses = []
    for (dims, _), T_wo in zip(cuboids, object_world_poses(cuboids)):
        T_co = T_cw @ T_wo
        gt_poses.append(T_co)
        Rinv = T_co[:3, :3].T
        o = Rinv @ (-T_co[:3, 3])
        d = rays @ Rinv.T
        t = _raycast_box(o, d, np.asarray(dims, np.float64) / 2.0)
        z = np.where(np.isfinite(t), t * rays[..., 2], np.inf)
        depth = np.minimum(depth, z)

    depth[~np.isfinite(depth)] = 0.0
    rng = np.random.RandomState(seed)
    depth = depth + rng.randn(H, W) * noise
    return depth.astype(np.float32), gt_poses
