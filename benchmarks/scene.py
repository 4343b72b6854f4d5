"""Synthetic D435 benchmark scenes (no bags ship with the reference —
``cuboid_detection/bags/.gitignore`` — so frames are generated at the
documented camera geometry, README.md:39-80)."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from perception.geometry import se3
from perception.geometry.camera import PinholeCamera
from perception.io.templates import cuboid_template


def render_depth_tabletop(
    camera: PinholeCamera,
    cuboid_pose_twist=(0.05, 0.03, 0.80, 0.0, 0.0, 0.35),
    dims=(0.2, 0.1, 0.03),
    table_z: float = 0.85,
    noise: float = 0.0015,
    seed: int = 0,
) -> np.ndarray:
    """Ray-cast a depth image of a table plane + one cuboid.

    Simple two-surface z-buffer: the table plane z = table_z and the
    cuboid's axis-aligned-in-object-frame box, both intersected per
    pixel ray; plus depth noise. Returns float32 (H, W) meters.
    """
    H, W = camera.height, camera.width
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1)

    depth = np.full((H, W), table_z, np.float64)  # table plane (z = const)

    # Cuboid: intersect rays with the oriented box via slab method in
    # the object frame.
    T = np.asarray(se3.se3_exp(jnp.asarray(cuboid_pose_twist, jnp.float32)), np.float64)
    Rinv = T[:3, :3].T
    tinv = -Rinv @ T[:3, 3]
    o = tinv  # camera origin in object frame
    d = rays @ Rinv.T  # ray dirs in object frame
    half = np.asarray(dims, np.float64) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o) / d
        t2 = (half - o) / d
    tmin = np.minimum(t1, t2).max(-1)
    tmax = np.maximum(t1, t2).min(-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t_hit = np.where(tmin > 0, tmin, tmax)
    z_box = np.where(hit, t_hit * rays[..., 2], np.inf)
    depth = np.minimum(depth, z_box)

    rng = np.random.RandomState(seed)
    depth = depth + rng.randn(H, W) * noise
    return depth.astype(np.float32)


def benchmark_template(dims=(0.2, 0.1, 0.03), density=0.004):
    return cuboid_template(*dims, density=density)
