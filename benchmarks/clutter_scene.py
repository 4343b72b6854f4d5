"""Cluttered multi-object synthetic scenes + per-class templates.

The reference's object service works over 4 captured object classes
(screwdriver / eraser / clamp / marker) with hand-measured GT poses
(``object_detection/templates/transforms.txt``). Synthetic stand-ins of
the same character: four distinct rigid shapes with analytically
ray-cast depth, full-surface ICP templates, and exact GT poses written
through the same transforms.txt protocol
(``perception/io/gt_transforms.py``).

Each class is a list of primitives (box | cylinder) with local offsets,
so compound shapes (the clamp's L) are supported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

import jax.numpy as jnp

from perception.geometry import se3
from perception.geometry.camera import PinholeCamera
from perception.io.templates import (
    box_surface_template,
    cylinder_surface_template,
)

# kind, dims, local offset translation (object frame).
# dims: box -> (L, W, H); cylinder -> (radius, height).
OBJECT_CLASSES: Dict[str, List[Tuple[str, tuple, tuple]]] = {
    # long thin shaft + wider grip, lying on its side (axis = x)
    "screwdriver": [
        ("box", (0.13, 0.012, 0.012), (-0.035, 0.0, 0.0)),
        ("box", (0.07, 0.028, 0.028), (0.065, 0.0, 0.0)),
    ],
    # flat block
    "eraser": [("box", (0.06, 0.025, 0.012), (0.0, 0.0, 0.0))],
    # L-shape: two orthogonal bars. Sized so its capture point-count is
    # well separated from the other classes' — the winner gate is
    # min |cluster - template| points (object_pose_detection.cpp:415-429),
    # which aliases when two classes have near-equal counts (a fragility
    # the reference shares).
    "clamp": [
        ("box", (0.14, 0.03, 0.025), (0.0, 0.0, 0.0)),
        ("box", (0.03, 0.08, 0.025), (0.055, 0.05, 0.0)),
    ],
    # thin cylinder lying on its side (axis = z in object frame,
    # rotated flat by the scene pose)
    "marker": [("cylinder", (0.009, 0.12), (0.0, 0.0, 0.0))],
}


def class_template(name: str, density: float = 0.002) -> np.ndarray:
    """Full-surface ICP template for a class, in its object frame."""
    parts = []
    for kind, dims, off in OBJECT_CLASSES[name]:
        if kind == "box":
            pts = box_surface_template(dims, density)
        else:
            pts = cylinder_surface_template(dims[0], dims[1], density)
        parts.append(pts + np.asarray(off, np.float32))
    return np.concatenate(parts, 0).astype(np.float32)


def canonical_object_pose(name: str, table_z: float = 0.70) -> np.ndarray:
    """The capture pose: object centered on the table, no yaw (marker
    laid flat on its side, like the scene poses)."""
    if name == "marker":
        R = np.asarray(se3.so3_exp(jnp.array([0.0, np.pi / 2, 0.0])), np.float64)
    else:
        R = np.eye(3)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = (0.0, 0.0, table_z - 0.014)
    return T


def captured_template(
    name: str,
    camera: PinholeCamera,
    table_z: float = 0.70,
) -> np.ndarray:
    """Capture an ICP template the way the reference did: render the
    object alone on the table, keep the off-table points, and transform
    them into the object frame (object_detection's templates are
    sensor captures, not CAD — a partial view that matches what clusters
    look like, which is what makes the point-count winner gate
    meaningful)."""
    T0 = canonical_object_pose(name, table_z)
    depth = render_depth_clutter(camera, {name: T0}, table_z=table_z, noise=0.0)
    H, W = depth.shape
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    z = depth.astype(np.float64)
    pts = np.stack([(uu - cx) / fx * z, (vv - cy) / fy * z, z], -1).reshape(-1, 3)
    keep = pts[:, 2] < table_z - 0.004
    pts = pts[keep]
    Rinv = T0[:3, :3].T
    obj = (pts - T0[:3, 3]) @ Rinv.T
    return obj.astype(np.float32)


def _raycast_box(o, d, half):
    """Slab intersection: origin/dirs in the box frame. Returns t (inf
    when missed)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o) / d
        t2 = (half - o) / d
    tmin = np.minimum(t1, t2).max(-1)
    tmax = np.maximum(t1, t2).min(-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit, t, np.inf)


def _raycast_cylinder(o, d, radius, height):
    """z-axis cylinder with caps, frame-local origin/dirs -> t."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - radius * radius
    disc = b * b - 4 * a * c
    with np.errstate(divide="ignore", invalid="ignore"):
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_side1 = (-b - sq) / (2 * a)
        t_side2 = (-b + sq) / (2 * a)
    t_side = np.where(t_side1 > 0, t_side1, t_side2)
    z_at = oz + t_side * dz
    side_ok = (disc >= 0) & (t_side > 0) & (np.abs(z_at) <= height / 2)
    t_side = np.where(side_ok, t_side, np.inf)

    caps = np.full_like(t_side, np.inf)
    for zc in (-height / 2, height / 2):
        with np.errstate(divide="ignore", invalid="ignore"):
            t_cap = (zc - oz) / dz
        r2 = (ox + t_cap * dx) ** 2 + (oy + t_cap * dy) ** 2
        ok = (t_cap > 0) & (r2 <= radius * radius)
        caps = np.minimum(caps, np.where(ok, t_cap, np.inf))
    return np.minimum(t_side, caps)


def render_depth_clutter(
    camera: PinholeCamera,
    objects: Dict[str, np.ndarray],
    table_z: float = 0.70,
    noise: float = 0.0012,
    seed: int = 0,
) -> np.ndarray:
    """Ray-cast depth of a table + the given {class: (4, 4) pose} objects.

    Poses are camera->object (points in the object frame map to camera
    via the pose). Returns float32 (H, W) meters."""
    H, W = camera.height, camera.width
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack(
        [(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1
    )

    depth = np.full((H, W), table_z, np.float64)
    for name, T_obj in objects.items():
        T_obj = np.asarray(T_obj, np.float64)
        for kind, dims, off in OBJECT_CLASSES[name]:
            T_local = np.eye(4)
            T_local[:3, 3] = off
            T = T_obj @ T_local
            Rinv = T[:3, :3].T
            o = Rinv @ (-T[:3, 3])
            d = rays @ Rinv.T
            if kind == "box":
                t = _raycast_box(o, d, np.asarray(dims, np.float64) / 2.0)
            else:
                t = _raycast_cylinder(o, d, dims[0], dims[1])
            z = np.where(np.isfinite(t), t * rays[..., 2], np.inf)
            depth = np.minimum(depth, z)

    rng = np.random.RandomState(seed)
    depth = depth + rng.randn(H, W) * noise
    return depth.astype(np.float32)


def standard_clutter_poses(table_z: float = 0.70) -> Dict[str, np.ndarray]:
    """A repeatable 4-object tabletop arrangement: each object flat on
    the table (rotated to lie in the x-y plane of the camera at depth
    ~table_z), spread so no two surfaces come within the 2 cm cluster
    tolerance, each with its own yaw."""
    poses = {}
    placements = {
        "screwdriver": (-0.13, -0.08, 0.35),
        "eraser": (0.11, -0.08, -0.5),
        "clamp": (0.11, 0.09, 1.2),
        "marker": (-0.11, 0.10, 0.0),
    }
    for name, (x, y, yaw) in placements.items():
        # object z-extent is small; rest it just above the table
        if name == "marker":
            # cylinder axis z -> lay it flat: rotate axis into the
            # camera x-y plane, then yaw about the camera z.
            R_lay = np.asarray(
                se3.so3_exp(jnp.array([0.0, np.pi / 2, 0.0])), np.float64
            )
        else:
            R_lay = np.eye(3)
        R_yaw = np.asarray(
            se3.so3_exp(jnp.array([0.0, 0.0, yaw])), np.float64
        )
        T = np.eye(4)
        T[:3, :3] = R_yaw @ R_lay
        T[:3, 3] = (x, y, table_z - 0.014)
        poses[name] = T
    return poses
