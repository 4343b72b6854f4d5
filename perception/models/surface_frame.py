"""Cuboid-frame estimation from orthogonal face fits.

Equivalent of the reference's surface-normal node
(``cuboid_detection/src/surface_normal_estimation.cpp``): given the
segmented off-plane (box) cloud and the ground-plane normal, RANSAC
three orthogonal faces — one perpendicular to the ground normal (the
top face, ``SACMODEL_PERPENDICULAR_PLANE``) and two parallel to it (the
sides, ``SACMODEL_PARALLEL_PLANE``), removing inliers between fits
(``getNormal`` loop ``:105-165``, ``:182-194``) — then:

  * sort the planes by inlier count (``:196-210``);
  * orthonormalize and enforce a right-handed frame via the triple
    product (``:212-215``);
  * use the cloud centroid as the frame origin (``:217-219``);
  * assemble the 4x4 pose (``:221-225``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from perception.geometry import f32, se3
from perception.ops import points as P
from perception.ops.ransac import ransac_plane


class SurfaceFrame(NamedTuple):
    pose: jax.Array          # (4, 4) camera -> estimated_cuboid_frame
    face_normals: jax.Array  # (3, 4) plane coefficients, inlier-count order
    inlier_counts: jax.Array # (3,) int32
    valid: jax.Array         # () bool — all three fits usable


def estimate_surface_frame(
    points: jax.Array,
    mask: jax.Array,
    ground_normal: jax.Array,
    key: jax.Array,
    threshold: float = 0.008,
    eps_angle: float = 0.1,
    num_hypotheses: int = 512,
) -> SurfaceFrame:
    k1, k2, k3 = jax.random.split(key, 3)

    # Face 1: perpendicular to the ground normal (normal ~ ground normal).
    fit1 = ransac_plane(
        points, mask, k1, threshold=threshold, num_hypotheses=num_hypotheses,
        model="perpendicular", axis=ground_normal, eps_angle=eps_angle,
    )
    m = mask & ~fit1.inliers
    # Faces 2, 3: parallel to the ground normal (side faces), sequential
    # inlier removal like the reference's loop.
    fit2 = ransac_plane(
        points, m, k2, threshold=threshold, num_hypotheses=num_hypotheses,
        model="parallel", axis=ground_normal, eps_angle=eps_angle,
    )
    m = m & ~fit2.inliers
    fit3 = ransac_plane(
        points, m, k3, threshold=threshold, num_hypotheses=num_hypotheses,
        model="parallel", axis=ground_normal, eps_angle=eps_angle,
    )

    coeffs = jnp.stack([fit1.coefficients, fit2.coefficients, fit3.coefficients])
    counts = jnp.stack([fit1.num_inliers, fit2.num_inliers, fit3.num_inliers])

    # Sort faces by inlier count, descending (surface_normal_estimation.cpp:196-210).
    order = jnp.argsort(-counts)
    coeffs = coeffs[order]
    counts = counts[order]

    n0 = coeffs[0, :3]
    n1 = coeffs[1, :3]
    # Gram-Schmidt: x = n0, y = n1 orthogonalized, z = x cross y; the
    # triple product sign is enforced by construction (right-handed).
    x = n0 / jnp.maximum(jnp.linalg.norm(n0), 1e-12)
    y = n1 - f32.dot(n1, x) * x
    y = y / jnp.maximum(jnp.linalg.norm(y), 1e-12)
    z = jnp.cross(x, y)
    R = jnp.stack([x, y, z], axis=1)  # columns are the frame axes

    origin = P.centroid(points, mask)
    pose = se3.make_T(R, origin)
    valid = fit1.valid & fit2.valid & fit3.valid
    return SurfaceFrame(pose=pose, face_normals=coeffs, inlier_counts=counts, valid=valid)
