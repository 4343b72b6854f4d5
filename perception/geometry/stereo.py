"""Stereo camera model: disparity <-> depth, Q-matrix reprojection.

Parity with ``vision_opencv/image_geometry``'s ``StereoCameraModel``
(``stereo_camera_model.cpp``): the rectified-pair model defined by the
left pinhole intrinsics + baseline, its 4x4 reprojection matrix Q
(``:53``), per-pixel ``projectDisparityTo3d`` (``:115``) and the dense
``projectDisparityImageTo3d`` with the ``MISSING_Z = 10000`` sentinel
for non-positive disparities (``:130-132``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from perception.geometry.camera import PinholeCamera

MISSING_Z = 10000.0


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class StereoCamera:
    left: PinholeCamera
    baseline: jax.Array  # meters (Tx = -fx * baseline in the right P)

    def tree_flatten(self):
        return (self.left, self.baseline), ()

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @property
    def Q(self) -> jax.Array:
        """Disparity-to-depth reprojection matrix (OpenCV convention):
        [X Y Z W]^T = Q [u v d 1]^T."""
        fx = self.left.fx
        cx = self.left.cx
        cy = self.left.cy
        z = jnp.zeros_like(fx)
        o = jnp.ones_like(fx)
        invb = 1.0 / self.baseline
        return jnp.stack(
            [
                jnp.stack([o, z, z, -cx]),
                jnp.stack([z, o, z, -cy]),
                jnp.stack([z, z, z, fx]),
                jnp.stack([z, z, invb, z]),
            ]
        )

    def disparity_to_depth(self, disparity: jax.Array) -> jax.Array:
        """Z = fx * baseline / d; non-positive d -> MISSING_Z."""
        ok = disparity > 0
        z = self.left.fx * self.baseline / jnp.where(ok, disparity, 1.0)
        return jnp.where(ok, z, MISSING_Z)

    def project_disparity_to_3d(self, uv: jax.Array, disparity: jax.Array) -> jax.Array:
        """(..., 2) pixels + (...) disparity -> (..., 3) points
        (projectDisparityTo3d semantics)."""
        hom = jnp.stack(
            [uv[..., 0], uv[..., 1], disparity, jnp.ones_like(disparity)], axis=-1
        )
        XYZW = hom @ self.Q.T
        W = XYZW[..., 3:]
        pts = XYZW[..., :3] / jnp.where(jnp.abs(W) > 1e-12, W, 1e-12)
        ok = disparity[..., None] > 0
        return jnp.where(ok, pts, jnp.array([0.0, 0.0, MISSING_Z]))

    def disparity_image_to_3d(self, disparity: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """(H, W) disparity -> ((H, W, 3) points, (H, W) valid mask)."""
        H, W = disparity.shape
        vv, uu = jnp.meshgrid(
            jnp.arange(H, dtype=disparity.dtype), jnp.arange(W, dtype=disparity.dtype),
            indexing="ij",
        )
        pts = self.project_disparity_to_3d(jnp.stack([uu, vv], axis=-1), disparity)
        return pts, disparity > 0

    def depth_to_disparity(self, depth: jax.Array) -> jax.Array:
        return self.left.fx * self.baseline / jnp.maximum(depth, 1e-9)
