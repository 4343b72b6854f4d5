"""Pinhole camera model + depth backprojection, pure jnp.

Replacement for the reference's ``image_geometry`` camera
models (``vision_opencv/image_geometry/src/pinhole_camera_model.cpp`` /
``src/image_geometry/cameramodels.py``) and the organized-cloud
generation the reference gets for free from the RealSense ROS driver.
API parity (same math, jnp arrays):

  * ``project(points)``        ~ ``project3dToPixel``    (pinhole_camera_model.cpp:268)
  * ``pixel_to_ray(uv)``       ~ ``projectPixelTo3dRay`` (pinhole_camera_model.cpp:282)
  * ``rectify_point``/``unrectify_point`` (:331, :349) — plumb_bob model
  * ``backproject_depth``      — depth image -> fixed-capacity point cloud
    + validity mask (the fixed-shape idiom replacing PCL organized clouds).

Invariant (tested like ``image_geometry/test/utest.cpp:47-258`` and
``test/directed.py:15-26``): project(pixel_to_ray(uv) * z) == uv.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    """Full-resolution sensor description (sensor_msgs/CameraInfo): the
    calibrated intrinsics plus the capture-time binning/ROI state.
    ``PinholeCamera.from_camera_info`` converts this to the operational
    model (pinhole_camera_model.cpp:84-194)."""

    K: tuple                      # 9 floats, row-major, FULL resolution
    width: int
    height: int
    D: tuple | None = None        # plumb_bob (5) / rational (8) or None
    binning_x: int = 1
    binning_y: int = 1
    roi: Tuple[int, int, int, int] = (0, 0, 0, 0)  # x_off, y_off, w, h
                                                   # (0,0,0,0) = full


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Intrinsics container. fx/fy/cx/cy are traced leaves; width/height
    (static shape info) are aux data. Distortion is plumb_bob (k1 k2 t1 t2 k3);
    the reference D435 publishes all-zero distortion (README.md:39-80)."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    dist: jax.Array  # (5,) plumb_bob [k1, k2, p1, p2, k3]
    width: int = 640
    height: int = 480

    # -- pytree plumbing ---------------------------------------------------
    def tree_flatten(self):
        return (self.fx, self.fy, self.cx, self.cy, self.dist), (self.width, self.height)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        fx, fy, cx, cy, dist = leaves
        width, height = aux
        return cls(fx=fx, fy=fy, cx=cx, cy=cy, dist=dist, width=width, height=height)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_K(cls, K, width: int = 640, height: int = 480, dist=None) -> "PinholeCamera":
        """From a 3x3 (or flat 9) intrinsic matrix, as published on
        ``/camera/*/camera_info`` (reference README.md:39-80)."""
        K = jnp.asarray(K, dtype=jnp.float32).reshape(3, 3)
        if dist is None:
            d = jnp.zeros(5, jnp.float32)
        else:
            d = jnp.asarray(dist, jnp.float32).reshape(-1)
            if d.shape[0] not in (5, 8):
                raise ValueError("dist must be plumb_bob (5) or rational_polynomial (8)")
        return cls(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], dist=d, width=width, height=height)

    @classmethod
    def from_camera_info(cls, info: "CameraInfo") -> "PinholeCamera":
        """Build the OPERATIONAL model from a full-resolution CameraInfo
        with binning and ROI, mirroring ``fromCameraInfo``
        (pinhole_camera_model.cpp:84-194):

          * the ROI offsets shift the principal point (the model works
            in ROI-local pixels);
          * binning divides the focal lengths, principal point, and
            image size (binning_x scales u, binning_y scales v);
          * the resulting width/height describe the delivered
            (ROI-cropped, binned) image.
        """
        bx = max(info.binning_x, 1)
        by = max(info.binning_y, 1)
        rx, ry, rw, rh = info.roi
        if rw == 0 and rh == 0:          # empty ROI = full resolution
            rw, rh = info.width, info.height
        if rx + rw > info.width or ry + rh > info.height:
            raise ValueError(f"ROI {info.roi} exceeds {info.width}x{info.height}")
        K = np.asarray(info.K, np.float64).reshape(3, 3)
        fx = (K[0, 0]) / bx
        fy = (K[1, 1]) / by
        cx = (K[0, 2] - rx) / bx
        cy = (K[1, 2] - ry) / by
        return cls(
            fx=jnp.float32(fx), fy=jnp.float32(fy),
            cx=jnp.float32(cx), cy=jnp.float32(cy),
            dist=jnp.asarray(info.D, jnp.float32)
            if info.D is not None else jnp.zeros(5, jnp.float32),
            width=rw // bx, height=rh // by,
        )

    @classmethod
    def d435_color(cls) -> "PinholeCamera":
        return cls.from_K([616.8246459960938, 0.0, 321.81976318359375,
                           0.0, 616.609375, 239.91116333007812,
                           0.0, 0.0, 1.0])

    @classmethod
    def d435_depth(cls) -> "PinholeCamera":
        return cls.from_K([384.0898742675781, 0.0, 322.4656677246094,
                           0.0, 384.0898742675781, 240.64073181152344,
                           0.0, 0.0, 1.0])

    @property
    def K(self) -> jax.Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx]),
                jnp.stack([z, self.fy, self.cy]),
                jnp.stack([z, z, o]),
            ]
        )

    # -- projection --------------------------------------------------------
    def project(self, points: jax.Array) -> jax.Array:
        """(..., 3) camera-frame points -> (..., 2) pixels (u, v).

        Mirrors project3dToPixel. z == 0 yields NaN and z < 0 yields
        mirrored (finite but meaningless) coordinates — callers must
        mask on z > 0. No distortion applied (rectified/zero-D case)."""
        z = points[..., 2]
        u = self.fx * points[..., 0] / z + self.cx
        v = self.fy * points[..., 1] / z + self.cy
        return jnp.stack([u, v], axis=-1)

    def pixel_to_ray(self, uv: jax.Array, normalize: bool = False) -> jax.Array:
        """(..., 2) pixels -> (..., 3) rays with z=1 (projectPixelTo3dRay).

        The C++ model returns the z=1 ray; ``normalize=True`` gives the
        unit-norm variant (Python cameramodels.py behavior)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        ray = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
        if normalize:
            ray = ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)
        return ray

    # -- distortion (plumb_bob / rational_polynomial) -----------------------
    # The reference camera model accepts exactly these two
    # (pinhole_camera_model.cpp:134-135). The model is selected by the
    # static length of ``dist``: (5,) = plumb_bob [k1 k2 p1 p2 k3],
    # (8,) = rational_polynomial [k1 k2 p1 p2 k3 k4 k5 k6] with
    # radial = (1 + k1 r2 + k2 r4 + k3 r6) / (1 + k4 r2 + k5 r4 + k6 r6).

    def _radial(self, r2: jax.Array) -> jax.Array:
        d = self.dist
        k1, k2, k3 = d[0], d[1], d[4]
        num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        if d.shape[0] == 8:
            k4, k5, k6 = d[5], d[6], d[7]
            return num / (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6)))
        return num

    def unrectify_point(self, uv: jax.Array) -> jax.Array:
        """Apply distortion: ideal pixel -> raw pixel
        (pinhole_camera_model.cpp:349 semantics, R = I, P = K case)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        p1, p2 = self.dist[2], self.dist[3]
        r2 = x * x + y * y
        radial = self._radial(r2)
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return jnp.stack([self.fx * xd + self.cx, self.fy * yd + self.cy], axis=-1)

    def rectify_point(self, uv: jax.Array, iters: int = 5) -> jax.Array:
        """Invert the distortion by fixed-point iteration (the same
        scheme cv::undistortPoints uses; 5 iterations like OpenCV)."""
        x0 = (uv[..., 0] - self.cx) / self.fx
        y0 = (uv[..., 1] - self.cy) / self.fy
        p1, p2 = self.dist[2], self.dist[3]

        def body(_, xy):
            x, y = xy
            r2 = x * x + y * y
            radial = self._radial(r2)
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            return ((x0 - dx) / radial, (y0 - dy) / radial)

        x, y = jax.lax.fori_loop(0, iters, body, (x0, y0))
        return jnp.stack([self.fx * x + self.cx, self.fy * y + self.cy], axis=-1)

    def rectify_image(self, image: jax.Array) -> jax.Array:
        """Dense undistortion remap (rectifyImage / initRectificationMaps,
        pinhole_camera_model.cpp:293,413 — R = I, P = K case).

        For every rectified output pixel, find its distorted source
        coordinate (forward distortion = ``unrectify_point``) and
        bilinearly sample the raw image. Pure jnp — one fused gather
        instead of OpenCV's precomputed CV_16SC2 maps. Accepts
        (H, W) or (H, W, C) float/uint8; returns float32."""
        img = jnp.asarray(image, jnp.float32)
        squeeze = img.ndim == 2
        if squeeze:
            img = img[..., None]
        h, w = img.shape[:2]
        vv, uu = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                              jnp.arange(w, dtype=jnp.float32), indexing="ij")
        src = self.unrectify_point(jnp.stack([uu, vv], axis=-1))
        x, y = src[..., 0], src[..., 1]
        x0 = jnp.clip(jnp.floor(x), 0, w - 2).astype(jnp.int32)
        y0 = jnp.clip(jnp.floor(y), 0, h - 2).astype(jnp.int32)
        fx = jnp.clip(x - x0, 0.0, 1.0)[..., None]
        fy = jnp.clip(y - y0, 0.0, 1.0)[..., None]
        g = lambda yi, xi: img[yi, xi]
        top = g(y0, x0) * (1 - fx) + g(y0, x0 + 1) * fx
        bot = g(y0 + 1, x0) * (1 - fx) + g(y0 + 1, x0 + 1) * fx
        out = top * (1 - fy) + bot * fy
        inb = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1))[..., None]
        out = jnp.where(inb, out, 0.0)
        return out[..., 0] if squeeze else out

    def rectify_roi(self, roi) -> Tuple[int, int, int, int]:
        """Raw-image ROI -> the tightest ROI in the rectified image
        containing it (pinhole_camera_model.cpp:371-412 semantics:
        rectify the ROI's border and take the bounding rectangle).

        Samples the four edges (the distortion is monotone enough along
        edges that corners alone under-cover barrel distortion, exactly
        why the reference walks the border)."""
        x, y, w, h = roi
        n = 16
        ts = jnp.linspace(0.0, 1.0, n)
        top = jnp.stack([x + ts * w, jnp.full((n,), float(y))], axis=-1)
        bot = jnp.stack([x + ts * w, jnp.full((n,), float(y + h))], axis=-1)
        left = jnp.stack([jnp.full((n,), float(x)), y + ts * h], axis=-1)
        right = jnp.stack([jnp.full((n,), float(x + w)), y + ts * h], axis=-1)
        border = jnp.concatenate([top, bot, left, right], axis=0)
        rect = self.rectify_point(border)
        x0 = int(jnp.floor(jnp.min(rect[:, 0])))
        y0 = int(jnp.floor(jnp.min(rect[:, 1])))
        x1 = int(jnp.ceil(jnp.max(rect[:, 0])))
        y1 = int(jnp.ceil(jnp.max(rect[:, 1])))
        return (x0, y0, x1 - x0, y1 - y0)

    def unrectify_roi(self, roi) -> Tuple[int, int, int, int]:
        """Rectified-image ROI -> bounding raw-image ROI (the inverse
        walk, using the forward distortion)."""
        x, y, w, h = roi
        n = 16
        ts = jnp.linspace(0.0, 1.0, n)
        top = jnp.stack([x + ts * w, jnp.full((n,), float(y))], axis=-1)
        bot = jnp.stack([x + ts * w, jnp.full((n,), float(y + h))], axis=-1)
        left = jnp.stack([jnp.full((n,), float(x)), y + ts * h], axis=-1)
        right = jnp.stack([jnp.full((n,), float(x + w)), y + ts * h], axis=-1)
        border = jnp.concatenate([top, bot, left, right], axis=0)
        raw = self.unrectify_point(border)
        x0 = int(jnp.floor(jnp.min(raw[:, 0])))
        y0 = int(jnp.floor(jnp.min(raw[:, 1])))
        x1 = int(jnp.ceil(jnp.max(raw[:, 0])))
        y1 = int(jnp.ceil(jnp.max(raw[:, 1])))
        return (x0, y0, x1 - x0, y1 - y0)

    # -- depth backprojection ---------------------------------------------
    def backproject_depth(
        self,
        depth: jax.Array,
        min_depth: float = 0.05,
        max_depth: float = 10.0,
    ) -> Tuple[jax.Array, jax.Array]:
        """Depth image (H, W) meters -> (H*W, 3) points + (H*W,) bool mask.

        Fixed capacity H*W with invalid pixels masked — the fixed-shape
        replacement for the organized PointCloud2 the reference consumes
        on ``/camera/depth/color/points``. Invalid points are parked at
        the origin so downstream masked reductions stay NaN-free."""
        h, w = depth.shape
        vv, uu = jnp.meshgrid(jnp.arange(h, dtype=depth.dtype), jnp.arange(w, dtype=depth.dtype), indexing="ij")
        z = depth.reshape(-1)
        u = uu.reshape(-1)
        v = vv.reshape(-1)
        valid = jnp.isfinite(z) & (z > min_depth) & (z < max_depth)
        z = jnp.where(valid, z, 0.0)
        x = (u - self.cx) / self.fx * z
        y = (v - self.cy) / self.fy * z
        return jnp.stack([x, y, z], axis=-1), valid


def depth_from_u16(depth_u16: np.ndarray, scale: float = 1.0 / 5000.0) -> np.ndarray:
    """TUM-convention uint16 PNG depth -> float32 meters (0 = invalid).

    TUM RGB-D uses 5000 counts/meter; RealSense bags use 1000 (mm)."""
    d = depth_u16.astype(np.float32) * scale
    d[depth_u16 == 0] = np.nan
    return d
