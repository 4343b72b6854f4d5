"""Hand keypoint estimation: detector-from-pose + 21-landmark net.

Equivalent of OpenPose's hand module (``src/openpose/hand/``,
SURVEY.md §2.5): the hand ROI is derived from body wrist/elbow
keypoints (``HandDetector`` geometry — the box sits beyond the wrist
along the elbow->wrist direction), then a heatmap CNN regresses the 21
hand landmarks on the crop (``HandExtractorCaffe``).
"""

from __future__ import annotations

from typing import Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

from perception.models.face import decode_landmarks  # same crop decode
from perception.ops.heatmap import nms_heatmap

NUM_HAND_LANDMARKS = 21

# BODY_25 ids: RElbow 3, RWrist 4, LElbow 6, LWrist 7.
RIGHT_ARM = (3, 4)
LEFT_ARM = (6, 7)


def hand_roi_from_pose(
    keypoints: jax.Array, arm=(3, 4), extend: float = 1.2
) -> Tuple[jax.Array, jax.Array]:
    """Body keypoints (P, 3) -> (hand box (4,), valid ()).

    Box center = wrist + 0.3 * (wrist - elbow) (the hand lies beyond
    the wrist); size = extend * |elbow - wrist| (HandDetector scaling).
    """
    elbow = keypoints[arm[0], :2]
    wrist = keypoints[arm[1], :2]
    ok = (keypoints[arm[0], 2] > 0) & (keypoints[arm[1], 2] > 0)
    d = wrist - elbow
    length = jnp.linalg.norm(d)
    center = wrist + 0.3 * d
    half = jnp.maximum(extend * length * 0.5, 8.0)
    box = jnp.array([center[0] - half, center[1] - half, center[0] + half, center[1] + half])
    return box, ok & (length > 1.0)


class HandLandmarkNet(nn.Module):
    """(N, S, S, C) hand crop -> (N, S/4, S/4, 21) heatmaps."""

    width: int = 64

    @nn.compact
    def __call__(self, x):
        for w in (self.width, self.width * 2):
            x = nn.Conv(w, (3, 3), padding="SAME")(x)
            x = nn.relu(x)
            x = nn.Conv(w, (3, 3), padding="SAME")(x)
            x = nn.relu(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = nn.Conv(self.width * 2, (3, 3), padding="SAME")(x)
        x = nn.relu(x)
        return nn.Conv(NUM_HAND_LANDMARKS, (1, 1))(x)


def crop_image(image: jax.Array, box: jax.Array, out_size: int) -> jax.Array:
    """Bilinear crop of (H, W[, C]) to (out_size, out_size[, C]) from a
    float box (x1, y1, x2, y2) — the scale-pyramid crop used before the
    hand/face nets (jax.image.scale_and_translate handles the warp)."""
    H, W = image.shape[:2]
    x1, y1, x2, y2 = box[0], box[1], box[2], box[3]
    scale_x = out_size / jnp.maximum(x2 - x1, 1e-3)
    scale_y = out_size / jnp.maximum(y2 - y1, 1e-3)
    img = image if image.ndim == 3 else image[..., None]
    out = jax.image.scale_and_translate(
        img,
        (out_size, out_size, img.shape[2]),
        spatial_dims=(0, 1),
        scale=jnp.stack([scale_y, scale_x]),
        translation=jnp.stack([-y1 * scale_y, -x1 * scale_x]),
        method="bilinear",
    )
    return out if image.ndim == 3 else out[..., 0]


def extract_hand(params, image: jax.Array, box: jax.Array, crop: int = 64):
    """Crop -> landmark net -> image-space landmarks (21, 2) + mask."""
    patch = crop_image(image, box, crop)
    if patch.ndim == 2:
        patch = patch[..., None]
    hm = HandLandmarkNet().apply(params, patch[None])[0]
    return decode_landmarks(hm, box)
