"""Synthetic hand scenes + training targets for the hand fixture.

Capability proof for OpenPose's hand module (``HandExtractorCaffe``
wraps a downloaded 21-keypoint .caffemodel — ``SURVEY.md §2.5``; this
zero-egress build trains its own). Same pattern as ``pose_data.py`` /
``face_data.py``: a canonical 21-landmark hand (wrist + 4 joints per
finger), randomly placed/rotated/flexed, rendered as capsule strokes
with a distinct intensity per finger, plus crop-space Gaussian heatmap
targets for ``HandLandmarkNet``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from perception.models.hand import NUM_HAND_LANDMARKS

# Canonical 21-point hand in a unit box (x right, y down), palm down,
# fingers up: 0 wrist; 1-4 thumb; 5-8 index; 9-12 middle; 13-16 ring;
# 17-20 pinky (the OpenPose/MediaPipe ordering).
CANONICAL_HAND = np.array(
    [
        (0.50, 0.92),
        (0.38, 0.82), (0.28, 0.72), (0.21, 0.64), (0.16, 0.57),   # thumb
        (0.40, 0.60), (0.38, 0.46), (0.37, 0.35), (0.36, 0.26),   # index
        (0.50, 0.58), (0.50, 0.42), (0.50, 0.30), (0.50, 0.20),   # middle
        (0.60, 0.60), (0.62, 0.45), (0.63, 0.34), (0.64, 0.26),   # ring
        (0.69, 0.64), (0.72, 0.52), (0.74, 0.44), (0.75, 0.37),   # pinky
    ],
    np.float32,
)

FINGER_CHAINS = [
    [0, 1, 2, 3, 4],
    [0, 5, 6, 7, 8],
    [0, 9, 10, 11, 12],
    [0, 13, 14, 15, 16],
    [0, 17, 18, 19, 20],
]
# Distinct stroke intensity per finger — the synthetic analog of
# natural appearance cues, so landmarks are visually identifiable.
FINGER_LEVELS = np.array([0.95, 0.78, 0.62, 0.47, 0.33], np.float32)


class HandScene(NamedTuple):
    joints: jax.Array   # (21, 2) pixel coords
    scale: jax.Array    # () hand size in px


def sample_hand(
    key: jax.Array,
    hw: Tuple[int, int],
    scale_range: Tuple[float, float] = (0.45, 0.8),
    flex: float = 0.03,
) -> HandScene:
    H, W = hw
    k1, k2, k3, k4 = jax.random.split(key, 4)
    s = jax.random.uniform(k1, (), minval=scale_range[0], maxval=scale_range[1]) * min(H, W)
    th = jax.random.uniform(k2, (), minval=-np.pi, maxval=np.pi)
    c, sn = jnp.cos(th), jnp.sin(th)
    R = jnp.array([[c, -sn], [sn, c]])
    base = jnp.asarray(CANONICAL_HAND) - 0.5
    pts = base @ R.T * s
    span = 0.55 * s
    tx = jax.random.uniform(k3, (2,), minval=span, maxval=jnp.array([W, H]) - span)
    pts = pts + tx
    pts = pts + jax.random.normal(k4, pts.shape) * flex * s
    pts = jnp.clip(pts, 2.0, jnp.array([W - 3.0, H - 3.0]))
    return HandScene(joints=pts.astype(jnp.float32), scale=s)


def _seg_dist(px, a, b):
    ab = b - a
    denom = jnp.maximum(jnp.dot(ab, ab), 1e-8)
    t = jnp.clip(((px - a) * ab).sum(-1) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return jnp.linalg.norm(px - proj, axis=-1)


@functools.partial(jax.jit, static_argnames=("hw",))
def render_hand(scene: HandScene, hw: Tuple[int, int], key=None) -> jax.Array:
    """(H, W) grayscale in [0, 255]."""
    H, W = hw
    yy, xx = jnp.mgrid[0:H, 0:W]
    px = jnp.stack([xx, yy], -1).astype(jnp.float32)
    stroke = jnp.clip(scene.scale * 0.035, 1.2, 5.0)

    img = jnp.full((H, W), 0.1, jnp.float32)
    for chain, level in zip(FINGER_CHAINS, FINGER_LEVELS):
        d = jnp.full((H, W), 1e9)
        for i in range(len(chain) - 1):
            d = jnp.minimum(
                d, _seg_dist(px, scene.joints[chain[i]], scene.joints[chain[i + 1]])
            )
        alpha = jnp.clip(1.0 - (d - stroke) / 1.5, 0.0, 1.0)
        img = jnp.maximum(img, alpha * level)
    # Joint dots (bright) so exact joint positions are marked.
    dj = jnp.linalg.norm(px[None] - scene.joints[:, None, None, :], axis=-1)
    dots = jnp.clip(1.0 - (dj.min(0) - 1.2) / 1.0, 0.0, 1.0)
    img = jnp.maximum(img, dots)
    img = img * 255.0
    if key is not None:
        img = img + jax.random.normal(key, (H, W)) * 2.0
    return jnp.clip(img, 0.0, 255.0)


def hand_box(joints: jax.Array, margin: float = 1.3) -> jax.Array:
    lo = jnp.min(joints, axis=0)
    hi = jnp.max(joints, axis=0)
    c = 0.5 * (lo + hi)
    half = 0.5 * jnp.max(hi - lo) * margin
    return jnp.concatenate([c - half, c + half])


@functools.partial(jax.jit, static_argnames=("batch", "hw", "crop", "pixel_noise"))
def make_hand_batch(
    key: jax.Array, batch: int, hw: Tuple[int, int] = (96, 96), crop: int = 64,
    pixel_noise: float = 0.0,
) -> dict:
    """``pixel_noise`` adds per-scene Gaussian noise with a random
    level in [0, pixel_noise] (fraction of 255) — robustness
    augmentation for FIXTURES.md's held-out noise families (the r4
    fixture degraded to 10 px landmark error at noise 0.2)."""
    from perception.models.hand import crop_image

    keys = jax.random.split(key, batch)

    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        scene = sample_hand(k1, hw)
        img = render_hand(scene, hw, key=k2)
        if pixel_noise > 0.0:
            nk = jax.random.fold_in(k2, 7)
            lvl = jax.random.uniform(nk, ()) * pixel_noise
            img = jnp.clip(
                img + jax.random.normal(jax.random.fold_in(nk, 1), img.shape)
                * lvl * 255.0,
                0.0, 255.0,
            )
        box = hand_box(scene.joints)
        half = 0.5 * (box[2] - box[0])
        c = 0.5 * (box[:2] + box[2:])
        js = jax.random.uniform(k3, (3,), minval=-1.0, maxval=1.0)
        half = half * (1.0 + 0.15 * js[0])
        c = c + js[1:] * 0.10 * half
        box = jnp.concatenate([c - half, c + half])
        patch = crop_image(img, box, crop)
        sx = crop / (box[2] - box[0])
        uv_crop = (scene.joints - box[:2]) * sx

        h4 = crop // 4
        yy, xx = jnp.mgrid[0:h4, 0:h4]
        pxm = jnp.stack([xx, yy], -1).astype(jnp.float32)
        m = uv_crop / 4.0 - 0.5
        d2 = ((pxm[None] - m[:, None, None, :]) ** 2).sum(-1)
        maps = jnp.transpose(jnp.exp(-d2 / 2.0), (1, 2, 0))
        return img, patch[..., None] / 255.0, maps, uv_crop, scene

    img, patch, maps, uv_crop, scenes = jax.vmap(one)(keys)
    return {
        "image": img, "crop": patch, "heatmaps": maps,
        "uv_crop": uv_crop, "scene": scenes,
    }
