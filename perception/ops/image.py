"""2-D image ops: color space, thresholding, morphology, component bbox.

Equivalents of the OpenCV calls in the reference's color
object detector (``cuboid_detection/scripts/object_detection.py:25-76``):
``cvtColor(BGR2HSV)``, ``inRange``, 5x5 ``erode``/``dilate``,
``findContours`` + ``contourArea`` + ``boundingRect``. Everything is
fused-friendly jnp; morphology is ``lax.reduce_window`` (XLA's native
sliding-window primitive) and the contour step is reformulated as
connected-components labeling (min-label propagation with pointer
jumping) + a masked bbox reduction — no pointer-chasing.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


def rgb_to_hsv_cv(rgb: jax.Array) -> jax.Array:
    """RGB uint8/float (H, W, 3) -> OpenCV-convention HSV:
    H in [0, 180), S in [0, 255], V in [0, 255] (all float32)."""
    rgb = rgb.astype(jnp.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    c = v - mn
    safe_c = jnp.where(c == 0, 1.0, c)
    h = jnp.where(
        v == r, (g - b) / safe_c,
        jnp.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c),
    )
    h = jnp.where(c == 0, 0.0, h) * 30.0  # 60 deg / 2 (OpenCV H range)
    h = jnp.where(h < 0, h + 180.0, h)
    s = jnp.where(v == 0, 0.0, c / jnp.where(v == 0, 1.0, v)) * 255.0
    return jnp.stack([h, s, v], axis=-1)


def in_range(img: jax.Array, lo, hi) -> jax.Array:
    """cv2.inRange: bool mask of pixels with lo <= px <= hi per channel."""
    lo = jnp.asarray(lo, img.dtype)
    hi = jnp.asarray(hi, img.dtype)
    return jnp.all((img >= lo) & (img <= hi), axis=-1)


def _morph(mask: jax.Array, size: int, op: str) -> jax.Array:
    x = mask.astype(jnp.float32)
    pad = size // 2
    if op == "erode":
        init, fn = jnp.inf, jax.lax.min
        x = jnp.pad(x, pad, constant_values=1.0)  # border replicate-ish
    else:
        init, fn = -jnp.inf, jax.lax.max
        x = jnp.pad(x, pad, constant_values=0.0)
    out = jax.lax.reduce_window(
        x, init, fn, window_dimensions=(size, size), window_strides=(1, 1),
        padding="VALID",
    )
    return out > 0.5


def erode(mask: jax.Array, size: int = 5, iterations: int = 1) -> jax.Array:
    for _ in range(iterations):
        mask = _morph(mask, size, "erode")
    return mask


def dilate(mask: jax.Array, size: int = 5, iterations: int = 1) -> jax.Array:
    for _ in range(iterations):
        mask = _morph(mask, size, "dilate")
    return mask


class ComponentBBox(NamedTuple):
    x1: jax.Array
    y1: jax.Array
    x2: jax.Array  # exclusive-ish: max column of the component
    y2: jax.Array
    area: jax.Array   # pixel count of the largest component
    valid: jax.Array  # () bool — any foreground at all


@functools.partial(jax.jit, static_argnames=("max_iters",))
def largest_component_bbox(mask: jax.Array, max_iters: int = 64) -> ComponentBBox:
    """Bounding box of the largest 4-connected foreground component.

    Replaces ``findContours`` + ``max(contourArea)`` + ``boundingRect``.
    Labels = linear pixel index; iterate min over the 4-neighborhood +
    pointer jumping until fixpoint, then reduce.
    """
    H, W = mask.shape
    n = H * W
    idx = jnp.arange(n, dtype=jnp.int32).reshape(H, W)
    big = jnp.int32(n)
    labels = jnp.where(mask, idx, big)

    def neighbors_min(lab):
        up = jnp.concatenate([jnp.full((1, W), big, jnp.int32), lab[:-1]], 0)
        down = jnp.concatenate([lab[1:], jnp.full((1, W), big, jnp.int32)], 0)
        left = jnp.concatenate([jnp.full((H, 1), big, jnp.int32), lab[:, :-1]], 1)
        right = jnp.concatenate([lab[:, 1:], jnp.full((H, 1), big, jnp.int32)], 1)
        m = jnp.minimum(jnp.minimum(up, down), jnp.minimum(left, right))
        return jnp.where(mask, jnp.minimum(lab, m), big)

    def cond(state):
        lab, it, changed = state
        return changed & (it < max_iters)

    def body(state):
        lab, it, _ = state
        new = neighbors_min(lab)
        # Pointer jumping (labels are pixel indices).
        flat = new.reshape(-1)
        new = jnp.where(mask, jnp.minimum(new, flat[jnp.clip(new, 0, n - 1)].reshape(H, W)), big)
        return (new, it + 1, jnp.any(new != lab))

    labels, _, _ = jax.lax.while_loop(cond, body, (labels, jnp.int32(0), jnp.bool_(True)))

    flat = labels.reshape(-1)
    seg = jnp.clip(flat, 0, n)
    counts = jax.ops.segment_sum(mask.reshape(-1).astype(jnp.int32), seg, num_segments=n + 1)
    counts = counts.at[n].set(0)
    root = jnp.argmax(counts)
    area = counts[root]
    comp = (flat == root).reshape(H, W)
    cols = jnp.any(comp, axis=0)
    rows = jnp.any(comp, axis=1)
    xs = jnp.arange(W, dtype=jnp.int32)
    ys = jnp.arange(H, dtype=jnp.int32)
    x1 = jnp.min(jnp.where(cols, xs, W)).astype(jnp.int32)
    x2 = jnp.max(jnp.where(cols, xs, -1)).astype(jnp.int32)
    y1 = jnp.min(jnp.where(rows, ys, H)).astype(jnp.int32)
    y2 = jnp.max(jnp.where(rows, ys, -1)).astype(jnp.int32)
    valid = area > 0
    return ComponentBBox(x1=x1, y1=y1, x2=x2, y2=y2, area=area, valid=valid)


def bilinear_resize(img: jax.Array, out_hw: Tuple[int, int]) -> jax.Array:
    """Bilinear resize (H, W[, C]) -> out_hw — the capability behind
    OpenPose's resizeAndMerge scale pyramid (jax.image wraps the XLA
    gather/convolution path)."""
    import jax.image

    shape = out_hw + img.shape[2:]
    return jax.image.resize(img, shape, method="bilinear")
