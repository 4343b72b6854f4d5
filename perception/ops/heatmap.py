"""Heatmap ops: multi-scale resize+merge and peak NMS with subpixel
refinement.

Equivalents of OpenPose's two hottest custom kernels
(SURVEY.md §2.5 net module):

  * ``resize_and_merge`` — bilinear upsample of per-scale CNN heatmaps
    to net resolution and average across the scale pyramid
    (``resizeAndMergeBase.cu:26-212``: resizeKernel / resize8Times with
    shared-mem tiling -> here one fused jax.image.resize + mean, which
    XLA lowers to tiled gathers);
  * ``nms_heatmap`` — per-part peak extraction: 3x3 local-maximum +
    threshold, top-K peaks with quadratic subpixel refinement
    (``nmsBase.cu:51-249``: nmsRegisterKernel + writeResultKernel with
    its offset-based refine). Fixed peak capacity + masks instead of
    the reference's register-then-compact scheme.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.image
import jax.numpy as jnp


def resize_and_merge(
    heatmaps: jax.Array,
    out_hw: Tuple[int, int],
    scale_weights=None,
) -> jax.Array:
    """(S, C, h, w) per-scale heatmaps -> (C, H, W) merged at out_hw.

    Mirrors ResizeAndMergeCaffe with merge=average (the multi-scale
    inference path, poseExtractorCaffe.cpp:243-295).
    """
    S, C, h, w = heatmaps.shape
    H, W = out_hw
    up = jax.image.resize(heatmaps, (S, C, H, W), method="bilinear")
    if scale_weights is None:
        return jnp.mean(up, axis=0)
    wts = jnp.asarray(scale_weights, up.dtype)
    wts = wts / jnp.sum(wts)
    return jnp.einsum("s,schw->chw", wts, up)


class Peaks(NamedTuple):
    xy: jax.Array     # (C, K, 2) float32 subpixel (x, y)
    score: jax.Array  # (C, K)
    mask: jax.Array   # (C, K)


@functools.partial(jax.jit, static_argnames=("max_peaks",))
def nms_heatmap(
    heatmaps: jax.Array,
    threshold: float = 0.05,
    max_peaks: int = 32,
) -> Peaks:
    """(C, H, W) heatmaps -> top-K peaks per channel with subpixel refine.

    A peak is a strict 3x3 local maximum above ``threshold``; its
    position is refined by the quadratic fit offset
    dx = (f(x+1) - f(x-1)) / (2 (2 f(x) - f(x-1) - f(x+1))) per axis —
    the same one-sided parabola OpenPose's writeResultKernel uses.
    """
    C, H, W = heatmaps.shape

    # Local maximum with lexicographic tie-break: strictly greater than
    # raster-earlier neighbors, >= raster-later ones — a plateau (e.g. a
    # maximum exactly between two pixels) yields exactly one peak.
    def shifted(dy, dx):
        # s[y, x] = hm[y-dy, x-dx] (the neighbor at offset (-dy, -dx)).
        s = jnp.roll(heatmaps, (dy, dx), (1, 2))
        if dy == 1:
            s = s.at[:, 0, :].set(-jnp.inf)
        if dy == -1:
            s = s.at[:, -1, :].set(-jnp.inf)
        if dx == 1:
            s = s.at[:, :, 0].set(-jnp.inf)
        if dx == -1:
            s = s.at[:, :, -1].set(-jnp.inf)
        return s

    is_peak = heatmaps > threshold
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = shifted(dy, dx)
            # neighbor coordinate is (y-dy, x-dx): raster-earlier iff
            # dy > 0, or dy == 0 and dx > 0.
            if dy > 0 or (dy == 0 and dx > 0):
                is_peak &= heatmaps > n      # strictly beat earlier pixels
            else:
                is_peak &= heatmaps >= n     # ties allowed vs later pixels
    score = jnp.where(is_peak, heatmaps, -1.0)

    flat = score.reshape(C, H * W)
    top, idx = jax.lax.top_k(flat, max_peaks)  # (C, K)
    py = idx // W
    px = idx % W
    valid = top > 0

    # Quadratic subpixel refinement from the 4-neighborhood.
    def gather(dy, dx):
        yy = jnp.clip(py + dy, 0, H - 1)
        xx = jnp.clip(px + dx, 0, W - 1)
        return heatmaps[jnp.arange(C)[:, None], yy, xx]

    c0 = gather(0, 0)
    left, right = gather(0, -1), gather(0, 1)
    up, down = gather(-1, 0), gather(1, 0)
    denom_x = jnp.maximum(2.0 * c0 - left - right, 1e-6)
    denom_y = jnp.maximum(2.0 * c0 - up - down, 1e-6)
    off_x = jnp.clip((right - left) / (2.0 * denom_x), -0.5, 0.5)
    off_y = jnp.clip((down - up) / (2.0 * denom_y), -0.5, 0.5)

    xy = jnp.stack([px + off_x, py + off_y], axis=-1)
    return Peaks(
        xy=jnp.where(valid[..., None], xy, 0.0),
        score=jnp.where(valid, top, 0.0),
        mask=valid,
    )


def gaussian_heatmap(
    hw: Tuple[int, int], centers: jax.Array, sigma: float = 2.0
) -> jax.Array:
    """Render (K, 2) centers (x, y) into (K, H, W) Gaussian heatmaps —
    test fixture / training-target generator."""
    H, W = hw
    yy = jnp.arange(H, dtype=jnp.float32)[:, None]
    xx = jnp.arange(W, dtype=jnp.float32)[None, :]
    dx = xx[None] - centers[:, 0][:, None, None]
    dy = yy[None] - centers[:, 1][:, None, None]
    return jnp.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
