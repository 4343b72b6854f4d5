"""Pyramidal Lucas-Kanade sparse optical flow.

Rebuild of the reference's tracker core
(``openpose/src/openpose/tracking/pyramidalLK.{cpp,cu}``, used by
``PersonIdExtractor::updateLK`` ``personIdExtractor.cpp:64-108``):
coarse-to-fine iterative LK over an image pyramid, all keypoints
batched — each iteration is one (K, W, W) bilinear patch gather plus a
batched 2x2 solve, instead of the reference's per-point CUDA blocks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


def _downsample2(img: jax.Array) -> jax.Array:
    """2x2 mean pooling (pyramid level builder)."""
    H, W = img.shape
    h2, w2 = H // 2, W // 2
    return img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean(axis=(1, 3))


def build_pyramid(img: jax.Array, levels: int):
    pyr = [img.astype(jnp.float32)]
    for _ in range(levels - 1):
        pyr.append(_downsample2(pyr[-1]))
    return pyr


def _gather_patch(img: jax.Array, centers: jax.Array, radius: int) -> jax.Array:
    """(K, 2) float centers -> (K, P, P) bilinear patches."""
    K = centers.shape[0]
    P = 2 * radius + 1
    offs = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    oy, ox = jnp.meshgrid(offs, offs, indexing="ij")
    x = centers[:, 0, None, None] + ox[None]
    y = centers[:, 1, None, None] + oy[None]
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


class FlowResult(NamedTuple):
    points: jax.Array  # (K, 2) tracked positions in the new image
    valid: jax.Array   # (K,) tracking confidence gate
    error: jax.Array   # (K,) mean |I0 - I1| over the window


@functools.partial(jax.jit, static_argnames=("levels", "radius", "iterations"))
def lk_track(
    img0: jax.Array,
    img1: jax.Array,
    points: jax.Array,
    mask: jax.Array,
    levels: int = 3,
    radius: int = 7,
    iterations: int = 10,
    min_eig: float = 1e-3,
    max_error: float = 20.0,
) -> FlowResult:
    """Track (K, 2) points from img0 to img1 (grayscale float images)."""
    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)

    flow = jnp.zeros_like(points)
    ok = mask
    for lvl in range(levels - 1, -1, -1):
        scale = 2.0**lvl
        p0 = points / scale
        I0 = pyr0[lvl]
        I1 = pyr1[lvl]
        patch0 = _gather_patch(I0, p0, radius)
        # Spatial gradients on the template patch (central differences).
        gx = (_gather_patch(I0, p0 + jnp.array([1.0, 0.0]), radius)
              - _gather_patch(I0, p0 - jnp.array([1.0, 0.0]), radius)) * 0.5
        gy = (_gather_patch(I0, p0 + jnp.array([0.0, 1.0]), radius)
              - _gather_patch(I0, p0 - jnp.array([0.0, 1.0]), radius)) * 0.5
        Gxx = jnp.sum(gx * gx, axis=(1, 2))
        Gxy = jnp.sum(gx * gy, axis=(1, 2))
        Gyy = jnp.sum(gy * gy, axis=(1, 2))
        det = Gxx * Gyy - Gxy * Gxy
        tr = Gxx + Gyy
        eig_min = (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0))) * 0.5
        n_px = (2 * radius + 1) ** 2
        ok = ok & (eig_min / n_px > min_eig)

        def body(f, _):
            patch1 = _gather_patch(I1, p0 + f, radius)
            it = patch1 - patch0
            bx = -jnp.sum(gx * it, axis=(1, 2))
            by = -jnp.sum(gy * it, axis=(1, 2))
            d = jnp.maximum(det, 1e-9)
            du = (Gyy * bx - Gxy * by) / d
            dv = (Gxx * by - Gxy * bx) / d
            step = jnp.stack([du, dv], axis=-1)
            return f + jnp.where(ok[:, None], step, 0.0), None

        flow_lvl = flow / scale
        flow_lvl, _ = jax.lax.scan(body, flow_lvl, None, length=iterations)
        flow = flow_lvl * scale

    new_pts = points + flow
    patch1 = _gather_patch(pyr1[0], new_pts, radius)
    patch0 = _gather_patch(pyr0[0], points, radius)
    err = jnp.mean(jnp.abs(patch1 - patch0), axis=(1, 2))
    H, W = img1.shape
    inb = (
        (new_pts[:, 0] >= 0) & (new_pts[:, 0] < W) & (new_pts[:, 1] >= 0) & (new_pts[:, 1] < H)
    )
    valid = ok & inb & (err < max_error)
    return FlowResult(points=new_pts, valid=valid, error=err)
