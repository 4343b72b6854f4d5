"""Keypoint array utilities.

Equivalents of the reference's keypoint helpers
(``openpose/src/openpose/utilities/keypoint.cpp``, 591 LoC: scale /
area / distance helpers) and the ``KeepTopNPeople`` core stage
(``openpose/src/openpose/core/keepTopNPeople.cpp``). All functions are
pure jnp over fixed-capacity ``(P, K, 3)`` keypoint arrays with
``(P,)`` person masks — invalid people stay in place, masked out, so
shapes remain static under jit.

Keypoint layout matches the pose module: ``[..., 0:2]`` = (u, v) pixel
coordinates, ``[..., 2]`` = confidence (0 = missing part).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def rescale_keypoints(keypoints: jax.Array, scale) -> jax.Array:
    """Scale (u, v) by ``scale`` (scalar or (2,)), leaving confidence
    untouched; missing parts (conf == 0) stay at their parked coords.
    Mirrors ``scaleKeypoints2d`` semantics (keypoint.cpp)."""
    s = jnp.broadcast_to(jnp.asarray(scale, keypoints.dtype), (2,))
    uv = keypoints[..., :2] * s
    return jnp.concatenate([uv, keypoints[..., 2:3]], axis=-1)


def keypoint_area(keypoints: jax.Array, threshold: float = 0.0) -> jax.Array:
    """Bounding-rectangle area per person over parts with conf >
    threshold (``getKeypointsArea`` analog). (P, K, 3) -> (P,). People
    with < 2 visible parts get area 0."""
    conf = keypoints[..., 2]
    vis = conf > threshold
    big = jnp.asarray(jnp.finfo(keypoints.dtype).max)
    u, v = keypoints[..., 0], keypoints[..., 1]
    umin = jnp.min(jnp.where(vis, u, big), axis=-1)
    vmin = jnp.min(jnp.where(vis, v, big), axis=-1)
    umax = jnp.max(jnp.where(vis, u, -big), axis=-1)
    vmax = jnp.max(jnp.where(vis, v, -big), axis=-1)
    area = (umax - umin) * (vmax - vmin)
    return jnp.where(jnp.sum(vis, axis=-1) >= 2, area, 0.0)


def keypoints_person_distance(
    a: jax.Array, b: jax.Array, threshold: float = 0.0
) -> jax.Array:
    """Mean pixel distance over parts visible in BOTH skeletons
    (``getDistanceAverage`` analog). (K, 3), (K, 3) -> scalar; inf when
    no shared visible parts."""
    vis = (a[:, 2] > threshold) & (b[:, 2] > threshold)
    d = jnp.linalg.norm(a[:, :2] - b[:, :2], axis=-1)
    n = jnp.sum(vis)
    return jnp.where(n > 0, jnp.sum(jnp.where(vis, d, 0.0)) / jnp.maximum(n, 1), jnp.inf)


def keep_top_n_people(
    keypoints: jax.Array,
    scores: jax.Array,
    mask: jax.Array,
    n: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Keep the ``n`` highest-scoring people (``KeepTopNPeople`` core
    stage). Static shapes: output capacity stays P; people beyond the
    top-n are masked, and survivors are compacted to the front in score
    order. Returns (keypoints, scores, mask)."""
    neg = jnp.asarray(-jnp.inf, scores.dtype)
    ranked = jnp.where(mask, scores, neg)
    order = jnp.argsort(-ranked)  # descending; masked people sink
    kp = keypoints[order]
    sc = scores[order]
    mk = mask[order] & (jnp.arange(mask.shape[0]) < n)
    return kp, jnp.where(mk, sc, 0.0), mk
