"""Batched-hypothesis RANSAC plane segmentation.

Replacement for PCL's sequential ``SACSegmentation``
(``SACMODEL_PLANE`` at ``ground_plane_segmentation.cpp:85-93``, the
axis-constrained ``SACMODEL_PERPENDICULAR_PLANE`` /
``SACMODEL_PARALLEL_PLANE`` variants at
``surface_normal_estimation.cpp:105-165``).

Instead of PCL's draw-one-hypothesis-at-a-time loop, all K hypotheses
are sampled at once and scored in a single fused pass: the N x K
point-plane distances, the threshold, the mask and the count over N
are one XLA reduction, so the distance matrix is never stored — the
"fused RANSAC scoring" the north star asks for (BASELINE.json). The
best hypothesis is refined by a least-squares plane fit over its
inliers (smallest eigenvector of the inlier scatter matrix — same as
PCL's ``optimize_coefficients``).

Plane convention: coefficients (a, b, c, d) with unit normal and
a*x + b*y + c*z + d = 0 (PCL ``ModelCoefficients`` layout).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from perception.geometry import f32


class PlaneFit(NamedTuple):
    coefficients: jax.Array  # (4,) [a, b, c, d], |n| = 1
    inliers: jax.Array       # (N,) bool
    num_inliers: jax.Array   # () int32
    valid: jax.Array         # () bool — a usable hypothesis was found


def _sample_indices(key: jax.Array, mask: jax.Array, num: int) -> jax.Array:
    """(num, 3) indices of valid points, uniform over the mask.

    Inverse-CDF over the mask's cumsum: draw uniform valid RANKS, then
    one searchsorted maps rank -> row. Replaces
    ``jax.random.categorical``: categorical materializes
    (num, 3, N) Gumbel noise — 100 MB + a full argmax at the pipeline's
    8192 x 1024 shape, which made hypothesis SAMPLING as expensive as
    hypothesis SCORING. The three picks per hypothesis are independent;
    degenerate (repeated-index) hypotheses simply score poorly and lose
    the argmax, matching RANSAC semantics without rejection loops.
    """
    csum = jnp.cumsum(mask.astype(jnp.int32))
    cnt = jnp.maximum(csum[-1], 1)
    ranks = jax.random.randint(key, (num, 3), 1, cnt + 1)
    idx = jnp.searchsorted(csum, ranks, side="left", method="sort")
    return jnp.clip(idx, 0, mask.shape[0] - 1).astype(jnp.int32)


def _plane_from_triplets(p0, p1, p2) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Normals (K, 3) unit + offsets d (K,) + non-degenerate flag.

    A triplet with repeated/collinear points has a ~zero cross product;
    such a hypothesis would trivially "cover" every point (zero normal
    puts everything at distance |d|=0), so it must be discarded."""
    n = jnp.cross(p1 - p0, p2 - p0)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    ok = norm[..., 0] > 1e-10
    n = n / jnp.maximum(norm, 1e-12)
    d = -jnp.sum(n * p0, axis=-1)
    return n, d, ok


def _score(points, mask, normals, d, threshold):
    """Inlier count per hypothesis: (N,3), (N,), (K,3), (K,) -> (K,).

    The signed distance is three broadcast FMAs rather than a dot, so
    there is no matrix-unit rounding: a count can differ from an exact
    oracle only for a point within an ulp or so of the threshold. XLA
    fuses distance, compare, mask and the sum over N into one
    reduction; the (N, K) matrix is never written to memory.
    """
    dist = points[:, 0:1] * normals[None, :, 0]
    dist += points[:, 1:2] * normals[None, :, 1]
    dist += points[:, 2:3] * normals[None, :, 2]
    dist += d[None, :]
    inl = (jnp.abs(dist) <= threshold) & mask[:, None]
    return jnp.sum(inl, axis=0, dtype=jnp.int32)  # (K,)


def _refit(points, mask, inliers) -> Tuple[jax.Array, jax.Array]:
    """Least-squares plane over inliers: smallest-eigenvector of scatter."""
    w = (inliers & mask).astype(points.dtype)
    count = jnp.maximum(jnp.sum(w), 3.0)
    mean = jnp.sum(points * w[:, None], axis=0) / count
    centered = (points - mean) * w[:, None]
    cov = f32.matmul(centered.T, centered) / count  # (3, 3)
    # Smallest eigenvector of a symmetric 3x3.
    evals, evecs = jnp.linalg.eigh(cov)
    n = evecs[:, 0]
    n = n / jnp.maximum(jnp.linalg.norm(n), 1e-12)
    d = -jnp.sum(n * mean)
    return n, d


@functools.partial(
    jax.jit,
    static_argnames=("num_hypotheses", "model"),
)
def ransac_plane(
    points: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    threshold: float = 0.01,
    num_hypotheses: int = 1024,
    model: str = "plane",
    axis: Optional[jax.Array] = None,
    eps_angle: float = 0.1,
    min_inliers: int = 10,
) -> PlaneFit:
    """Segment the dominant plane from a masked cloud.

    model: 'plane' | 'perpendicular' (normal within eps_angle of axis —
    SACMODEL_PERPENDICULAR_PLANE) | 'parallel' (normal within eps_angle
    of 90 deg to axis — SACMODEL_PARALLEL_PLANE). ``num_hypotheses``
    mirrors PCL's max_iterations (reference uses 1000,
    ``ground_plane_segmentation.cpp:88``).
    """
    idx = _sample_indices(key, mask, num_hypotheses)
    p0, p1, p2 = points[idx[:, 0]], points[idx[:, 1]], points[idx[:, 2]]
    normals, d, nondegenerate = _plane_from_triplets(p0, p1, p2)

    scores = _score(points, mask, normals, d, threshold)
    scores = jnp.where(nondegenerate, scores, -1)

    if model != "plane":
        if axis is None:
            raise ValueError(f"model={model!r} requires an axis")
        ax = axis / jnp.maximum(jnp.linalg.norm(axis), 1e-12)
        cosang = jnp.abs(jnp.sum(normals * ax, axis=-1))
        if model == "perpendicular":
            ok = cosang >= jnp.cos(eps_angle)
        elif model == "parallel":
            ok = cosang <= jnp.sin(eps_angle)
        else:
            raise ValueError(f"unknown model {model!r}")
        scores = jnp.where(ok, scores, -1)

    best = jnp.argmax(scores)
    best_score = scores[best]
    n_best, d_best = normals[best], d[best]

    # Refine on the winning hypothesis' inliers, then re-collect inliers
    # against the refined plane (PCL optimize_coefficients behavior).
    inl0 = (jnp.abs(_plane_distance(points, n_best, d_best)) <= threshold) & mask
    n_ref, d_ref = _refit(points, mask, inl0)
    # Keep the refined plane's orientation consistent with the sample.
    flip = jnp.sign(jnp.sum(n_ref * n_best))
    flip = jnp.where(flip == 0, 1.0, flip)
    n_ref, d_ref = n_ref * flip, d_ref * flip

    # Guard: if refit drifted outside an axis constraint, fall back to
    # the raw hypothesis (constraint satisfaction beats LS optimality).
    if model != "plane":
        cos_ref = jnp.abs(jnp.sum(n_ref * ax))
        if model == "perpendicular":
            ok_ref = cos_ref >= jnp.cos(eps_angle)
        else:
            ok_ref = cos_ref <= jnp.sin(eps_angle)
        n_ref = jnp.where(ok_ref, n_ref, n_best)
        d_ref = jnp.where(ok_ref, d_ref, d_best)

    inliers = (jnp.abs(_plane_distance(points, n_ref, d_ref)) <= threshold) & mask
    num = jnp.sum(inliers, dtype=jnp.int32)
    valid = (best_score >= min_inliers) & (num >= min_inliers)
    coeffs = jnp.concatenate([n_ref, d_ref[None]])
    return PlaneFit(coefficients=coeffs, inliers=inliers, num_inliers=num, valid=valid)


def _plane_distance(points, normal, d):
    """Signed distance of points (..., 3) to n . p + d = 0, in the
    scorer's FMA order."""
    return (points[..., 0] * normal[0] + points[..., 1] * normal[1]
            + points[..., 2] * normal[2] + d)


def point_plane_distance(points: jax.Array, coefficients: jax.Array) -> jax.Array:
    """Signed distance of points (..., 3) to plane (4,)."""
    return _plane_distance(points, coefficients[:3], coefficients[3])
