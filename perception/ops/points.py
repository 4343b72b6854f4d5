"""Masked point-cloud primitives: filters, voxel downsample, centroids.

Equivalents of the PCL preprocessing used throughout the
reference (``pcl::PassThrough`` at ``ground_plane_segmentation.cpp:53-65``,
``pcl::VoxelGrid`` at ``:69-73`` / ``object_pose_detection.cpp:293-298``,
``pcl::compute3DCentroid`` at ``surface_normal_estimation.cpp:217-219``).

Everything follows the fixed-capacity convention: a cloud is
``(points[N, 3] float32, mask[N] bool)``; ops never change N, they only
update the mask (XLA static shapes — SURVEY.md §7.4 item 1). Masked-out
points are parked at a sentinel far outside any scene so reductions and
NN searches need no special-casing.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# Far-away park position for invalid points: keeps them out of every
# radius/NN query without introducing NaN/inf into arithmetic.
SENTINEL = 1.0e6


def apply_mask(points: jax.Array, mask: jax.Array) -> jax.Array:
    """Park masked-out points at the sentinel location."""
    return jnp.where(mask[..., None], points, SENTINEL)


def passthrough(
    points: jax.Array,
    mask: jax.Array,
    axis: int,
    lo: float,
    hi: float,
) -> jax.Array:
    """PassThrough filter: keep points with lo <= p[axis] <= hi.

    Returns the narrowed mask (points unchanged). Mirrors
    ``pcl::PassThrough::setFilterLimits`` semantics (inclusive bounds).
    """
    v = points[..., axis]
    return mask & (v >= lo) & (v <= hi)


def crop_box(points: jax.Array, mask: jax.Array, lo, hi) -> jax.Array:
    """Axis-aligned box filter; lo/hi are length-3."""
    lo = jnp.asarray(lo, points.dtype)
    hi = jnp.asarray(hi, points.dtype)
    inside = jnp.all((points >= lo) & (points <= hi), axis=-1)
    return mask & inside


def centroid(points: jax.Array, mask: jax.Array) -> jax.Array:
    """Masked mean over valid points: (..., N, 3), (..., N) -> (..., 3)."""
    w = mask.astype(points.dtype)
    total = jnp.sum(points * w[..., None], axis=-2)
    count = jnp.sum(w, axis=-1, keepdims=True)
    return total / jnp.maximum(count, 1.0)


def voxel_ids(points: jax.Array, origin: jax.Array, voxel_size, dims) -> jax.Array:
    """Quantize points to linear voxel ids on a fixed grid.

    ``dims`` (3,) static ints; out-of-grid coordinates are clamped, so
    callers should pick a grid covering the filtered workspace.
    """
    cell = jnp.floor((points - origin) / voxel_size).astype(jnp.int32)
    dims_arr = jnp.asarray(dims, jnp.int32)
    cell = jnp.clip(cell, 0, dims_arr - 1)
    return (cell[..., 0] * dims[1] + cell[..., 1]) * dims[2] + cell[..., 2]


def voxel_downsample(
    points: jax.Array,
    mask: jax.Array,
    voxel_size: float,
    origin=None,
    dims=(1024, 1024, 1024),
) -> Tuple[jax.Array, jax.Array]:
    """VoxelGrid downsample: one centroid per occupied voxel.

    Matches ``pcl::VoxelGrid`` semantics (centroid, not center). Output
    keeps the input capacity N: slot i holds the centroid of the i-th
    occupied voxel (in voxel-id order) and the mask marks which slots
    are live. Implementation is sort-free: segment-sum keyed by a
    compacted voxel rank computed from a sorted id array.

    ``origin=None`` anchors the grid just below the masked minimum,
    snapped to a leaf multiple so cell boundaries stay at absolute
    ``voxel_size * k`` regardless of the cloud (out-of-grid coordinates
    clamp, so a fixed origin only suits clouds within ``dims * leaf``
    of it — at small leaves that span is tiny).
    """
    centroids, _, out_mask = voxel_downsample_with_attrs(
        points, mask, None, voxel_size, origin=origin, dims=dims
    )
    return centroids, out_mask


def voxel_downsample_with_attrs(
    points: jax.Array,
    mask: jax.Array,
    attrs,
    voxel_size: float,
    origin=None,
    dims=(1024, 1024, 1024),
    weights=None,
):
    """VoxelGrid downsample carrying per-point attributes.

    Like :func:`voxel_downsample`, but also averages an optional
    ``attrs`` array (N, A) per voxel (e.g. normals — renormalize at the
    caller; colors; weights). Returns (centroids, attr_means | None,
    mask), all at the input capacity N. This is the map-fusion
    primitive: merge keyframe clouds into a deduplicated local map with
    one call.

    ``weights`` (N,) optionally weights each point's contribution to
    its voxel's centroid and attr mean (default: uniform). The map
    fuser uses this for recency-weighted fusion: old map points carry
    a decayed weight so freshly registered geometry dominates voxels
    where both land (exponential forgetting of drift-smeared points).
    """
    n = points.shape[0]
    if origin is None:
        lo = jnp.min(jnp.where(mask[:, None], points, jnp.inf), axis=0)
        lo = jnp.where(jnp.isfinite(lo), lo, 0.0)
        origin = (jnp.floor(lo / voxel_size) - 1.0) * voxel_size
    origin = jnp.asarray(origin, points.dtype)
    ids = voxel_ids(points, origin, voxel_size, dims)
    # Invalid points get an id past every real voxel so they sort last.
    big = jnp.int32(dims[0] * dims[1] * dims[2])
    ids = jnp.where(mask, ids, big)

    sorted_ids, order = jax.lax.sort(
        (ids, jnp.arange(ids.shape[0], dtype=jnp.int32)), num_keys=1
    )
    # First occurrence flags over the sorted ids.
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_ids[1:] != sorted_ids[:-1]]
    )
    first = first & (sorted_ids < big)
    rank_sorted = jnp.cumsum(first.astype(jnp.int32)) - 1  # voxel rank per sorted slot
    valid_sorted = sorted_ids < big
    rank_sorted = jnp.where(valid_sorted, rank_sorted, n - 1)

    pts_sorted = points[order]
    w = valid_sorted.astype(points.dtype)
    if weights is not None:
        w = w * jnp.maximum(jnp.asarray(weights, points.dtype)[order], 0.0)
    sums = jax.ops.segment_sum(pts_sorted * w[:, None], rank_sorted, num_segments=n)
    counts = jax.ops.segment_sum(w, rank_sorted, num_segments=n)
    out_mask = counts > 0
    # The last segment may mix the final real voxel with invalid points;
    # invalid rows carry zero weight so sums stay correct. The guard
    # must stay far below any real weight (weighted fusion can put
    # total voxel weight < 1): empty segments give 0/eps = 0 and are
    # masked out anyway.
    denom = jnp.maximum(counts, 1e-12)[:, None]
    centroids = sums / denom
    attr_means = None
    if attrs is not None:
        attr_sums = jax.ops.segment_sum(
            attrs[order] * w[:, None], rank_sorted, num_segments=n
        )
        attr_means = attr_sums / denom
    return apply_mask(centroids, out_mask), attr_means, out_mask


def compact(points: jax.Array, mask: jax.Array, capacity: int) -> Tuple[jax.Array, jax.Array]:
    """Gather valid points to the front, reducing/padding to ``capacity``.

    Used to shrink working sets between stages (e.g. after downsample)
    so downstream kernels run on a smaller static shape. When more than
    ``capacity`` points are valid, an **evenly spaced** subset of the
    valid points is kept (every cnt/capacity-th by valid rank) rather
    than the first ``capacity``: inputs arrive in raster or voxel-sorted
    order, and a prefix cut would delete one whole side of the scene
    (measured: it shaved the +x half of the cuboid cloud and biased ICP
    by 7 cm), while decimation preserves the spatial distribution.
    """
    keep, _ = _keep_positions(mask, capacity, points.dtype)
    # Stable bool argsort rather than a cumsum+scatter compaction or a
    # cumsum + vectorized binary search: the O(log N) search is a
    # sequential fori_loop of tiny gathers, while XLA lowers the 1-bit
    # sort as parallel passes.
    order = jnp.argsort(~keep, stable=True)  # kept first, stable
    idx = order[:capacity]
    out_mask = keep[idx]
    return apply_mask(points[idx], out_mask), out_mask


def compact_prefix(points: jax.Array, mask: jax.Array, capacity: int) -> Tuple[jax.Array, jax.Array]:
    """compact() specialized for PREFIX masks (all valid slots lead).

    voxel_downsample emits exactly this layout (slot i = i-th occupied
    voxel), so the follow-up decimation reduces to one row gather of
    ``capacity`` evenly spaced valid rows — no argsort over the full
    input capacity. Over-capacity inputs are decimated evenly, like
    compact().
    """
    cnt = jnp.sum(mask, dtype=jnp.int32)
    out_rank = jnp.arange(capacity, dtype=jnp.int32)
    # Even decimation: out j <- valid row floor(j * cnt / kept).
    kept = jnp.minimum(cnt, capacity)
    idx = (out_rank * cnt) // jnp.maximum(kept, 1)
    idx = jnp.minimum(idx, points.shape[0] - 1)
    out_mask = out_rank < kept
    return apply_mask(points[idx], out_mask), out_mask


def _keep_positions(mask: jax.Array, capacity: int, dtype):
    """Decimation keep-mask (+ front-compacted rank, informational).

    Keep valid point r iff the integer grid floor(r * ratio) advances,
    ratio = capacity/cnt (< 1 when over capacity -> even subset). When
    cnt <= capacity every valid point is kept unconditionally (the grid
    test is skipped — float reciprocal-multiply rounding could otherwise
    drop a point even at ratio == 1). Over capacity, float32 rounding at
    grid boundaries can perturb which neighbor is kept and may
    undershoot by one (kept count is capacity or capacity-1).
    """
    cnt = jnp.sum(mask, dtype=jnp.int32)
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1  # valid rank per slot
    ratio = jnp.minimum(capacity, cnt).astype(dtype) / jnp.maximum(cnt, 1).astype(dtype)
    r = rank.astype(dtype)
    advance = jnp.floor((r + 1.0) * ratio) > jnp.floor(r * ratio)
    keep = mask & ((cnt <= capacity) | advance)
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    pos = jnp.where(keep, jnp.minimum(pos, capacity), capacity)
    return keep, pos


def compact_with_attrs(
    points: jax.Array, mask: jax.Array, attrs: jax.Array, capacity: int
):
    """:func:`compact` that also gathers per-point attributes.

    Returns (points (capacity, 3), attrs (capacity, A), mask (capacity,)).
    """
    keep, _ = _keep_positions(mask, capacity, points.dtype)
    order = jnp.argsort(~keep, stable=True)
    idx = order[:capacity]
    out_mask = keep[idx]
    return apply_mask(points[idx], out_mask), attrs[idx], out_mask


def dominant_blob_filter(
    points: jax.Array,
    mask: jax.Array,
    cell: float = 0.05,
    radius: float = 0.18,
    origin=(-5.0, -5.0, -5.0),
    dims=(256, 256, 256),
) -> jax.Array:
    """Keep points within ``radius`` of the densest coarse voxel's
    centroid — a constant-round stand-in for "largest cluster" when the
    dominant object is known to be the biggest blob (the cuboid
    pipeline). Full Euclidean clustering (ops/cluster.py) costs O(
    component diameter) propagation rounds of latency-bound small ops;
    this is two segment-sums and an argmax. Callers keep their fitness
    gate as the correctness backstop. Returns the narrowed mask."""
    n = points.shape[0]
    ids = voxel_ids(points, jnp.asarray(origin, points.dtype), cell, dims)
    ids = jnp.where(mask, ids, -1)
    # Count points per occupied cell via sort + segment trick on ranks.
    sorted_ids, order = jax.lax.sort(
        (ids, jnp.arange(ids.shape[0], dtype=jnp.int32)), num_keys=1
    )
    first = jnp.concatenate([jnp.ones((1,), bool), sorted_ids[1:] != sorted_ids[:-1]])
    valid_sorted = sorted_ids >= 0
    first = first & valid_sorted
    rank = jnp.cumsum(first.astype(jnp.int32)) - 1
    rank = jnp.where(valid_sorted, rank, n)
    counts = jax.ops.segment_sum(valid_sorted.astype(jnp.int32), rank, num_segments=n + 1)[:n]
    pts_sorted = points[order]
    sums = jax.ops.segment_sum(
        pts_sorted * valid_sorted[:, None], rank, num_segments=n + 1
    )[:n]
    best = jnp.argmax(counts)
    center = sums[best] / jnp.maximum(counts[best], 1)
    d2 = jnp.sum((points - center) ** 2, axis=-1)
    return mask & (d2 <= radius * radius)


def bounds(points: jax.Array, mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Masked min/max corners of a cloud."""
    big = jnp.asarray(SENTINEL, points.dtype)
    lo = jnp.min(jnp.where(mask[..., None], points, big), axis=-2)
    hi = jnp.max(jnp.where(mask[..., None], points, -big), axis=-2)
    return lo, hi
