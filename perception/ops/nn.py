"""Nearest-neighbor search: tiled brute force as matrix products.

Replaces PCL's KD-tree correspondence search (inside
``pcl::IterativeClosestPoint::align`` — reference
``cuboid_detection/src/iterative_closest_point.cpp:170-178`` — and
``pcl::search::KdTree`` in ``object_pose_detection.cpp:345-349``).

Design: a KD-tree's pointer-chasing is the worst possible
workload for a vector machine, while a dense distance tile
``d2 = |q|^2 - 2 q . r^T + |r|^2`` is one matmul per tile. For the
cloud sizes in this pipeline (10^3-10^4 after downsampling) the tiled
brute force is both simpler and faster than any tree. Larger clouds
(full 307k-pixel frames) use the voxel-hash path in
``perception.ops.voxelhash``.

All functions are masked (fixed capacity) and vmap/jit-safe.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from perception.geometry import f32
from perception.ops.points import SENTINEL, apply_mask

# Python float (NOT a jnp array: module-level device constants would
# initialise the XLA backend at import time, which breaks
# jax.distributed.initialize in the multi-host bootstrap).
_BIG = 4.0e12  # > (2*SENTINEL)^2; safe in f32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def nearest_neighbor(
    query: jax.Array,
    ref: jax.Array,
    ref_mask: jax.Array,
    tile: int = 4096,
) -> Tuple[jax.Array, jax.Array]:
    """For each query point, index + squared distance of nearest ref point.

    query: (Nq, 3); ref: (Nr, 3); ref_mask: (Nr,) — invalid refs never
    win. Returns (idx (Nq,) int32, dist2 (Nq,) float32). Queries are
    processed against ref in tiles to bound memory at Nq x tile.
    """
    nq = query.shape[0]
    nr = ref.shape[0]
    ref = apply_mask(ref, ref_mask)

    q_sq = jnp.sum(query * query, axis=-1)  # (Nq,)

    tile = min(tile, _round_up(nr, 8))
    num_tiles = -(-nr // tile)
    pad = num_tiles * tile - nr
    ref_p = jnp.pad(ref, ((0, pad), (0, 0)), constant_values=SENTINEL)
    ref_tiles = ref_p.reshape(num_tiles, tile, 3)

    def body(carry, ref_t):
        best_d2, best_idx, t = carry
        # (Nq, tile) squared distances via one full-f32 matmul.
        r_sq = jnp.sum(ref_t * ref_t, axis=-1)  # (tile,)
        cross = f32.matmul(query, ref_t.T)  # (Nq, tile)
        d2 = q_sq[:, None] - 2.0 * cross + r_sq[None, :]
        tile_best = jnp.min(d2, axis=1)
        tile_arg = jnp.argmin(d2, axis=1).astype(jnp.int32) + t * tile
        take = tile_best < best_d2
        return (
            jnp.where(take, tile_best, best_d2),
            jnp.where(take, tile_arg, best_idx),
            t + 1,
        ), None

    # Derive the init carry from BOTH query and ref data so its
    # sharding "varying" axes match the body output under shard_map
    # regardless of which operand is the sharded one (see jax
    # shard-map scan-vma semantics): a query-only init breaks when ref
    # rides a mesh axis (parallel/map_dist.py), a ref-only init breaks
    # the point-sharded case (parallel/icp_dist.py).
    rz = jnp.sum(ref_p[0]) * 0.0
    init = (
        q_sq * 0 + rz + _BIG,
        (q_sq * 0 + rz).astype(jnp.int32),
        jnp.int32(0),
    )
    (best_d2, best_idx, _), _ = jax.lax.scan(body, init, ref_tiles)
    best_d2 = jnp.maximum(best_d2, 0.0)  # numerical floor
    return best_idx, best_d2


def radius_count(
    query: jax.Array,
    ref: jax.Array,
    ref_mask: jax.Array,
    radius: float,
    tile: int = 4096,
) -> jax.Array:
    """Number of valid ref points within ``radius`` of each query point."""
    nr = ref.shape[0]
    ref = apply_mask(ref, ref_mask)
    q_sq = jnp.sum(query * query, axis=-1)
    r2 = radius * radius

    tile = min(tile, _round_up(nr, 8))
    num_tiles = -(-nr // tile)
    pad = num_tiles * tile - nr
    ref_p = jnp.pad(ref, ((0, pad), (0, 0)), constant_values=SENTINEL)
    ref_tiles = ref_p.reshape(num_tiles, tile, 3)

    def body(count, ref_t):
        r_sq = jnp.sum(ref_t * ref_t, axis=-1)
        d2 = q_sq[:, None] - 2.0 * (f32.matmul(query, ref_t.T)) + r_sq[None, :]
        return count + jnp.sum(d2 <= r2, axis=1, dtype=jnp.int32), None

    count, _ = jax.lax.scan(body, jnp.zeros(query.shape[0], jnp.int32), ref_tiles)
    return count


@functools.partial(jax.jit, static_argnames=("k", "tile"))
def knn(
    query: jax.Array,
    ref: jax.Array,
    ref_mask: jax.Array,
    k: int = 8,
    tile: int = 2048,
) -> Tuple[jax.Array, jax.Array]:
    """k nearest valid ref points per query: (idx (Nq, k), dist2 (Nq, k)).

    Streaming top-k merge across ref tiles (keeps memory at Nq x (tile+k)).
    Used for normal estimation and descriptor matching.
    """
    nq = query.shape[0]
    nr = ref.shape[0]
    ref = apply_mask(ref, ref_mask)
    q_sq = jnp.sum(query * query, axis=-1)

    tile = min(tile, _round_up(nr, 8))
    num_tiles = -(-nr // tile)
    pad = num_tiles * tile - nr
    ref_p = jnp.pad(ref, ((0, pad), (0, 0)), constant_values=SENTINEL)
    ref_tiles = ref_p.reshape(num_tiles, tile, 3)

    def body(carry, inp):
        best_d2, best_idx = carry  # (Nq, k)
        ref_t, t = inp
        r_sq = jnp.sum(ref_t * ref_t, axis=-1)
        d2 = q_sq[:, None] - 2.0 * (f32.matmul(query, ref_t.T)) + r_sq[None, :]
        idx = jnp.broadcast_to(jnp.arange(tile, dtype=jnp.int32)[None, :], d2.shape) + t * tile
        # Merge current top-k with this tile, re-select top-k.
        merged_d2 = jnp.concatenate([best_d2, d2], axis=1)
        merged_idx = jnp.concatenate([best_idx, idx], axis=1)
        neg_top, arg_top = jax.lax.top_k(-merged_d2, k)
        return (-neg_top, jnp.take_along_axis(merged_idx, arg_top, axis=1)), None

    init = (
        jnp.zeros((nq, k), query.dtype) + q_sq[:, None] * 0 + _BIG,
        (jnp.zeros((nq, k), query.dtype) + q_sq[:, None] * 0).astype(jnp.int32),
    )
    ts = jnp.arange(num_tiles, dtype=jnp.int32)
    (best_d2, best_idx), _ = jax.lax.scan(body, init, (ref_tiles, ts))
    return best_idx, jnp.maximum(best_d2, 0.0)
