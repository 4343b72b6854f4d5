"""Voxel-hash nearest-neighbor search for large clouds.

The "batched voxel-hash NN-gather" primitive (BASELINE.json) that
replaces the KD-tree inside PCL's ICP (reference:
cuboid_detection/src/iterative_closest_point.cpp:170-178,
object_detection/src/object_pose_detection.cpp:345-349). The brute
force of ops/nn.py serves the 10^3-10^4 point working sets of the
cuboid pipeline; this module is the sublinear engine for larger maps.

Design (no per-query gathers at all):

  build:  quantize reference points to cells of size = search radius on
          a grid fitted to the cloud's bounding box; sort by cell id
          once -> contiguous per-cell runs in one flat table.
  query:  queries are processed in TILES of spatially-coherent points
          (sorted by cell id, or already coherent from the caller).
          Each tile's 27-neighborhood lives inside ONE contiguous
          range of the cell-sorted table ([min cell - slab, max cell +
          slab]); the query slices that range and brute-forces the
          (tile x range) distances. d2 is the exact f32 (q-p)^2 — no
          |a|^2+|b|^2-2ab cancellation and no matrix product — so the
          result is the argmin over true f32 distances (index-exact vs
          a KD-tree oracle in f64 on non-degenerate data).

          Per-query work is O(points in the tile's slab range), not
          O(M) — sublinear in the map size.

Exactness: any true neighbor within ``radius`` of a query lands in the
tile's range (superset of the query's 27 cells) unless the range
overflowed ``rng_pts`` (reported via ``return_stats``); the result then
equals exact NN whenever the true NN distance <= radius.

Production pattern (ICP): sort the source cloud by cell id ONCE per
frame, then every Gauss-Newton iteration queries the transformed
points with ``sort=False`` — the stale order stays tile-coherent under
mm-scale pose updates, and queries return in the caller's layout.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from perception.ops.points import SENTINEL, apply_mask, bounds

_TABLE_PAD = 1024  # table rows padded to this multiple (divisible by rblk)


class VoxelHash(NamedTuple):
    points: jax.Array      # (N, 3) sorted by cell id
    table: jax.Array       # (Npad, 8) f32 rows [x, y, z, 1, 0...]
                           # the query slices; padding rows are
                           # SENTINEL coords (their d2 is ~1e12, never
                           # winning)
    cell_ids: jax.Array    # (N,) int32 sorted
    origin: jax.Array      # (3,)
    cell_size: jax.Array   # ()
    dims: jax.Array        # (3,) int32 grid extents (traced)
    sentinel_id: jax.Array # () int32 id marking invalid/padded slots
    order: jax.Array       # (N,) int32 original index per sorted slot —
                           # gather per-point attributes (normals,
                           # colors) into hash order with
                           # ``attr[vh.order]``


def _cell_ids(pts, origin, cell_size, dims):
    cell = jnp.floor((pts - origin) / cell_size).astype(jnp.int32)
    cell = jnp.clip(cell, 0, dims - 1)
    return (cell[..., 0] * dims[1] + cell[..., 1]) * dims[2] + cell[..., 2]


def build(ref: jax.Array, ref_mask: jax.Array, cell_size: float) -> VoxelHash:
    """Fit the grid to the masked cloud's bounds and sort by cell id.

    The grid spans the cloud plus one guard cell per side; total cell
    count must stay < 2^31 (true for any scene up to ~1000 cells/axis —
    e.g. 10 m at 1 cm)."""
    cell_size = jnp.asarray(cell_size, ref.dtype)
    lo, hi = bounds(ref, ref_mask)
    origin = lo - cell_size
    dims = jnp.clip(
        jnp.ceil((hi - origin) / cell_size).astype(jnp.int32) + 2, 1, 1200
    )
    ref_p = apply_mask(ref, ref_mask)
    ids = _cell_ids(ref, origin, cell_size, dims)
    sentinel = dims[0] * dims[1] * dims[2]
    ids = jnp.where(ref_mask, ids, sentinel)
    sorted_ids, order = jax.lax.sort(
        (ids, jnp.arange(ids.shape[0], dtype=jnp.int32)), num_keys=1
    )
    pts_sorted = ref_p[order]

    n = pts_sorted.shape[0]
    # One extra sentinel block past the data: per-tile chunk windows
    # are rblk-quantized, so a range flush against the table end needs
    # slack to cover its tail without out-of-bounds slices.
    npad = -(-max(n, 1) // _TABLE_PAD) * _TABLE_PAD + _TABLE_PAD
    table = jnp.full((npad, 8), 0.0, pts_sorted.dtype)
    table = table.at[:, :3].set(SENTINEL)
    table = table.at[:n, :3].set(pts_sorted)
    table = table.at[:n, 3].set(1.0)
    return VoxelHash(
        points=pts_sorted,
        table=table,
        cell_ids=sorted_ids,
        origin=origin,
        cell_size=cell_size,
        dims=dims,
        sentinel_id=sentinel,
        order=order.astype(jnp.int32),
    )


def sort_by_cell(vh: VoxelHash, pts: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Sort ``pts`` into this hash's cell-id order (tile coherence).

    Returns (pts_sorted, order). Production ICP calls this once per
    frame and then queries with ``sort=False`` every iteration."""
    cid = _cell_ids(pts, vh.origin, vh.cell_size, vh.dims)
    _, order = jax.lax.sort(
        (cid, jnp.arange(pts.shape[0], dtype=jnp.int32)), num_keys=1
    )
    return pts[order], order


def _tile_ranges(vh: VoxelHash, q_pad, nq, tile, R, rblk):
    """Per-tile contiguous candidate range in the sorted table.

    Correct for ANY query order (min/max over the tile's real cell
    ids); tight when tiles are spatially coherent. Returns
    (start (ntiles,) 8-aligned row offsets,
     nchunk (ntiles,) rblk-chunk trip counts,
     overflow fraction of tiles whose range exceeded the R cap).

    The trip count is per-tile DYNAMIC: sparse tiles do one chunk,
    dense ones as many as their slab range needs (up to the R safety
    cap) — total work tracks the actual candidate mass instead
    of a worst-case static capacity (the range-length distribution is
    heavily skewed: p50 ~100 candidates vs p99.9 ~1.6k on the
    crossover bench cloud)."""
    dims = vh.dims
    nqp = q_pad.shape[0]
    ntiles = nqp // tile
    slop = dims[1] * dims[2] + dims[2] + 1  # +-1 x-slab + y-row + z-cell

    cid = _cell_ids(q_pad, vh.origin, vh.cell_size, dims)
    valid = (jnp.arange(nqp) < nq).reshape(ntiles, tile)
    cid_t = cid.reshape(ntiles, tile)
    big = jnp.int32(2**31 - 1)
    mincid = jnp.min(jnp.where(valid, cid_t, big), axis=1)
    maxcid = jnp.max(jnp.where(valid, cid_t, -1), axis=1)
    lo = mincid - slop
    hi = maxcid + slop + 1
    starts = jnp.searchsorted(vh.cell_ids, lo, method="sort").astype(jnp.int32)
    ends = jnp.searchsorted(vh.cell_ids, hi, method="sort").astype(jnp.int32)

    npad = vh.table.shape[0]
    # Starts aligned down to 8 rows; 8 rows of slack cover the
    # down-quantization so the range tail is never cut.
    start_a = (jnp.clip(starts, 0, max(npad - rblk, 0)) // 8) * 8
    span = jnp.minimum(ends, npad) - start_a
    nchunk = jnp.clip(-(-span // rblk), 1, R // rblk)
    nchunk = jnp.minimum(nchunk, (npad - start_a) // rblk)
    nchunk = jnp.maximum(nchunk, 1).astype(jnp.int32)
    overflow = jnp.sum(((ends - starts) > (R - 8)) & (maxcid >= 0)) / jnp.maximum(
        jnp.sum(maxcid >= 0), 1
    )
    return start_a.astype(jnp.int32), nchunk, overflow


def _query_tiles(vh, q_pad, start, nchunk, tile, R, rblk):
    """Per-tile contiguous slice of the table + argmin with first-index
    tie-break. Uses the static R cap per tile (a superset of the
    dynamic chunk count) with candidates beyond the covered span
    masked out."""
    nqp = q_pad.shape[0]
    ntiles = nqp // tile
    q_tiles = q_pad.reshape(ntiles, tile, 3)
    # Extend by R sentinel rows so the per-tile dynamic_slice never
    # clamps its start (clamping would misalign the coverage mask).
    tab_ext = jnp.concatenate(
        [vh.table, jnp.full((R, 8), 0.0, vh.table.dtype)
         .at[:, :3].set(SENTINEL)], axis=0
    )

    def one_tile(args):
        q, s0, nc = args
        blk = jax.lax.dynamic_slice(tab_ext, (s0, 0), (R, 8))
        p = blk[:, :3]                                    # (R, 3)
        d2 = jnp.sum((q[:, None, :] - p[None, :, :]) ** 2, axis=-1)
        covered = jnp.arange(R) < nc * rblk
        d2 = jnp.where(covered[None, :], d2, 4.0e12)
        loc = jnp.argmin(d2, axis=1)
        bd = jnp.take_along_axis(d2, loc[:, None], axis=1)[:, 0]
        return (s0 + loc).astype(jnp.int32), bd

    idx, d2 = jax.lax.map(one_tile, (q_tiles, start, nchunk))
    return idx.reshape(-1), d2.reshape(-1)


def _auto_params(nq: int, m: int, npad: int, rblk: int):
    """Tile size from the query/map ratio, range SAFETY CAP from the
    table size.

    A tile of cell-sorted queries spans ~``m * tile / nq`` of the
    sorted table (both sides cover the same scene), so sparse queries
    (nq << m) get small tiles, dense ones up to 512. The
    per-tile work is dynamic (chunk trip counts), so the cap only
    bounds pathological tiles (incoherent order / depth edges)."""
    ratio = nq / max(m, 1)
    if ratio >= 8:
        tile = 512
    elif ratio >= 2:
        tile = 256
    else:
        tile = 128
    rng = min(npad, 16384)
    rng = -(-rng // rblk) * rblk
    return tile, rng


@functools.partial(
    jax.jit,
    static_argnames=("tile", "rng_pts", "rblk", "sort", "return_stats"),
)
def query(
    vh: VoxelHash,
    queries: jax.Array,
    tile: int | None = None,
    rng_pts: int | None = None,
    rblk: int = 512,
    sort: bool = True,
    return_stats: bool = False,
):
    """Nearest reference point per query within ~cell_size radius.

    Returns (idx (Nq,) into the *sorted* hash points, dist2 (Nq,))
    [+ overflow fraction with ``return_stats``]. dist2 is huge
    (sentinel-scale) when no candidate cell held a neighbor.

    ``rng_pts`` caps the per-tile candidate range; tiles whose slab
    range exceeds it lose tail candidates (counted by the overflow
    stat — raise ``rng_pts`` or shrink ``tile`` if it is nonzero).
    Both default to shape-adaptive values. ``sort=False`` skips the
    coherence sort and keeps the caller's order (use after
    ``sort_by_cell``; results come back unpermuted).
    """
    nq = queries.shape[0]
    npad_t = vh.table.shape[0]
    auto_tile, auto_rng = _auto_params(nq, vh.points.shape[0], npad_t, rblk)
    tile = auto_tile if tile is None else tile
    rng_pts = auto_rng if rng_pts is None else rng_pts
    nr = min(rng_pts + rblk, npad_t) // rblk
    R = nr * rblk

    pad = (-nq) % tile
    if sort:
        # Multi-operand sort carries the coordinates through the sort
        # (saves a (Nq, 3) row gather).
        cid = _cell_ids(queries, vh.origin, vh.cell_size, vh.dims)
        _, qx, qy, qz, order_q = jax.lax.sort(
            (cid, queries[:, 0], queries[:, 1], queries[:, 2],
             jnp.arange(nq, dtype=jnp.int32)),
            num_keys=1,
        )
        q_use = jnp.stack([qx, qy, qz], axis=-1)
    else:
        q_use = queries
    q_pad = jnp.pad(q_use, ((0, pad), (0, 0)), constant_values=SENTINEL)

    start, nchunk, overflow = _tile_ranges(vh, q_pad, nq, tile, R, rblk)
    idx, d2 = _query_tiles(vh, q_pad, start, nchunk, tile, R, rblk)

    n = vh.points.shape[0]
    idx = jnp.minimum(idx[:nq], n - 1)
    d2 = d2[:nq]
    if sort:
        # Unsort by direct scatter (one pass each; the inverse-perm +
        # gather formulation costs an extra permutation build).
        idx = jnp.zeros(nq, jnp.int32).at[order_q].set(idx)
        d2 = jnp.zeros(nq, d2.dtype).at[order_q].set(d2)
    if return_stats:
        return idx, d2, overflow
    return idx, d2


def nearest_neighbor_voxelhash(
    query_pts: jax.Array,
    ref: jax.Array,
    ref_mask: jax.Array,
    radius: float,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One-shot build+query; returns (points (Nq, 3) of the neighbors,
    dist2, found mask). Neighbors farther than ``radius`` are misses."""
    vh = build(ref, ref_mask, cell_size=radius)
    idx, d2 = query(vh, query_pts)
    found = d2 <= radius * radius
    return vh.points[idx], d2, found
