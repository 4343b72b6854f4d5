"""Euclidean clustering as voxel-graph connected components.

Replacement for ``pcl::EuclideanClusterExtraction`` (KD-tree
BFS region growing, reference ``object_pose_detection.cpp:345-362``:
tolerance 2 cm, 200-25000 points). A pointer-chasing BFS cannot map to
a vector machine, so the algorithm is reformulated:

  1. quantize points to voxels with cell = tolerance — any two points
     within ``tol`` land in the same or 27-adjacent cells;
  2. connected components over occupied voxels by iterated min-label
     propagation (27-neighbor gather via binary search into the sorted
     unique cell-id array) with pointer-jumping (label = label[label])
     for logarithmic convergence;
  3. per-point labels, size filtering, and dense relabeling — all
     fixed-capacity masked ops.

Connectivity modes:

- ``refine=False`` (default, fastest): voxel-adjacency, which can
  bridge points up to 2*sqrt(3)*tol apart (corner-adjacent cells)
  where PCL uses the exact Euclidean radius. For tabletop scenes with
  cm-separated objects the clusterings agree.
- ``refine=True`` (PCL-exact semantics): the component graph is built
  at the *point* level — each point gathers up to ``window`` candidate
  points from each of its 27 neighbor cells (sorted-cell contiguous
  windows, the voxel-hash layout) and an edge exists iff the actual
  pair distance is <= tolerance, exactly PCL's radius criterion. The
  only approximation is the fixed per-cell window: a connecting pair
  beyond the first ``window`` points of a cell can be missed (splits,
  never merges, vs PCL). With cell = tolerance and voxel-downsampled
  inputs, cells hold far fewer than the default 16 points.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Clusters(NamedTuple):
    labels: jax.Array        # (N,) int32 cluster id in [0, max_clusters) or -1
    sizes: jax.Array         # (max_clusters,) int32 point count (0 = unused slot)
    num_clusters: jax.Array  # () int32 clusters passing the size gate
    centroids: jax.Array     # (max_clusters, 3) cluster centroids


@functools.partial(
    jax.jit, static_argnames=("max_clusters", "max_iters", "refine", "window")
)
def euclidean_cluster(
    points: jax.Array,
    mask: jax.Array,
    tolerance: float = 0.02,
    min_size: int = 200,
    max_size: int = 25000,
    max_clusters: int = 32,
    max_iters: int = 64,
    origin=(-5.0, -5.0, -5.0),
    dims=(1024, 1024, 1024),
    refine: bool = False,
    window: int = 16,
) -> Clusters:
    """Cluster a masked cloud; returns per-point labels + cluster stats.

    Cluster ids are assigned in decreasing size order (slot 0 = biggest)
    so callers can truncate; ids >= max_clusters collapse to -1.
    """
    n = points.shape[0]
    origin_arr = jnp.asarray(origin, points.dtype)
    cell = jnp.floor((points - origin_arr) / tolerance).astype(jnp.int32)
    dims_arr = jnp.asarray(dims, jnp.int32)
    cell = jnp.clip(cell, 0, dims_arr - 1)
    ids = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    big = jnp.int32(dims[0] * dims[1] * dims[2])
    ids = jnp.where(mask, ids, big)

    # Unique occupied voxels, sorted; per-point voxel rank.
    sorted_ids, order = jax.lax.sort(
        (ids, jnp.arange(ids.shape[0], dtype=jnp.int32)), num_keys=1
    )
    first = jnp.concatenate([jnp.ones((1,), bool), sorted_ids[1:] != sorted_ids[:-1]])
    vox_valid_sorted = sorted_ids < big
    first = first & vox_valid_sorted
    rank_sorted = jnp.cumsum(first.astype(jnp.int32)) - 1
    num_vox = jnp.maximum(rank_sorted[-1] + 1, 0) * 0 + jnp.sum(first, dtype=jnp.int32)

    # vox_ids[v] = cell id of voxel rank v (capacity n, padded with big).
    vox_ids = jnp.full((n,), big, jnp.int32)
    vox_ids = vox_ids.at[jnp.where(first, rank_sorted, n - 1)].set(
        jnp.where(first, sorted_ids, big)
    )
    # Ensure padded tail is 'big' even if the last real voxel landed at n-1:
    # (only slot n-1 can collide; if it is a real voxel, first/rank keeps it).
    point_rank = jnp.zeros((n,), jnp.int32).at[order].set(jnp.where(vox_valid_sorted, rank_sorted, -1))

    # 27-neighborhood cell-id offsets.
    offs = jnp.array(
        [
            (dx * dims[1] + dy) * dims[2] + dz
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
        ],
        jnp.int32,
    )

    vox_alive = vox_ids < big

    # Neighbor adjacency is label-independent: resolve the 27-cell
    # binary searches ONCE, outside the propagation loop (the search was
    # ~10 sequential compare-gather steps per iteration —
    # hoisting it leaves one gather per iteration). neigh_pos points at
    # index n (a sentinel slot) where the neighbor cell is unoccupied.
    # method="sort": the default 'scan' lowering of a (n, 27) query set
    # materializes an all-pairs (n, 27, n) comparison.
    neigh_ids = vox_ids[:, None] + offs[None, :]  # (n, 27)
    pos = jnp.clip(
        jnp.searchsorted(vox_ids, neigh_ids, method="sort"), 0, n - 1
    )
    found = vox_ids[pos] == neigh_ids
    neigh_pos = jnp.where(found, pos, jnp.int32(n))  # (n, 27)

    def cond(state):
        labels, it, changed = state
        return changed & (it < max_iters)

    if refine:
        # PCL-exact connectivity: point-level CC over distance-checked
        # edges. Candidate neighbors of point i = the first `window`
        # points of each of its 27 adjacent cells (contiguous segments
        # of the sorted-by-cell order — the voxel-hash layout); an edge
        # exists iff |p_i - p_j| <= tolerance.
        seg_start = jnp.searchsorted(sorted_ids, vox_ids, side="left", method="sort")
        seg_end = jnp.searchsorted(sorted_ids, vox_ids, side="right", method="sort")
        pr = jnp.clip(point_rank, 0, n - 1)
        nb = neigh_pos[pr]                                # (n, 27) voxel ranks
        nb_ok = (nb < n) & (point_rank >= 0)[:, None]
        nbc = jnp.clip(nb, 0, n - 1)
        starts = seg_start[nbc]                           # (n, 27)
        ends = seg_end[nbc]
        w = jnp.arange(window, dtype=jnp.int32)
        cand_pos = starts[..., None] + w                  # (n, 27, window)
        cand_ok = nb_ok[..., None] & (cand_pos < ends[..., None])
        cand_idx = order[jnp.clip(cand_pos, 0, n - 1)]    # point indices
        d2 = jnp.sum(
            (points[:, None, None, :] - points[cand_idx]) ** 2, axis=-1
        )
        cand_ok = cand_ok & (d2 <= tolerance * tolerance) & mask[cand_idx]
        cand_idx = cand_idx.reshape(n, -1)
        cand_ok = cand_ok.reshape(n, -1)

        def _point_propagate(labels):
            neigh_lab = jnp.where(cand_ok, labels[cand_idx], jnp.int32(n))
            new = jnp.minimum(labels[:n], jnp.min(neigh_lab, axis=1))
            new = jnp.where(mask, new, jnp.int32(n))
            for _ in range(5):  # pointer doubling (labels[j] <= j)
                new = jnp.minimum(new, new[jnp.clip(new, 0, n - 1)])
            new = jnp.where(mask, new, jnp.int32(n))
            return jnp.append(new, jnp.int32(n))

        def point_body(state):
            labels, it, _ = state
            new = _point_propagate(labels)
            changed = jnp.any(new[:n] != labels[:n])
            return (new, it + 1, changed)

        init_pt = jnp.where(mask, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
        labels_ext, _, _ = jax.lax.while_loop(
            cond, point_body,
            (jnp.append(init_pt, jnp.int32(n)), jnp.int32(0), jnp.bool_(True)),
        )
        point_root = jnp.where(mask, labels_ext[:n], jnp.int32(n))
        return _rank_components(points, mask, point_root, n,
                                min_size, max_size, max_clusters)

    def _propagate(labels):
        """One neighbor min-label round, then pointer DOUBLING (5 hops
        of label = label[label], each squaring the chain compression).
        Labels are voxel ranks with label[j] <= j, so hops only shrink.
        Plain 1-hop propagation needs O(component diameter) rounds;
        doubling converges a dense 45x23-cell face in ~3 rounds."""
        neigh_lab = labels[neigh_pos]  # (n, 27)
        new = jnp.minimum(labels[:n], jnp.min(neigh_lab, axis=1))
        new = jnp.where(vox_alive, new, jnp.int32(n))
        for _ in range(5):
            new = jnp.minimum(new, new[jnp.clip(new, 0, n - 1)])
        new = jnp.where(vox_alive, new, jnp.int32(n))
        return jnp.append(new, jnp.int32(n))

    def body(state):
        labels, it, _ = state  # (n + 1,), labels[n] = sentinel n
        new = _propagate(labels)
        changed = jnp.any(new[:n] != labels[:n])
        return (new, it + 1, changed)

    init_labels = jnp.where(vox_alive, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
    labels_ext, _, _ = jax.lax.while_loop(
        cond, body, (jnp.append(init_labels, jnp.int32(n)), jnp.int32(0), jnp.bool_(True))
    )
    labels_vox = labels_ext[:n]

    # Per-point component root (a voxel rank), -1 for invalid points.
    point_root = jnp.where(point_rank >= 0, labels_vox[jnp.clip(point_rank, 0, n - 1)], n)
    return _rank_components(points, mask, point_root, n,
                            min_size, max_size, max_clusters)


def _rank_components(points, mask, point_root, n, min_size, max_size, max_clusters):
    """Size-gate components, rank by size into dense slots, compute stats.

    ``point_root`` maps each point to a component root id in [0, n)
    (n = invalid); roots may be voxel ranks or point indices.
    """
    # Component sizes in point counts.
    comp_sizes = jax.ops.segment_sum(
        mask.astype(jnp.int32), jnp.clip(point_root, 0, n), num_segments=n + 1
    )[:n]

    # Size gate (PCL min/max cluster size).
    comp_ok = (comp_sizes >= min_size) & (comp_sizes <= max_size)

    # Rank surviving components by size, biggest first, into dense ids.
    comp_score = jnp.where(comp_ok, comp_sizes, -1)
    kk = min(max_clusters, n)
    top_vals, top_idx = jax.lax.top_k(comp_score, kk)  # roots of the winners
    if kk < max_clusters:
        top_vals = jnp.pad(top_vals, (0, max_clusters - kk), constant_values=-1)
        top_idx = jnp.pad(top_idx, (0, max_clusters - kk), constant_values=0)
    slot_valid = top_vals > 0
    # dense_of_root[root] = slot or -1
    dense_of_root = jnp.full((n + 1,), -1, jnp.int32)
    dense_of_root = dense_of_root.at[jnp.where(slot_valid, top_idx, n)].set(
        jnp.where(slot_valid, jnp.arange(max_clusters, dtype=jnp.int32), -1)
    )
    labels = jnp.where(mask, dense_of_root[jnp.clip(point_root, 0, n)], -1)

    sizes = jnp.where(slot_valid, top_vals, 0)
    num = jnp.sum(slot_valid, dtype=jnp.int32)

    # Centroids per dense slot.
    seg = jnp.where(labels >= 0, labels, max_clusters)
    pw = points * (labels >= 0)[:, None]
    sums = jax.ops.segment_sum(pw, seg, num_segments=max_clusters + 1)[:max_clusters]
    centroids = sums / jnp.maximum(sizes[:, None].astype(points.dtype), 1.0)

    return Clusters(labels=labels, sizes=sizes, num_clusters=num, centroids=centroids)


def extract_cluster(points, labels, cluster_id: int, capacity: int):
    """Gather one cluster's points to a fixed-capacity masked cloud."""
    from perception.ops.points import apply_mask

    m = labels == cluster_id
    order = jnp.argsort(~m, stable=True)
    idx = order[:capacity]
    out_mask = m[idx]
    return apply_mask(points[idx], out_mask), out_mask
