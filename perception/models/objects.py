"""Multi-object detection service: clustering + batched template ICP.

Equivalent of ``object_detection/src/object_pose_detection.cpp``
(the ``detect_objects`` ROS service, ``service_callback`` ``:270-442``):

  cached cloud -> passthrough -> voxel downsample -> RANSAC plane
  removal -> z < 0.75 filter -> Euclidean clustering (tol 2 cm,
  200-25000 pts) -> per-cluster ICP against the requested class
  template -> winner = min |cluster size - template size|, success iff
  the difference < 250 points (``:415-429``).

Where the reference runs clusters sequentially with a <=10-restart ICP
loop (``icp_registration`` ``:212-247``), here every (cluster, restart)
pair is one row of a single batched ICP — C*K alignments execute as one
vmapped device computation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from perception.geometry import se3
from perception.models.cuboid import _yaw_restart_inits
from perception.ops import points as P
from perception.ops.cluster import euclidean_cluster
from perception.ops.icp import icp_batched
from perception.ops.ransac import ransac_plane


@dataclasses.dataclass(frozen=True)
class ObjectConfig:
    z_limits: Tuple[float, float] = (0.0, 0.9)
    x_limits: Tuple[float, float] = (-0.25, 0.25)
    voxel_size: float = 0.004           # reference launch uses 1 mm; 4 mm
                                        # keeps capacities sane at parity accuracy
    ransac_hypotheses: int = 1024
    ransac_threshold: float = 0.01
    table_z_cut: float = 0.75           # extra z filter (:330-336)
    cluster_tolerance: float = 0.02
    # PCL-exact radius connectivity (point-level distance checks) vs
    # fast voxel adjacency; see ops/cluster.py connectivity modes.
    exact_clustering: bool = False
    cluster_min_size: int = 200
    cluster_max_size: int = 25000
    max_clusters: int = 8
    cluster_capacity: int = 4096
    # Off-plane working set for clustering: after plane removal only a
    # few thousand object points remain, but label propagation over the
    # full work_capacity array costs O(capacity) bytes PER SWEEP;
    # compacting the off-plane survivors first makes clustering run at
    # the size of the data, not the buffer.
    offplane_capacity: int = 8192
    # Static working-set cap after the voxel downsample: plane RANSAC
    # and connected-components clustering run on this capacity instead
    # of the raw frame's (a full 640x480 cloud keeps 307k slots through
    # voxel_downsample; compacted to 32k, label propagation stays
    # interactive).
    work_capacity: int = 32768
    icp_restarts: int = 4
    icp_max_iterations: int = 100
    size_gate: int = 250                # |cluster - template| point gate (:429)


class ObjectDetectionResult(NamedTuple):
    success: jax.Array        # () bool — the service's response
    pose: jax.Array           # (4, 4) camera -> object (winning cluster)
    fitness: jax.Array        # () winning ICP fitness
    cluster_id: jax.Array     # () int32 winning cluster slot (-1 if none)
    size_diff: jax.Array      # () int32 |cluster size - template size|
    num_clusters: jax.Array   # () int32
    cluster_sizes: jax.Array  # (max_clusters,) int32


def detect_object(
    points: jax.Array,
    mask: jax.Array,
    template: jax.Array,
    template_mask: jax.Array,
    key: jax.Array,
    config: ObjectConfig = ObjectConfig(),
) -> ObjectDetectionResult:
    """Run the detection service against one class template.

    ``template``/``template_mask`` play the role of the .pcd selected by
    the service's ``object_id`` (screwdriver/eraser/clamp/marker).
    """
    C = config.max_clusters
    K = config.icp_restarts

    m = P.passthrough(points, mask, 2, *config.z_limits)
    m = P.passthrough(points, m, 0, *config.x_limits)
    dpts, dm = P.voxel_downsample(points, m, config.voxel_size)
    # keep-ratio of the working-set compaction; the size gate compares
    # cluster counts against the template at the same effective density,
    # so the template count is scaled by the same ratio below.
    keep_ratio = jnp.float32(1.0)
    if dpts.shape[0] > config.work_capacity:
        cnt = jnp.sum(dm, dtype=jnp.float32)
        keep_ratio = jnp.minimum(1.0, config.work_capacity / jnp.maximum(cnt, 1.0))
        # voxel_downsample emits a prefix mask -> gather-only compaction.
        dpts, dm = P.compact_prefix(dpts, dm, config.work_capacity)
    plane = ransac_plane(
        dpts, dm, key, threshold=config.ransac_threshold,
        num_hypotheses=config.ransac_hypotheses,
    )
    off = dm & ~plane.inliers
    off = P.passthrough(dpts, off, 2, 0.0, config.table_z_cut)
    opts, om = P.compact(dpts, off, config.offplane_capacity)

    clusters = euclidean_cluster(
        opts, om,
        tolerance=config.cluster_tolerance,
        min_size=config.cluster_min_size,
        max_size=config.cluster_max_size,
        max_clusters=C,
        refine=config.exact_clustering,
    )

    # Gather every cluster to its own fixed-capacity row: (C, cap, 3).
    # One argsort shared across clusters, then per-cluster compaction.
    def gather(cid):
        sel = clusters.labels == cid
        order = jnp.argsort(~sel, stable=True)
        idx = order[: config.cluster_capacity]
        cm = sel[idx]
        return P.apply_mask(opts[idx], cm), cm

    cluster_pts, cluster_masks = jax.vmap(gather)(jnp.arange(C))

    # Restart inits per cluster: centroid shift + yaw fan.
    ct = P.centroid(template, template_mask)
    cs = jax.vmap(P.centroid)(cluster_pts, cluster_masks)
    inits = jax.vmap(lambda c: _yaw_restart_inits(c, ct, K, points.dtype))(cs)  # (C, K, 4, 4)

    # Flatten (C, K) into one batch of alignments.
    flat_src = jnp.repeat(cluster_pts, K, axis=0)
    flat_msk = jnp.repeat(cluster_masks, K, axis=0)
    flat_init = inits.reshape(C * K, 4, 4)
    res = icp_batched(
        flat_src, flat_msk, template, template_mask,
        init_transforms=flat_init,
        max_iterations=config.icp_max_iterations,
    )
    fitness_ck = res.fitness.reshape(C, K)
    # Dead clusters (empty mask) produce fitness 0 — mask them out.
    alive = clusters.sizes > 0
    fitness_ck = jnp.where(alive[:, None], fitness_ck, jnp.inf)
    best_k = jnp.argmin(fitness_ck, axis=1)  # (C,)
    best_fit = jnp.take_along_axis(fitness_ck, best_k[:, None], axis=1)[:, 0]
    transforms = res.transform.reshape(C, K, 4, 4)
    best_T = jnp.take_along_axis(
        transforms, best_k[:, None, None, None] * jnp.ones((C, 1, 4, 4), jnp.int32), axis=1
    )[:, 0]

    # Winner selection: min |cluster size - template size| over alive
    # clusters (object_pose_detection.cpp:415-423). The reference
    # compares raw-resolution counts; here clusters are counted after
    # the voxel downsample, so the template is counted at the same
    # resolution to keep the 250-point gate meaningful.
    _, tmpl_dm = P.voxel_downsample(template, template_mask, config.voxel_size)
    tmpl_size = jnp.round(
        jnp.sum(tmpl_dm, dtype=jnp.float32) * keep_ratio
    ).astype(jnp.int32)
    diffs = jnp.abs(clusters.sizes - tmpl_size)
    diffs = jnp.where(alive, diffs, jnp.iinfo(jnp.int32).max)
    win = jnp.argmin(diffs)
    win_diff = diffs[win]
    success = (win_diff < config.size_gate) & (clusters.num_clusters > 0)

    pose = se3.inverse(best_T[win])
    return ObjectDetectionResult(
        success=success,
        pose=pose,
        fitness=best_fit[win],
        cluster_id=jnp.where(success, win, -1).astype(jnp.int32),
        size_diff=win_diff,
        num_clusters=clusters.num_clusters,
        cluster_sizes=clusters.sizes,
    )
