"""The cuboid-detection pipeline: the reference's flagship application.

One jitted step replaces the reference's three-node ROS graph
(``ground_plane_segmentation`` -> ``iterative_closest_point`` over topic
``/ground_plane_segmentation/points`` — SURVEY.md §3.1):

  depth (or cloud) -> passthrough z/x -> voxel downsample -> RANSAC
  ground plane -> extract off-plane points -> multi-restart batched
  template ICP -> cuboid pose + fitness gate + 3-D bbox vertices.

Parameter defaults mirror the launch files
(``ground_plane_segmentation.launch:14-20``: voxel 5 mm, RANSAC dist
1.5 cm; ``iterative_closest_point.launch:30-46``: L=0.2 W=0.1 H=0.03
template, fitness gate 0.0004). Where the reference runs a single ICP
from identity (relying on 5000 iterations and luck), this pipeline runs
K yaw restarts *in parallel* as a batch (vmapped ICP) and keeps the
best-fitness pose — the batched version of
``object_pose_detection.cpp:212-247``'s sequential restart loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry import f32, se3
from perception.geometry.camera import PinholeCamera
from perception.io.templates import cuboid_vertices
from perception.ops import points as P
from perception.ops.icp import icp_batched, icp_point_to_plane
from perception.ops.ransac import ransac_plane


@dataclasses.dataclass(frozen=True)
class CuboidConfig:
    # PassThrough (ground_plane_segmentation.cpp:53-65)
    z_limits: Tuple[float, float] = (0.0, 0.9)
    x_limits: Tuple[float, float] = (-0.2, 0.2)
    # VoxelGrid leaf (launch override 0.005)
    voxel_size: float = 0.005
    # RANSAC (1000 iters / 0.015 m in the launch)
    ransac_hypotheses: int = 1024
    ransac_threshold: float = 0.015
    # ICP — point-to-plane GN restarts (fast path); 'p2p' parity mode
    # uses PCL-style point-to-point with the same gate semantics.
    # Budget set by sweep (benchmarks/sweep_config.py): 20 iters x 4 yaw
    # restarts matches the 8-restart config's acceptance on a 24-scene
    # robustness set (yaw/offset/depth randomized) with fitness ~40x
    # under the 4e-4 gate on the bench scenes; the cuboid's 180-degree
    # symmetry means 4 restarts cover the yaw space, and the extra
    # iterations close the farther basins.
    icp_max_iterations: int = 20
    icp_restarts: int = 4
    icp_mode: str = "p2plane"
    fitness_threshold: float = 4.0e-4
    # Keep only the dominant off-plane blob before ICP — the reference's
    # EuclideanClusterExtraction-then-ICP structure
    # (object_pose_detection.cpp:345-413); without it, off-plane clutter
    # can capture the ICP basin. 'blob' = constant-round densest-voxel
    # radius filter (fast path); 'cc' = full connected components
    # (ops/cluster.py, exact semantics); 'off' = none.
    cluster_filter: str = "blob"
    cluster_tolerance: float = 0.02
    # None -> derived: cuboid circumradius + 2 cm margin. Must stay
    # tight — at 0.18 a clutter blob 25 cm out still leaked into the
    # ICP cloud on the robustness scenes.
    blob_radius: Optional[float] = None
    # Depth-image stride before backprojection. The D435 at 0.8 m has
    # ~2.1 mm native pixel spacing (z/fx); stride 2 keeps ~4.2 mm, still
    # denser than the 5 mm voxel grid, so the voxel stage sees the same
    # occupied cells while every upstream op shrinks 4x. (The reference
    # throws away the same information in its VoxelGrid.)
    depth_stride: int = 2
    # Fixed capacities along the pipeline (each stage shrinks the static
    # working-set so downstream stages stay small). Sweep-tuned: halving
    # work/box/template capacities vs the first cut (16384/2048/2048)
    # kept acceptance at 1.00; shrinking pre_capacity below the
    # passthrough cloud's size truncates
    # it non-uniformly (raster order) and breaks acceptance.
    # 16384 matches depth_stride=2 (the stride divides the valid ROI
    # cloud ~4x from the full-res 32-64k); raise 4x if stride is 1.
    pre_capacity: int = 16384    # compacted passthrough cloud before voxel
    work_capacity: int = 8192    # compacted downsampled cloud fed to RANSAC
    box_capacity: int = 1024     # compacted off-plane cloud fed to ICP
    template_capacity: int = 1280  # template downsampled to voxel_size
    # Cuboid dims for bbox output (launch: 0.2 / 0.1 / 0.03)
    dims: Tuple[float, float, float] = (0.2, 0.1, 0.03)

    @classmethod
    def pcl_parity(cls) -> "CuboidConfig":
        """Reference-budget parity mode, one switch: PCL point-to-point
        ICP semantics with the launch-file budgets — 5000-iteration cap
        with transform-epsilon 1e-9 early exit
        (iterative_closest_point.cpp:173-177), full-resolution depth,
        exact connected-components clustering. For validation runs; the
        default config is the tuned fast path."""
        return cls(
            icp_mode="p2p",
            icp_max_iterations=5000,
            depth_stride=1,
            cluster_filter="cc",
            pre_capacity=65536,
        )


class CuboidResult(NamedTuple):
    pose: jax.Array            # (4, 4) camera_frame -> cuboid pose (T such that
                               # template points map into the scene: p_cam = pose @ p_template)
    fitness: jax.Array         # () best ICP fitness (mean sq corr dist)
    accepted: jax.Array        # () bool — converged & fitness < gate
    plane: jax.Array           # (4,) ground-plane coefficients
    plane_valid: jax.Array     # () bool
    bbox: jax.Array            # (8, 3) cuboid corner vertices in camera frame
    num_box_points: jax.Array  # () int32 off-plane points used


def _yaw_restart_inits(
    scene_centroid: jax.Array, template_centroid: jax.Array, k: int, dtype
) -> jax.Array:
    """K init transforms (scene->template): centroid shift + yaw fan.

    T_i first translates the scene centroid onto the template centroid,
    then rotates by 2*pi*i/K about the template z (height) axis through
    the template centroid — diversifying across the cuboid's dominant
    symmetry mode.
    """
    angles = jnp.arange(k, dtype=dtype) * (2.0 * jnp.pi / k)
    zeros = jnp.zeros_like(angles)
    Rz = se3.so3_exp(jnp.stack([zeros, zeros, angles], axis=-1))  # (k, 3, 3)
    # p -> Rz (p + t - c_t) + c_t  with t = c_t - c_s
    t_shift = template_centroid - scene_centroid
    trans = template_centroid - f32.einsum("kij,j->ki", Rz, template_centroid) + f32.einsum(
        "kij,j->ki", Rz, t_shift
    )
    return se3.make_T(Rz, trans)


def segment_ground_plane(
    points: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    config: CuboidConfig = CuboidConfig(),
):
    """Passthrough + voxel downsample + RANSAC plane; returns
    (plane_fit, downsampled_points, box_mask) where box_mask selects the
    off-plane (object) points — ``ExtractIndices`` with ``invert``
    (ground_plane_segmentation.cpp:96-101).

    Capacities shrink stage by stage (compact = one cheap bool-argsort)
    so the voxel sort and the K x N RANSAC matmul run on small static
    shapes instead of the raw 307k-pixel capacity.
    """
    m = P.passthrough(points, mask, 2, *config.z_limits)
    m = P.passthrough(points, m, 0, *config.x_limits)
    cpts, cm = P.compact(points, m, config.pre_capacity)
    dpts0, dm0 = P.voxel_downsample(cpts, cm, config.voxel_size)
    # voxel_downsample emits a prefix mask -> gather-only compaction.
    dpts, dm = P.compact_prefix(dpts0, dm0, config.work_capacity)
    fit = ransac_plane(
        dpts,
        dm,
        key,
        threshold=config.ransac_threshold,
        num_hypotheses=config.ransac_hypotheses,
    )
    box_mask = dm & ~fit.inliers
    return fit, dpts, box_mask


def template_features(template, template_mask, config: CuboidConfig = CuboidConfig()):
    """Preprocess a template once per session: downsample to the
    pipeline's voxel resolution (a 5 mm scene cloud gains nothing from a
    2 mm template, and the NN matmul shrinks ~6x), compact to a static
    capacity, and estimate normals for the point-to-plane solver.

    Pure numpy on the host: it runs once per session on a few thousand
    points, so a device compile of the batched eigh in kNN normals
    would cost more than it saves."""
    pts = np.asarray(template, np.float32)
    mask = np.asarray(template_mask, bool)
    pts = pts[mask]

    # Voxel downsample (centroid per occupied cell).
    keys = np.floor((pts - (-5.0)) / config.voxel_size).astype(np.int64)
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    k = keys[order]
    first = np.ones(len(k), bool)
    if len(k) > 1:
        first[1:] = (k[1:] != k[:-1]).any(1)
    groups = np.cumsum(first) - 1
    sums = np.zeros((groups[-1] + 1, 3))
    np.add.at(sums, groups, pts[order])
    counts = np.bincount(groups)
    down = (sums / counts[:, None]).astype(np.float32)

    cap = config.template_capacity
    down = down[:cap]
    n = len(down)

    # kNN-PCA normals (numpy, k=8).
    d2 = ((down[:, None, :] - down[None, :, :]) ** 2).sum(-1)
    knn_idx = np.argsort(d2, axis=1)[:, :8]
    neigh = down[knn_idx]  # (n, 8, 3)
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    _, evecs = np.linalg.eigh(cov)
    normals = evecs[..., 0]
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    # Orient toward a far viewpoint behind the camera (-z).
    vp = np.array([0.0, 0.0, -10.0]) - down
    flip = (normals * vp).sum(1) < 0
    normals[flip] *= -1

    tpts = np.full((cap, 3), 1.0e6, np.float32)
    tnorm = np.zeros((cap, 3), np.float32)
    tmask = np.zeros(cap, bool)
    tpts[:n] = down
    tnorm[:n] = normals
    tmask[:n] = True
    return jnp.asarray(tpts), jnp.asarray(tnorm), jnp.asarray(tmask)


def estimate_cuboid_pose(
    box_points: jax.Array,
    box_mask: jax.Array,
    template: jax.Array,
    template_mask: jax.Array,
    config: CuboidConfig = CuboidConfig(),
    template_normals: Optional[jax.Array] = None,
):
    """Multi-restart batched ICP of the scene cloud against the template.

    Returns (pose, fitness, converged): ``pose`` maps template-frame
    points into the camera frame — the inverse of the best scene->template
    ICP transform (``iterative_closest_point.cpp:179`` convention).

    Fast path ('p2plane'): Gauss-Newton point-to-plane restarts (~10x
    fewer iterations than PCL's point-to-point); the acceptance fitness
    is still the PCL point-to-point mean-squared NN distance, evaluated
    once on the winning transform, so the 0.0004 gate keeps its meaning.
    """
    k = config.icp_restarts
    cs = P.centroid(box_points, box_mask)
    ct = P.centroid(template, template_mask)
    inits = _yaw_restart_inits(cs, ct, k, box_points.dtype)

    sources = jnp.broadcast_to(box_points, (k,) + box_points.shape)
    masks = jnp.broadcast_to(box_mask, (k,) + box_mask.shape)

    if config.icp_mode == "p2plane":
        if template_normals is None:
            from perception.ops.normals import normals_knn

            template_normals, _ = normals_knn(template, template_mask, k=8)
        fn = functools.partial(
            icp_point_to_plane,
            max_iterations=config.icp_max_iterations,
            transformation_epsilon=1e-12,
        )
        res = jax.vmap(fn, in_axes=(0, 0, None, None, None, 0))(
            sources, masks, template, template_normals, template_mask, inits
        )
    else:
        res = icp_batched(
            sources,
            masks,
            template,
            template_mask,
            init_transforms=inits,
            max_iterations=config.icp_max_iterations,
            transformation_epsilon=1e-9,
        )
    best = jnp.argmin(res.fitness)
    T_best = res.transform[best]
    fitness = res.fitness[best]
    pose = se3.inverse(T_best)
    return pose, fitness, res.converged[best]


def cuboid_pipeline_step(
    points: jax.Array,
    mask: jax.Array,
    template: jax.Array,
    template_mask: jax.Array,
    key: jax.Array,
    config: CuboidConfig = CuboidConfig(),
    template_normals: Optional[jax.Array] = None,
) -> CuboidResult:
    """Full per-frame pipeline on an (N, 3) masked cloud.

    For the fast path, pass a template preprocessed by
    ``template_features`` (and its normals) so the per-frame work only
    touches the downsampled template.
    """
    fit, dpts, box_mask = segment_ground_plane(points, mask, key, config)
    box_pts, box_m = P.compact(dpts, box_mask, config.box_capacity)
    if config.cluster_filter == "cc":
        from perception.ops.cluster import euclidean_cluster

        cl = euclidean_cluster(
            box_pts, box_m, tolerance=config.cluster_tolerance,
            min_size=1, max_size=config.box_capacity, max_clusters=8,
        )
        box_m = box_m & (cl.labels == 0)  # largest cluster (slot 0)
        box_pts = P.apply_mask(box_pts, box_m)
    elif config.cluster_filter == "blob":
        radius = config.blob_radius
        if radius is None:
            radius = 0.5 * float(np.linalg.norm(config.dims)) + 0.02
        box_m = P.dominant_blob_filter(box_pts, box_m, radius=radius)
        box_pts = P.apply_mask(box_pts, box_m)
    pose, fitness, converged = estimate_cuboid_pose(
        box_pts, box_m, template, template_mask, config,
        template_normals=template_normals,
    )
    has_box = jnp.sum(box_m) >= 50
    # PCL's hasConverged() also counts hitting max iterations as
    # converged, so the reference gate (iterative_closest_point.cpp:182)
    # reduces to the fitness threshold; epsilon-convergence stays
    # informational in the result.
    accepted = (fitness < config.fitness_threshold) & fit.valid & has_box
    verts = jnp.asarray(cuboid_vertices(*config.dims))
    bbox = se3.transform_points(pose, verts)
    return CuboidResult(
        pose=pose,
        fitness=fitness,
        accepted=accepted,
        plane=fit.coefficients,
        plane_valid=fit.valid,
        bbox=bbox,
        num_box_points=jnp.sum(box_m, dtype=jnp.int32),
    )


def cuboid_pipeline_from_depth(
    depth: jax.Array,
    camera: PinholeCamera,
    template: jax.Array,
    template_mask: jax.Array,
    key: jax.Array,
    config: CuboidConfig = CuboidConfig(),
    template_normals: Optional[jax.Array] = None,
) -> CuboidResult:
    """Depth image (H, W) -> CuboidResult; the whole thing jits into a
    single XLA computation (the reference's 3 ROS processes collapse
    into one device step)."""
    s = config.depth_stride
    if s > 1:
        # Decimate on the image grid; intrinsics scale with the grid.
        # Offset by s//2 so sample centers stay centered in each block.
        o = s // 2
        depth = depth[o::s, o::s]
        camera = dataclasses.replace(
            camera,
            fx=camera.fx / s, fy=camera.fy / s,
            cx=(camera.cx - o) / s, cy=(camera.cy - o) / s,
            width=depth.shape[1], height=depth.shape[0],
        )
    points, mask = camera.backproject_depth(depth)
    return cuboid_pipeline_step(
        points, mask, template, template_mask, key, config,
        template_normals=template_normals,
    )


def cuboid_pipeline_batch(
    depths: jax.Array,          # (B, H, W)
    camera: PinholeCamera,
    template: jax.Array,
    template_mask: jax.Array,
    keys: jax.Array,            # (B,) PRNG keys
    config: CuboidConfig = CuboidConfig(),
    template_normals: Optional[jax.Array] = None,
) -> CuboidResult:
    """Frame-batched pipeline: vmap over a block of B depth frames.

    The per-frame pipeline is latency-bound (small sorts, 6x6 solves);
    batching frames multiplies every stage's parallel work so the device
    stays fed — the throughput mode for offline replay
    (the streaming analog of the reference's multi-GPU frame round-robin,
    wrapperAuxiliary.hpp:159-286, on one device)."""
    return jax.vmap(
        lambda d, k: cuboid_pipeline_from_depth(
            d, camera, template, template_mask, k, config,
            template_normals=template_normals,
        )
    )(depths, keys)
