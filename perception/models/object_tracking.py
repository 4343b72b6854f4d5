"""Streaming multi-object ICP tracking (BASELINE.json config #2:
"full cuboid_detection bag replay: streaming plane seg + Euclidean
clustering + multi-cuboid ICP tracking").

Reference semantics being matched:
  * ``cuboid_detection/src/iterative_closest_point.cpp:139-147`` — the
    one-shot ICP_SUCCESS latch: once a pose is accepted the node stops
    re-solving and republishes the cached result;
  * ``object_detection/src/object_pose_detection.cpp:249-268`` — the
    cached-winner republish loop over a live cloud stream;
  * acceptance gate ``hasConverged && fitness < icp_fitness_score``
    (``iterative_closest_point.cpp:182``, launch value 0.0004).

Streaming design (one jitted step, fixed capacities):

  depth cloud ─► passthrough ─► voxel ─► RANSAC plane removal ─►
  Euclidean clustering (shared front-end with models/objects.py)
        │
        ▼
  K track slots, each bound to a template: greedy centroid assignment
  of clusters to slots (latched slots keep their nearest cluster within
  ``match_radius``; free slots take what remains), then ONE batched ICP
  over all K x (1 warm + R yaw-restart) alignments — the warm row
  continues a latched track at a fraction of the cold cost, the
  restart fan re-detects lost or new objects. The reference's latch
  becomes a per-slot state machine: latched slots republish their
  cached pose whenever the fresh solve fails the gate, and only fall
  back to re-detection after ``max_misses`` consecutive failures.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from perception.geometry import f32, se3
from perception.models.cuboid import _yaw_restart_inits
from perception.models.objects import ObjectConfig
from perception.ops import points as P
from perception.ops.cluster import euclidean_cluster
from perception.ops.icp import icp_point_to_plane
from perception.ops.normals import normals_knn
from perception.ops.ransac import ransac_plane


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    detection: ObjectConfig = ObjectConfig()
    max_tracks: int = 4
    # Warm-start row budget: a latched track re-converges in a handful
    # of GN iterations; the cold fan keeps the full detection budget.
    warm_icp_iterations: int = 60
    redetect_restarts: int = 4
    fitness_gate: float = 0.0004      # launch icp_fitness_score (:42)
    # Correspondence gate for the tracking ICP solves; num_corr then
    # measures real template overlap. Point-to-plane fitness is blind
    # to in-plane slides (the r3 record's 12 cm p90 tail was latched
    # warm rows gliding along the template faces at gate-passing
    # fitness); a slide sheds overlap, so requiring
    # num_corr/cluster_points >= min_overlap rejects it and row
    # selection falls through to a restart that genuinely covers the
    # cluster (for near-symmetric cuboids that is a symmetry flip —
    # center-correct by construction).
    corr_radius: float = 0.015
    min_overlap: float = 0.8
    # Centroid-consistency gate: the pose's implied template centroid
    # must stay within this of the assigned cluster's centroid. Kills
    # the flip-plus-slide attractors (measured: a latched 180-degree
    # solution offset 10.6 cm, passing both fitness and overlap with
    # the cluster matched onto a different region of the template).
    center_gate: float = 0.04
    max_misses: int = 5               # failures before a latched slot
                                      # re-enters detection
    match_radius: float = 0.15        # centroid assignment radius (m)
    cold_size_gate: float = 0.35      # max |normalized cluster size -
                                      # normalized template size| for a
                                      # cold (re-)detection binding
    # Depth-image decimation before backprojection (the cuboid
    # pipeline's depth_stride): at stride 2 the whole front-end shrinks
    # ~4x with no measurable pose cost at tabletop ranges.
    depth_stride: int = 2


class TrackSlots(NamedTuple):
    pose: jax.Array      # (K, 4, 4) camera <- object (published pose)
    latched: jax.Array   # (K,) bool — ICP_SUCCESS latch
    fitness: jax.Array   # (K,) last accepted fitness
    misses: jax.Array    # (K,) int32 consecutive gate failures
    age: jax.Array       # (K,) int32 frames since latch


class TrackDiag(NamedTuple):
    num_clusters: jax.Array    # () int32
    assigned: jax.Array        # (K,) int32 cluster id per slot (-1 none)
    fresh_fitness: jax.Array   # (K,) this frame's best solve fitness
    used_warm: jax.Array       # (K,) bool — warm row won this frame


def init_tracks(cfg: TrackingConfig = TrackingConfig()) -> TrackSlots:
    K = cfg.max_tracks
    return TrackSlots(
        pose=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (K, 4, 4)),
        latched=jnp.zeros(K, bool),
        fitness=jnp.full(K, jnp.inf, jnp.float32),
        misses=jnp.zeros(K, jnp.int32),
        age=jnp.zeros(K, jnp.int32),
    )


def _front_end(points, mask, key, det: ObjectConfig):
    """Shared streaming front-end: crop -> voxel -> plane removal ->
    clustering. Returns (cluster points (C, cap, 3), masks, centroids,
    sizes, alive, num_clusters, keep_ratio)."""
    C = det.max_clusters
    m = P.passthrough(points, mask, 2, *det.z_limits)
    m = P.passthrough(points, m, 0, *det.x_limits)
    dpts, dm = P.voxel_downsample(points, m, det.voxel_size)
    keep_ratio = jnp.float32(1.0)
    if dpts.shape[0] > det.work_capacity:
        cnt = jnp.sum(dm, dtype=jnp.float32)
        keep_ratio = jnp.minimum(1.0, det.work_capacity / jnp.maximum(cnt, 1.0))
        # voxel_downsample's output is prefix-masked (slot i = i-th
        # occupied voxel) -> the cheap gather-only compaction applies.
        dpts, dm = P.compact_prefix(dpts, dm, det.work_capacity)
    plane = ransac_plane(
        dpts, dm, key, threshold=det.ransac_threshold,
        num_hypotheses=det.ransac_hypotheses,
    )
    off = dm & ~plane.inliers
    off = P.passthrough(dpts, off, 2, 0.0, det.table_z_cut)
    # Cluster only the off-plane survivors at their own (small)
    # capacity — label propagation costs O(capacity) bytes per sweep
    # (ObjectConfig.offplane_capacity).
    opts, om = P.compact(dpts, off, det.offplane_capacity)

    clusters = euclidean_cluster(
        opts, om,
        tolerance=det.cluster_tolerance,
        min_size=det.cluster_min_size,
        max_size=det.cluster_max_size,
        max_clusters=C,
        refine=det.exact_clustering,
    )

    def gather(cid):
        sel = clusters.labels == cid
        order = jnp.argsort(~sel, stable=True)
        idx = order[: det.cluster_capacity]
        cm = sel[idx]
        return P.apply_mask(opts[idx], cm), cm

    cpts, cmasks = jax.vmap(gather)(jnp.arange(C))
    centroids = jax.vmap(P.centroid)(cpts, cmasks)
    alive = clusters.sizes > 0
    return (cpts, cmasks, centroids, clusters.sizes, alive,
            clusters.num_clusters, keep_ratio)


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_step(
    slots: TrackSlots,
    points: jax.Array,
    mask: jax.Array,
    templates: jax.Array,       # (K, Nt, 3) per-slot template cloud
    template_masks: jax.Array,  # (K, Nt)
    key: jax.Array,
    cfg: TrackingConfig = TrackingConfig(),
    template_normals: jax.Array | None = None,  # (K, Nt, 3) precomputed
) -> Tuple[TrackSlots, TrackDiag]:
    """One streaming frame: front-end + assignment + batched warm/cold
    point-to-plane ICP + the latch state machine.

    Point-to-PLANE against the template (not point-to-point): measured
    at 640x480, point-to-point restarts settle into gate-passing minima
    5-16 cm off (a partial template covers the observed surface while
    sticking into free space unpenalized); the plane constraint removes
    those minima (0.1-0.3 cm on the same clusters). Pass
    ``template_normals`` (normals_knn per template) to skip the
    in-graph recompute."""
    det = cfg.detection
    K = cfg.max_tracks
    R = cfg.redetect_restarts
    if template_normals is None:
        template_normals = jax.vmap(
            lambda t, m: normals_knn(t, m, k=8)[0]
        )(templates, template_masks)

    (cpts, cmasks, centroids, csizes, alive, n_clusters, keep_ratio) = (
        _front_end(points, mask, key, det)
    )
    C = cpts.shape[0]

    # Predicted object centroid per slot: the latched pose applied to
    # the template centroid.
    t_cents = jax.vmap(P.centroid)(templates, template_masks)        # (K, 3)
    pred = f32.einsum("kij,kj->ki", slots.pose[:, :3, :3], t_cents) + slots.pose[:, :3, 3]

    # Per-slot template point count at the working resolution. The
    # reference binds clusters to templates by point count
    # (min |cluster - template|, gate 250 — object_pose_detection.cpp:
    # 415-429) against single-view CAPTURED templates; our templates
    # are full 3-face clouds while a cluster is one view, so the
    # comparison is done on max-NORMALIZED sizes (rank/ratio structure
    # is preserved, absolute visible-fraction bias cancels).
    def tmpl_count(t, tm):
        _, dm = P.voxel_downsample(t, tm, det.voxel_size)
        return jnp.sum(dm, dtype=jnp.float32)

    t_sizes = jax.vmap(tmpl_count)(templates, template_masks)        # (K,)
    t_rel = t_sizes / jnp.maximum(jnp.max(t_sizes), 1.0)
    c_rel = csizes.astype(jnp.float32) / jnp.maximum(
        jnp.max(jnp.where(alive, csizes, 0)).astype(jnp.float32), 1.0
    )

    # Greedy assignment, slot-major (K is small and static). Latched
    # slots track their nearest cluster within match_radius; free slots
    # cold-detect the remaining cluster whose normalized size best
    # matches their template's, gated at cold_size_gate.
    taken = jnp.zeros(C, bool)
    assigned = []
    for k in range(K):
        d = jnp.linalg.norm(pred[k][None] - centroids, axis=-1)      # (C,)
        d = jnp.where(alive & ~taken, d, jnp.inf)
        sdiff = jnp.abs(c_rel - t_rel[k])
        sdiff = jnp.where(alive & ~taken, sdiff, jnp.inf)
        track_live = slots.latched[k] & (slots.misses[k] <= cfg.max_misses)
        cost = jnp.where(track_live, d, sdiff)
        j = jnp.argmin(cost)
        ok = jnp.where(
            track_live,
            d[j] <= cfg.match_radius,
            sdiff[j] < cfg.cold_size_gate,
        )
        assigned.append(jnp.where(ok, j, -1).astype(jnp.int32))
        taken = taken.at[j].set(taken[j] | ok)
    assigned = jnp.stack(assigned)                                   # (K,)

    a_idx = jnp.maximum(assigned, 0)
    src = cpts[a_idx]                                                # (K, cap, 3)
    srcm = cmasks[a_idx] & (assigned >= 0)[:, None]

    # Init fan per slot (ICP solves cluster -> template, so inits are
    # pose inverses):
    #   row 0 — RE-CENTERED warm start: the latched rotation with the
    #     translation snapped so the assigned cluster's centroid maps
    #     onto the template centroid. A flat cuboid's fitness valley is
    #     nearly flat along in-plane slide (measured: 7 cm of drift at
    #     gate-passing fitness while the camera swept); plain warm
    #     continuation lags inside that valley, while re-centering each
    #     frame pins the track to the observed blob without risking a
    #     rotation flip;
    #   row 1 — plain warm continuation (recovers when the centroid is
    #     biased, e.g. half-occluded clusters);
    #   rows 2..R+1 — yaw restarts about the cluster centroid
    #     (re-detection fan).
    warm = se3.inverse(slots.pose)                                   # (K, 4, 4)
    c_assigned = centroids[a_idx]
    recenter_t = t_cents - f32.einsum(
        "kij,kj->ki", warm[:, :3, :3], c_assigned
    )
    warm_centered = jax.vmap(se3.make_T)(warm[:, :3, :3], recenter_t)
    cold = jax.vmap(
        lambda c, t: _yaw_restart_inits(c, t, R, points.dtype)
    )(c_assigned, t_cents)                                           # (K, R, 4, 4)
    inits = jnp.concatenate(
        [warm_centered[:, None], warm[:, None], cold], axis=1
    )                                                                # (K, R+2, 4, 4)
    n_rows = R + 2

    import functools

    p2pl = functools.partial(
        icp_point_to_plane,
        max_iterations=cfg.warm_icp_iterations,
        transformation_epsilon=1e-12,
        max_correspondence_distance=cfg.corr_radius,
    )

    def per_slot(s, sm, tmpl, tn, tmplm, init):
        return jax.vmap(p2pl, in_axes=(None, None, None, None, None, 0))(
            s, sm, tmpl, tn, tmplm, init
        )

    # Steady state (every slot latched with NO recent miss) runs ONLY
    # the two warm rows per slot; the yaw-restart fan solves are the
    # step's dominant cost and only matter on acquisition or loss.
    # A single miss re-arms the fan on the very next frame — waiting
    # for the max_misses unlatch instead leaves the published pose
    # stale for up to that many frames (measured +0.6 cm median on the
    # tracking sweep). lax.cond keeps the branch off the common path;
    # the skipped rows report inf fitness so selection/gating below
    # are unchanged.
    steady = jnp.all(slots.latched & (slots.misses == 0))

    def _solve_full(_):
        return jax.vmap(per_slot)(
            src, srcm, templates, template_normals, template_masks, inits
        )

    def _solve_warm(_):
        rw = jax.vmap(per_slot)(
            src, srcm, templates, template_normals, template_masks,
            inits[:, :2],
        )
        pad = n_rows - 2
        return type(rw)(
            transform=jnp.concatenate(
                [rw.transform,
                 jnp.broadcast_to(jnp.eye(4, dtype=rw.transform.dtype),
                                  (K, pad, 4, 4))], axis=1),
            fitness=jnp.concatenate(
                [rw.fitness, jnp.full((K, pad), jnp.inf, rw.fitness.dtype)],
                axis=1),
            num_corr=jnp.concatenate(
                [rw.num_corr, jnp.zeros((K, pad), rw.num_corr.dtype)], axis=1),
            iterations=jnp.concatenate(
                [rw.iterations, jnp.zeros((K, pad), rw.iterations.dtype)],
                axis=1),
            converged=jnp.concatenate(
                [rw.converged, jnp.zeros((K, pad), bool)], axis=1),
        )

    res = jax.lax.cond(steady, _solve_warm, _solve_full, None)
    fit = res.fitness                                                # (K, R+2)
    fit = jnp.where((assigned >= 0)[:, None], fit, jnp.inf)
    # Overlap per row: gated correspondences over live cluster points.
    n_src = jnp.sum(srcm, axis=1).astype(jnp.float32)                # (K,)
    ovl = res.num_corr.astype(jnp.float32) / jnp.maximum(n_src, 1.0)[:, None]
    # Implied template centroid per row vs the assigned cluster's.
    pose_rows = se3.inverse(res.transform.reshape(-1, 4, 4)).reshape(
        K, n_rows, 4, 4
    )
    pred_c = (
        f32.einsum("krij,kj->kri", pose_rows[:, :, :3, :3], t_cents)
        + pose_rows[:, :, :3, 3]
    )                                                                # (K, R+2, 3)
    cdist = jnp.linalg.norm(pred_c - c_assigned[:, None, :], axis=-1)
    row_pass = (
        (fit < cfg.fitness_gate)
        & (ovl >= cfg.min_overlap)
        & (cdist <= cfg.center_gate)
        & (assigned >= 0)[:, None]
    )
    # Row selection: a latched slot whose (re-centered) warm
    # continuation passes BOTH gates KEEPS it, even when a cold restart
    # scores marginally better — near-symmetric objects (a cuboid under
    # a 3-face template) have several gate-passing minima, and argmin
    # alone makes the published pose flip between them frame to frame.
    warm_ok = slots.latched & row_pass[:, 0]
    fit_pass = jnp.where(row_pass, fit, jnp.inf)
    any_pass = jnp.any(row_pass, axis=1)
    best = jnp.where(
        warm_ok, 0,
        jnp.where(any_pass, jnp.argmin(fit_pass, axis=1),
                  jnp.argmin(fit, axis=1)),
    )                                                                # (K,)
    best_fit = jnp.take_along_axis(fit, best[:, None], axis=1)[:, 0]
    best_T = jnp.take_along_axis(
        res.transform, best[:, None, None, None] * jnp.ones((K, 1, 4, 4), jnp.int32),
        axis=1,
    )[:, 0]
    fresh_pose = se3.inverse(best_T)                                 # camera <- object

    # Latch state machine (reference :139-147 + re-detect extension):
    #   pass  -> latch/update pose, clear misses;
    #   fail while latched -> keep cached pose, count a miss;
    #   fail too long / never latched -> slot stays open.
    passed = any_pass
    new_pose = jnp.where(passed[:, None, None], fresh_pose, slots.pose)
    new_latched = slots.latched | passed
    new_misses = jnp.where(passed, 0, slots.misses + slots.latched.astype(jnp.int32))
    # A slot that overruns max_misses un-latches (re-enters detection).
    lost = new_misses > cfg.max_misses
    new_latched = new_latched & ~lost
    new_fitness = jnp.where(passed, best_fit, slots.fitness)
    new_age = jnp.where(new_latched, slots.age + 1, 0)

    diag = TrackDiag(
        num_clusters=n_clusters,
        assigned=assigned,
        fresh_fitness=best_fit,
        used_warm=(best == 0) & passed,
    )
    return TrackSlots(
        pose=new_pose,
        latched=new_latched,
        fitness=new_fitness,
        misses=new_misses,
        age=new_age,
    ), diag


def track_step_from_depth(
    slots: TrackSlots,
    depth: jax.Array,
    camera,
    templates: jax.Array,
    template_masks: jax.Array,
    key: jax.Array,
    cfg: TrackingConfig = TrackingConfig(),
    template_normals: jax.Array | None = None,
) -> Tuple[TrackSlots, TrackDiag]:
    """Streaming entry point from a raw depth image (the bag-replay
    topology: /camera/depth/color/points -> plane seg -> ICP nodes)."""
    st = cfg.depth_stride
    if st > 1:
        o = st // 2
        depth = depth[o::st, o::st]
        camera = dataclasses.replace(
            camera, fx=camera.fx / st, fy=camera.fy / st,
            cx=(camera.cx - o) / st, cy=(camera.cy - o) / st,
            width=depth.shape[1], height=depth.shape[0],
        )
    pts, valid = camera.backproject_depth(depth, min_depth=0.05, max_depth=5.0)
    return track_step(slots, pts, valid, templates, template_masks, key, cfg,
                      template_normals=template_normals)
