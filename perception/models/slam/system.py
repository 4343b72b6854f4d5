"""Full keyframe SLAM system: dense odometry + landmark tracks + local
BA + sparse loop closure + pose-graph correction (BASELINE.json
config #4: "ORB detect+match + PnP + local BA keyframe SLAM").

Architecture (all state on-device, fixed capacities, one jitted step):

  depth, gray ──► odometry_step (dense point-to-plane GN vs current
                  keyframe — models/slam/odometry.py)
        │ promoted?
        ▼
  KeyframeStore: poses, FAST/BRIEF keypoints with pixel coords, 3-D
  backprojections, and per-feature landmark ids; ring-buffer slots
  masked by validity
        │ on promotion
        ▼
  landmark tracks: the new keyframe's descriptors are matched against
  the current keyframe's; matches extend existing landmark tracks or
  allocate new landmarks (fixed-capacity ring + cumsum id assignment),
  and 3D-2D observations are appended to a fixed-capacity ring
        │
        ▼
  sliding-window local BA (lax.cond): Schur-complement bundle_adjust
  over the last `ba_window` keyframes and the landmarks they observe
  (models/slam/backend.py) — poses and landmarks written back, the
  live odometry pose shifted by the newest keyframe's correction
        │
        ▼
  loop-closure probe: batched Hamming match against all stored
  keyframes, RANSAC rigid 3D-3D verification, then reprojection PnP
  refinement of the closure transform (ops/pnp.py); a verified closure
  appends a pose-graph edge
        │
        ▼
  pose-graph GN over keyframe poses (models/slam/backend.py) under
  lax.cond on closure frames; landmark positions ride along via their
  anchor keyframe's correction.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from perception.geometry import f32, se3
from perception.geometry.camera import PinholeCamera
from perception.models.slam.backend import (
    BAProblem,
    PoseGraph,
    bundle_adjust,
    optimize_pose_graph,
)
from perception.models.slam.odometry import (
    OdometryConfig,
    OdometryState,
    init_state as odom_init,
    odometry_step,
)
from perception.ops.features import (
    brief_describe,
    fast_detect,
    match_descriptors,
)
from perception.ops.pnp import pnp_gn
from perception.ops.registration import ransac_rigid


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    odometry: OdometryConfig = OdometryConfig()
    max_keyframes: int = 64
    max_edges: int = 160
    features_per_kf: int = 256
    fast_threshold: float = 25.0
    # Loop closure gates
    lc_min_gap: int = 3              # skip adjacent keyframes
    lc_min_matches: int = 25
    lc_ransac_threshold: float = 0.05
    lc_min_inliers: int = 12
    # Reprojection-PnP refinement of the verified closure transform
    # (pixel noise beats depth noise at range — ops/pnp.py).
    lc_pnp_refine: bool = True
    lc_pnp_max_px: float = 8.0       # reject the refinement if its robust
                                     # mean pixel error exceeds this
    # Trust region around the rigid init: reprojection cost is nearly
    # flat along the depth axis for narrow-baseline planar-ish match
    # sets (measured: 24 inliers let PnP wander 0.18 m off a correct
    # rigid fit at 0.3 px mean error), so the refinement is accepted
    # only as a polish, never as a large move.
    lc_pnp_max_dev_m: float = 0.03
    lc_pnp_max_dev_rad: float = 0.05
    # Pose-graph correction fused into slam_step under lax.cond: the
    # graph GN runs on-device only on closure frames, and the host loop
    # never has to sync on loop_found.
    correct_in_step: bool = True
    pg_iterations: int = 10
    # --- sliding-window local BA (config #4's "local BA") -------------
    enable_ba: bool = True
    ba_window: int = 5               # keyframes in the window
    max_landmarks: int = 1024        # landmark ring capacity
    max_observations: int = 4096     # observation ring capacity
    ba_iterations: int = 4
    ba_min_obs: int = 24             # window observations needed to fire
    ba_huber_px: float = 4.0
    ba_damping: float = 1e-3
    # Depth-residual strength relative to the fx/z px-per-m scale. A
    # pure-reprojection window is scale-gauge-free (backend.BAProblem
    # docstring); 1.0 trusts depth as much as pixels at equal range.
    ba_depth_weight: float = 1.0
    # 3-D agreement gate on track extension: a descriptor match only
    # becomes a BA observation if the two keypoints' backprojections
    # coincide (in world, through the odometry poses) within this
    # radius — descriptor-only matching on repetitive texture leaks
    # outliers that Huber downweights but does not kill.
    track_gate_m: float = 0.05


class KeyframeStore(NamedTuple):
    poses: jax.Array       # (K, 4, 4) world <- kf camera
    desc: jax.Array        # (K, F, 8) uint32 BRIEF
    kp_uv: jax.Array       # (K, F, 2) keypoint pixel coords
    kp_xyz: jax.Array      # (K, F, 3) keypoint 3-D points, kf camera frame
    kp_mask: jax.Array     # (K, F) depth-valid keypoints
    lm_id: jax.Array       # (K, F) int32 landmark id per feature (-1 none)
    valid: jax.Array       # (K,)
    stamp: jax.Array       # (K,) int32 insertion sequence number (-1 = never)
    count: jax.Array       # () int32 total insertions (ring write head = count % K)


class LandmarkTable(NamedTuple):
    xyz: jax.Array       # (L, 3) world positions
    anchor: jax.Array    # (L,) int32 keyframe slot of the first observation
                         # (pose-graph corrections ride through this)
    mask: jax.Array      # (L,)
    count: jax.Array     # () int32 ring write head


class ObsTable(NamedTuple):
    kf: jax.Array        # (O,) int32 keyframe slot
    lm: jax.Array        # (O,) int32 landmark id
    uv: jax.Array        # (O, 2) measured pixels
    z: jax.Array         # (O,) measured depth (m; 0 = no depth)
    zw: jax.Array        # (O,) depth-residual weight (px/m; 0 = uv-only)
    mask: jax.Array      # (O,)
    count: jax.Array     # () int32 ring write head


class EdgeList(NamedTuple):
    i: jax.Array          # (E,)
    j: jax.Array          # (E,)
    T: jax.Array          # (E, 4, 4)
    weight: jax.Array     # (E,)
    mask: jax.Array       # (E,)
    count: jax.Array      # ()


class SlamState(NamedTuple):
    odom: OdometryState
    keyframes: KeyframeStore
    landmarks: LandmarkTable
    obs: ObsTable
    edges: EdgeList
    current_kf: jax.Array     # () int32 index of the active keyframe
    loop_found: jax.Array     # () bool — a closure was added this step


class SlamDiag(NamedTuple):
    promoted: jax.Array
    loop_candidate: jax.Array  # () int32 candidate kf (-1 none)
    loop_matches: jax.Array
    loop_inliers: jax.Array
    overlap: jax.Array
    ba_ran: jax.Array          # () bool — local BA fired this step
    ba_cost0: jax.Array        # () mean sq reprojection error before (px^2)
    ba_cost1: jax.Array        # () after


def _kf_features(camera: PinholeCamera, depth, gray, cfg: SlamConfig):
    """Sparse features of a frame for the loop-closure/BA store:
    (descriptors, pixel uv, camera-frame xyz, depth-valid mask)."""
    kps = fast_detect(
        gray, threshold=cfg.fast_threshold, max_keypoints=cfg.features_per_kf
    )
    desc = brief_describe(gray, kps)
    # Backproject keypoints with the depth image (nearest-pixel depth,
    # but the ray through the SUB-PIXEL uv — keeps the 3-D point and
    # the BA reprojection residual consistent to < the corner's
    # localization error).
    u = jnp.clip(jnp.round(kps.uv[:, 0]).astype(jnp.int32), 0, camera.width - 1)
    v = jnp.clip(jnp.round(kps.uv[:, 1]).astype(jnp.int32), 0, camera.height - 1)
    z = depth[v, u]
    ok = kps.mask & jnp.isfinite(z) & (z > 0.1)
    z = jnp.where(ok, z, 0.0)
    x = (kps.uv[:, 0] - camera.cx) / camera.fx * z
    y = (kps.uv[:, 1] - camera.cy) / camera.fy * z
    return desc, kps.uv, jnp.stack([x, y, z], axis=-1), ok


def slam_init(
    camera: PinholeCamera, depth0, gray0, cfg: SlamConfig = SlamConfig()
) -> SlamState:
    odom = odom_init(camera, depth0, cfg.odometry)
    K, F, E = cfg.max_keyframes, cfg.features_per_kf, cfg.max_edges
    L, O = cfg.max_landmarks, cfg.max_observations
    # One promotion appends at most 2F observations; ring positions must
    # be unique within a single step's write.
    assert 2 * F <= O, "max_observations must be >= 2 * features_per_kf"
    desc0, uv0, xyz0, m0 = _kf_features(camera, depth0, gray0, cfg)

    kf = KeyframeStore(
        poses=jnp.broadcast_to(jnp.eye(4), (K, 4, 4)).at[0].set(jnp.eye(4)),
        desc=jnp.zeros((K, F, 8), jnp.uint32).at[0].set(desc0),
        kp_uv=jnp.zeros((K, F, 2)).at[0].set(uv0),
        kp_xyz=jnp.zeros((K, F, 3)).at[0].set(xyz0),
        kp_mask=jnp.zeros((K, F), bool).at[0].set(m0),
        lm_id=jnp.full((K, F), -1, jnp.int32),
        valid=jnp.zeros(K, bool).at[0].set(True),
        stamp=jnp.full(K, -1, jnp.int32).at[0].set(0),
        count=jnp.int32(1),
    )
    landmarks = LandmarkTable(
        xyz=jnp.zeros((L, 3), jnp.float32),
        anchor=jnp.zeros(L, jnp.int32),
        mask=jnp.zeros(L, bool),
        count=jnp.int32(0),
    )
    obs = ObsTable(
        kf=jnp.zeros(O, jnp.int32),
        lm=jnp.zeros(O, jnp.int32),
        uv=jnp.zeros((O, 2), jnp.float32),
        z=jnp.zeros(O, jnp.float32),
        zw=jnp.zeros(O, jnp.float32),
        mask=jnp.zeros(O, bool),
        count=jnp.int32(0),
    )
    edges = EdgeList(
        i=jnp.zeros(E, jnp.int32),
        j=jnp.zeros(E, jnp.int32),
        T=jnp.broadcast_to(jnp.eye(4), (E, 4, 4)),
        weight=jnp.zeros(E),
        mask=jnp.zeros(E, bool),
        count=jnp.int32(0),
    )
    return SlamState(
        odom=odom, keyframes=kf, landmarks=landmarks, obs=obs, edges=edges,
        current_kf=jnp.int32(0), loop_found=jnp.bool_(False),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def slam_step(
    state: SlamState,
    depth: jax.Array,
    gray: jax.Array,
    camera: PinholeCamera,
    key: jax.Array,
    cfg: SlamConfig = SlamConfig(),
) -> Tuple[SlamState, SlamDiag]:
    odom, odiag = odometry_step(state.odom, depth, camera, cfg.odometry)
    kf = state.keyframes
    edges = state.edges
    cur = state.current_kf

    promoted = odiag.promoted
    # Ring buffer: the write head wraps and evicts the oldest keyframe
    # once the store is full (round-1 saturation overwrote the *last*
    # slot forever — VERDICT r1 item 7).
    slot = kf.count % cfg.max_keyframes
    evict = promoted & (kf.count >= cfg.max_keyframes)

    # --- promotion-only work, skipped at runtime on ordinary frames ----
    # Feature extraction, the K x F x F descriptor match, and RANSAC
    # verification only matter when a keyframe is promoted (~10% of
    # frames); lax.cond executes just one branch, so tracking frames pay
    # only the odometry cost. (Matching runs against the pre-insertion
    # store; the new slot and the current keyframe are excluded from
    # loop-closure eligibility, while the current keyframe's row feeds
    # landmark track maintenance.)
    F = cfg.features_per_kf

    def _probe_branch(_):
        desc, uv, xyz, kpm = _kf_features(camera, depth, gray, cfg)

        def match_one(d_other, m_other):
            m = match_descriptors(desc, kpm, d_other, m_other, max_matches=F)
            return m.idx_a, m.idx_b, m.mask

        ia, ib, mm = jax.vmap(match_one)(kf.desc, kf.kp_mask)  # (K, F)
        match_counts = jnp.sum(mm, axis=1, dtype=jnp.int32)
        kf_idx = jnp.arange(cfg.max_keyframes)
        # Temporal adjacency via insertion stamps, not slot indices —
        # the ring wraps. The new keyframe's stamp is kf.count.
        eligible = (
            kf.valid
            & (kf.stamp >= 0)
            & (kf.count - kf.stamp >= cfg.lc_min_gap)
            & (kf_idx != slot)
            & (kf_idx != cur)
        )
        match_counts_lc = jnp.where(eligible, match_counts, -1)
        cand = jnp.argmax(match_counts_lc)
        cand_matches = match_counts_lc[cand]

        # Geometric verification: rigid 3D-3D between matched keypoints.
        src = xyz[ia[cand]]
        dst = kf.kp_xyz[cand][ib[cand]]
        pair_mask = mm[cand] & kpm[ia[cand]] & kf.kp_mask[cand][ib[cand]]
        fit = ransac_rigid(
            src, dst, pair_mask, key,
            threshold=cfg.lc_ransac_threshold,
            num_hypotheses=128,
            min_inliers=cfg.lc_min_inliers,
        )
        fit_T = fit.transform
        if cfg.lc_pnp_refine:
            # Polish by reprojection into the candidate keyframe: the
            # rigid fit initializes, pixels constrain (config #4's PnP).
            uv_cand = kf.kp_uv[cand][ib[cand]]
            pnp = pnp_gn(
                src, uv_cand, fit.inliers & pair_mask,
                camera.fx, camera.fy, camera.cx, camera.cy,
                T_init=fit.transform, iterations=6,
            )
            dev = se3.se3_log(f32.matmul(se3.inverse(fit.transform), pnp.transform))
            use = (
                fit.valid
                & (pnp.mean_px_error <= cfg.lc_pnp_max_px)
                & (jnp.linalg.norm(dev[:3]) <= cfg.lc_pnp_max_dev_m)
                & (jnp.linalg.norm(dev[3:]) <= cfg.lc_pnp_max_dev_rad)
            )
            fit_T = jnp.where(use, pnp.transform, fit.transform)
        return (desc, uv, xyz, kpm, cand.astype(jnp.int32), cand_matches,
                fit_T, fit.num_inliers, fit.valid,
                ia[cur], ib[cur], mm[cur])

    def _skip_branch(_):
        return (
            jnp.zeros((F, 8), jnp.uint32),
            jnp.zeros((F, 2), jnp.float32),
            jnp.zeros((F, 3), jnp.float32),
            jnp.zeros((F,), bool),
            jnp.int32(0),
            jnp.int32(-1),
            jnp.eye(4, dtype=kf.poses.dtype),
            jnp.int32(0),
            jnp.bool_(False),
            jnp.zeros((F,), jnp.int32),
            jnp.zeros((F,), jnp.int32),
            jnp.zeros((F,), bool),
        )

    (desc, uv_new, xyz, kpm, cand, cand_matches, fit_T, fit_inliers,
     fit_valid, ia_cur, ib_cur, mm_cur) = (
        jax.lax.cond(promoted, _probe_branch, _skip_branch, None)
    )

    # --- landmark track maintenance (masked by `promoted`) -------------
    # Matches new-kf feature ia_cur[t] <-> current-kf feature ib_cur[t].
    # A match whose current-kf feature already carries a landmark id
    # extends that track; otherwise a new landmark is allocated from the
    # current keyframe's depth (cumsum id assignment keeps this one
    # masked scatter, no host loop).
    L, O = cfg.max_landmarks, cfg.max_observations
    lm = state.landmarks
    obs = state.obs

    # Eviction staleness: the recycled keyframe slot invalidates its
    # observations and any landmark anchored there (the anchor drives
    # pose-graph ride-along corrections; a recycled anchor would apply
    # another keyframe's correction).
    lm_mask0 = lm.mask & ~(evict & (lm.anchor == slot))
    obs_mask0 = obs.mask & ~(evict & (obs.kf == slot))

    i_new = ia_cur            # (F,) new-kf feature index (a permutation)
    j_cur = ib_cur            # (F,) current-kf feature index
    # Geometric verification of each match: both endpoints need valid
    # depth, and their world-frame backprojections (new point through
    # the fresh odometry pose, stored point through its keyframe pose)
    # must agree within track_gate_m.
    x_new_w = se3.transform_points(odom.pose, xyz[i_new])
    x_cur_w0 = se3.transform_points(kf.poses[cur], kf.kp_xyz[cur][j_cur])
    agree3d = (
        kpm[i_new]
        & kf.kp_mask[cur][j_cur]
        & (jnp.linalg.norm(x_new_w - x_cur_w0, axis=-1) <= cfg.track_gate_m)
    )
    matched = mm_cur & promoted & agree3d
    existing = kf.lm_id[cur][j_cur]                      # (F,)
    has_lm = matched & (existing >= 0) & lm_mask0[jnp.clip(existing, 0, L - 1)]
    need_new = matched & ~has_lm & kf.kp_mask[cur][j_cur]
    new_ofs = jnp.cumsum(need_new.astype(jnp.int32)) - 1
    new_id = (lm.count + new_ofs) % L
    n_new = jnp.sum(need_new, dtype=jnp.int32)

    # Landmark-ring reallocation: observations referencing a recycled id
    # belong to the landmark that used to live there.
    realloc = ((obs.lm - lm.count) % L) < n_new
    obs_mask0 = obs_mask0 & ~realloc

    lm_id_match = jnp.where(has_lm, existing, jnp.where(need_new, new_id, -1))

    # New landmark world positions from the current keyframe's depth.
    xyz_cur_w = se3.transform_points(kf.poses[cur], kf.kp_xyz[cur][j_cur])
    widx = jnp.where(need_new, new_id, L)  # mode="drop" routes invalid away
    landmarks2 = LandmarkTable(
        xyz=lm.xyz.at[widx].set(xyz_cur_w, mode="drop"),
        anchor=lm.anchor.at[widx].set(cur.astype(jnp.int32), mode="drop"),
        mask=lm_mask0.at[widx].set(True, mode="drop"),
        count=lm.count + n_new,
    )

    # Landmark ids for the new keyframe's feature slots (i_new is a
    # permutation of 0..F-1, so this scatter writes each slot once).
    lm_col = jnp.zeros((F,), jnp.int32).at[i_new].set(
        jnp.where(matched, lm_id_match, -1)
    )

    # Observation ring append: up to F obs at the new keyframe (every
    # live match) + F at the current keyframe (newly created landmarks
    # only — extended tracks already recorded cur when they began).
    obs_kf_c = jnp.concatenate([
        jnp.full((F,), 0, jnp.int32) + slot.astype(jnp.int32),
        jnp.full((F,), 0, jnp.int32) + cur.astype(jnp.int32),
    ])
    obs_lm_c = jnp.concatenate([
        jnp.maximum(lm_id_match, 0),
        jnp.where(need_new, new_id, 0),
    ])
    obs_uv_c = jnp.concatenate([uv_new[i_new], kf.kp_uv[cur][j_cur]], axis=0)
    obs_m_c = jnp.concatenate([matched & (lm_id_match >= 0), need_new])
    # Measured depth per observation (0-weight when the keypoint has no
    # valid depth — the obs then constrains only by reprojection).
    z_new = xyz[i_new][:, 2]
    z_cur = kf.kp_xyz[cur][j_cur][:, 2]
    zval = jnp.concatenate([kpm[i_new], kf.kp_mask[cur][j_cur]])
    obs_z_c = jnp.concatenate([z_new, z_cur])
    obs_zw_c = jnp.where(
        zval & (obs_z_c > 0.1),
        cfg.ba_depth_weight * camera.fx / jnp.maximum(obs_z_c, 0.1),
        0.0,
    )
    # Compact valid entries to the front so they take consecutive ring
    # positions; invalid writes are dropped.
    order = jnp.argsort(~obs_m_c)
    obs_kf_c, obs_lm_c, obs_uv_c, obs_z_c, obs_zw_c, obs_m_c = (
        obs_kf_c[order], obs_lm_c[order], obs_uv_c[order],
        obs_z_c[order], obs_zw_c[order], obs_m_c[order]
    )
    pos = (obs.count + jnp.arange(2 * F)) % O
    oidx = jnp.where(obs_m_c, pos, O)
    obs2 = ObsTable(
        kf=obs.kf.at[oidx].set(obs_kf_c, mode="drop"),
        lm=obs.lm.at[oidx].set(obs_lm_c, mode="drop"),
        uv=obs.uv.at[oidx].set(obs_uv_c, mode="drop"),
        z=obs.z.at[oidx].set(obs_z_c, mode="drop"),
        zw=obs.zw.at[oidx].set(obs_zw_c, mode="drop"),
        mask=obs_mask0.at[oidx].set(True, mode="drop"),
        count=obs.count + jnp.sum(obs_m_c, dtype=jnp.int32),
    )

    # --- keyframe insertion (masked write at `slot`) -------------------
    kf2 = KeyframeStore(
        poses=kf.poses.at[slot].set(jnp.where(promoted, odom.pose, kf.poses[slot])),
        desc=kf.desc.at[slot].set(jnp.where(promoted, desc, kf.desc[slot])),
        kp_uv=kf.kp_uv.at[slot].set(jnp.where(promoted, uv_new, kf.kp_uv[slot])),
        kp_xyz=kf.kp_xyz.at[slot].set(jnp.where(promoted, xyz, kf.kp_xyz[slot])),
        kp_mask=kf.kp_mask.at[slot].set(jnp.where(promoted, kpm, kf.kp_mask[slot])),
        lm_id=kf.lm_id.at[slot].set(jnp.where(promoted, lm_col, kf.lm_id[slot])),
        valid=kf.valid.at[slot].set(jnp.where(promoted, True, kf.valid[slot])),
        stamp=kf.stamp.at[slot].set(jnp.where(promoted, kf.count, kf.stamp[slot])),
        count=kf.count + promoted.astype(jnp.int32),
    )

    # Eviction invalidates every edge that references the recycled slot
    # (its endpoints now describe a different keyframe).
    stale = evict & ((edges.i == slot) | (edges.j == slot))
    edges = edges._replace(mask=edges.mask & ~stale)

    # --- odometry edge cur -> slot on promotion (edge ring) ------------
    e_slot = edges.count % cfg.max_edges
    T_rel = f32.matmul(se3.inverse(kf.poses[cur]), odom.pose)
    edges2 = EdgeList(
        i=edges.i.at[e_slot].set(jnp.where(promoted, cur, edges.i[e_slot])),
        j=edges.j.at[e_slot].set(jnp.where(promoted, slot, edges.j[e_slot])),
        T=edges.T.at[e_slot].set(jnp.where(promoted, T_rel, edges.T[e_slot])),
        weight=edges.weight.at[e_slot].set(jnp.where(promoted, 1.0, edges.weight[e_slot])),
        mask=edges.mask.at[e_slot].set(jnp.where(promoted, True, edges.mask[e_slot])),
        count=edges.count + promoted.astype(jnp.int32),
    )

    # --- loop closure decision (probe results from the cond above) -----
    probe = promoted & (cand_matches >= cfg.lc_min_matches)
    loop_ok = probe & fit_valid

    e2 = edges2.count % cfg.max_edges
    edges3 = EdgeList(
        i=edges2.i.at[e2].set(jnp.where(loop_ok, cand, edges2.i[e2])),
        j=edges2.j.at[e2].set(jnp.where(loop_ok, slot, edges2.j[e2])),
        # fit maps new-kf points into candidate frame: T_cand_new.
        T=edges2.T.at[e2].set(jnp.where(loop_ok, fit_T, edges2.T[e2])),
        weight=edges2.weight.at[e2].set(jnp.where(loop_ok, 2.0, edges2.weight[e2])),
        mask=edges2.mask.at[e2].set(jnp.where(loop_ok, True, edges2.mask[e2])),
        count=edges2.count + loop_ok.astype(jnp.int32),
    )

    new_state = SlamState(
        odom=odom,
        keyframes=kf2,
        landmarks=landmarks2,
        obs=obs2,
        edges=edges3,
        current_kf=jnp.where(promoted, slot, cur),
        loop_found=loop_ok,
    )
    if cfg.correct_in_step:
        new_state = jax.lax.cond(
            loop_ok,
            lambda s: correct_with_pose_graph(s, iterations=cfg.pg_iterations),
            lambda s: s,
            new_state,
        )

    # --- sliding-window local BA (lax.cond on promotion) ---------------
    ba_ran = jnp.bool_(False)
    ba_c0 = jnp.float32(0.0)
    ba_c1 = jnp.float32(0.0)
    if cfg.enable_ba:
        new_state, ba_ran, ba_c0, ba_c1 = _maybe_bundle_adjust(
            new_state, camera, promoted, cfg
        )

    diag = SlamDiag(
        promoted=promoted,
        loop_candidate=jnp.where(probe, cand, -1).astype(jnp.int32),
        loop_matches=cand_matches,
        loop_inliers=fit_inliers,
        overlap=odiag.overlap,
        ba_ran=ba_ran,
        ba_cost0=ba_c0,
        ba_cost1=ba_c1,
    )
    return new_state, diag


def _maybe_bundle_adjust(
    state: SlamState, camera: PinholeCamera, promoted, cfg: SlamConfig
):
    """Sliding-window BA over the last `ba_window` keyframes, fused into
    slam_step under lax.cond (fires only on promotions with enough
    window observations — ordinary tracking frames pay nothing)."""
    K = cfg.max_keyframes
    W = min(cfg.ba_window, cfg.max_keyframes)
    kf = state.keyframes
    lm = state.landmarks
    obs = state.obs

    # Window = the W most recent valid keyframes, oldest valid FIRST
    # (the gauge freeze in bundle_adjust pins window pose 0 — it must be
    # a real keyframe, so invalid slots sort to the back, not the front).
    stamps = jnp.where(kf.valid, kf.stamp, -1)
    top_stamp, win_slots = jax.lax.top_k(stamps, W)
    order = jnp.argsort(jnp.where(top_stamp >= 0, top_stamp, jnp.int32(2**30)))
    win_slots = win_slots[order].astype(jnp.int32)
    win_valid = top_stamp[order] >= 0
    win_of_slot = jnp.full((K,), -1, jnp.int32).at[
        jnp.where(win_valid, win_slots, K)
    ].set(jnp.arange(W, dtype=jnp.int32), mode="drop")

    wp = win_of_slot[jnp.clip(obs.kf, 0, K - 1)]
    m_obs = obs.mask & (wp >= 0) & lm.mask[jnp.clip(obs.lm, 0, cfg.max_landmarks - 1)]
    n_win_obs = jnp.sum(m_obs, dtype=jnp.int32)
    do_ba = (
        promoted
        & (jnp.sum(win_valid, dtype=jnp.int32) >= 2)
        & (n_win_obs >= cfg.ba_min_obs)
    )

    def _run(_):
        problem = BAProblem(
            poses_wc=kf.poses[win_slots],
            landmarks=lm.xyz,
            obs_pose=jnp.maximum(wp, 0),
            obs_lm=jnp.clip(obs.lm, 0, cfg.max_landmarks - 1),
            obs_uv=obs.uv,
            obs_mask=m_obs,
            obs_z=obs.z,
            obs_zw=jnp.where(m_obs, obs.zw, 0.0),
        )
        res = bundle_adjust(
            problem, camera.fx, camera.fy, camera.cx, camera.cy,
            iterations=cfg.ba_iterations,
            damping=cfg.ba_damping,
            huber_px=cfg.ba_huber_px,
        )
        opt = se3.orthonormalize_T(res.poses_wc)

        new_poses = kf.poses.at[jnp.where(win_valid, win_slots, K)].set(
            opt, mode="drop"
        )
        # Live pose rides the newest window keyframe's correction (on a
        # promotion frame that keyframe IS the current pose).
        pos_new = win_of_slot[state.current_kf]
        newest_ok = pos_new >= 0
        old_T = kf.poses[state.current_kf]
        corr = jnp.where(
            newest_ok,
            f32.matmul(opt[jnp.maximum(pos_new, 0)], se3.inverse(old_T)),
            jnp.eye(4),
        )
        new_odom = state.odom._replace(
            pose=se3.orthonormalize_T(f32.matmul(corr, state.odom.pose)),
            kf_pose=se3.orthonormalize_T(f32.matmul(corr, state.odom.kf_pose)),
        )
        s2 = state._replace(
            keyframes=kf._replace(poses=new_poses),
            landmarks=lm._replace(xyz=res.landmarks),
            odom=new_odom,
        )
        return s2, jnp.bool_(True), res.initial_cost, res.final_cost

    def _skip(_):
        return state, jnp.bool_(False), jnp.float32(0.0), jnp.float32(0.0)

    return jax.lax.cond(do_ba, _run, _skip, None)


def correct_with_pose_graph(state: SlamState, iterations: int = 10) -> SlamState:
    """Run pose-graph GN over the keyframe poses and write them back
    (fused in-step on closure frames, or host-triggered)."""
    graph = PoseGraph(
        poses_wc=state.keyframes.poses,
        edge_i=state.edges.i,
        edge_j=state.edges.j,
        edge_T=state.edges.T,
        edge_weight=state.edges.weight,
        edge_mask=state.edges.mask,
    )
    opt, c0, c1 = optimize_pose_graph(graph, iterations=iterations)
    # Keep invalid slots untouched; shift the live pose by the current
    # keyframe's correction.
    corr = f32.matmul(opt[state.current_kf], se3.inverse(state.keyframes.poses[state.current_kf]))
    new_poses = jnp.where(state.keyframes.valid[:, None, None], opt, state.keyframes.poses)
    new_poses = se3.orthonormalize_T(new_poses)
    new_odom = state.odom._replace(
        pose=se3.orthonormalize_T(f32.matmul(corr, state.odom.pose)),
        kf_pose=se3.orthonormalize_T(f32.matmul(corr, state.odom.kf_pose)),
    )
    # Landmarks ride their anchor keyframe's correction so BA tracks
    # survive the graph update instead of being wiped.
    corr_all = f32.matmul(opt, se3.inverse(state.keyframes.poses))  # (K, 4, 4)
    lc = corr_all[jnp.clip(state.landmarks.anchor, 0, corr_all.shape[0] - 1)]
    lx = f32.einsum("lij,lj->li", lc[:, :3, :3], state.landmarks.xyz) + lc[:, :3, 3]
    new_lm = state.landmarks._replace(
        xyz=jnp.where(state.landmarks.mask[:, None], lx, state.landmarks.xyz)
    )
    return state._replace(
        keyframes=state.keyframes._replace(poses=new_poses),
        landmarks=new_lm,
        odom=new_odom,
    )


def run_slam(camera: PinholeCamera, depths, grays, cfg: SlamConfig = SlamConfig()):
    """Host loop: track every frame, correcting on loop closures.

    With ``cfg.correct_in_step`` (default) the pose-graph correction is
    fused into ``slam_step`` under ``lax.cond``, so this loop is pure
    async dispatch: zero host-device syncs until the trajectory is
    gathered at the end. The legacy host-triggered mode keeps the
    overlapped one-frame-late sync (the closure flag of step t is
    inspected after step t+1 is enqueued)."""
    state = slam_init(camera, jnp.asarray(depths[0]), jnp.asarray(grays[0]), cfg)
    poses = [jnp.eye(4)]
    diags = []
    key = jax.random.key(0)
    prev_flag = state.loop_found
    for d, g in zip(depths[1:], grays[1:]):
        key, sub = jax.random.split(key)
        state, diag = slam_step(state, jnp.asarray(d), jnp.asarray(g), camera, sub, cfg)
        if not cfg.correct_in_step:
            if bool(prev_flag):  # previous step — already materialized
                state = correct_with_pose_graph(state)
            prev_flag = state.loop_found
        poses.append(state.odom.pose)
        diags.append(diag)
    if not cfg.correct_in_step and bool(prev_flag):
        state = correct_with_pose_graph(state)
        poses[-1] = state.odom.pose
    return state, poses, diags
