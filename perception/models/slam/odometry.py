"""Frame-to-keyframe point-to-plane ICP odometry (SLAM front-end).

BASELINE.json config #3: "frame-to-frame point-to-plane ICP odometry
over a D435 bag with keyframe selection and local map fusion". This is
a new capability (the reference has no SLAM — SURVEY.md §1 'absent
layers'); the design is a dense, fixed-capacity frontend:

  * every frame: backproject + grid-stride subsample to a fixed point
    budget, depth-image normals (organized fast path);
  * ICP: Gauss-Newton point-to-plane against the current *keyframe*
    cloud, warm-started from the previous frame's pose (constant-pose
    model) — drift accumulates against keyframes, not per frame;
  * keyframe promotion when translation/rotation to the keyframe
    exceeds thresholds or correspondence overlap drops; the whole step
    (ICP + conditional promotion) is one jitted computation with
    ``lax.cond``-free masked updates (jnp.where on the state pytree).

State lives on-device between frames; the host loop only feeds depth
images and reads back poses — the streaming topology OpenPose gets from
its thread/queue graph (SURVEY.md §2.7), minus the threads.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from perception.geometry import f32, se3
from perception.geometry.camera import PinholeCamera
from perception.ops import nn as _nn
from perception.ops.icp import _huber_weight
from perception.ops.normals import normals_from_depth
from perception.ops.points import apply_mask


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    point_budget: int = 4096          # per-frame ICP source points
    keyframe_budget: int = 8192       # keyframe target cloud capacity
    icp_iterations: int = 10
    max_correspondence_distance: float = 0.25
    huber_delta: float = 0.02
    damping: float = 1e-5
    min_depth: float = 0.2
    max_depth: float = 5.0
    normal_max_edge: float = 0.05     # tangent-length discontinuity gate;
                                      # scale up for low-res/wide-FOV cameras
                                      # (tangents ~ depth/fx)
    # --- dense local-map fusion mode (map_budget > 0) -----------------
    # ICP targets a voxel-fused map of recent keyframes instead of one
    # keyframe cloud (>= 32k points); ``map_nn`` picks the
    # correspondence engine.
    map_budget: int = 0               # 0 = keyframe-target mode
    map_voxel: float = 0.02           # fusion dedup leaf (m)
    map_decay: float = 1.0            # weight on surviving map points
                                      # at each voxel fuse, vs 1.0 per
                                      # new keyframe point. <1 =
                                      # exponential forgetting (anchor
                                      # to the freshest registration);
                                      # >1 = persistence (approximates
                                      # TSDF observation-count
                                      # weighting: the established
                                      # multi-observation average
                                      # resists single-frame noise);
                                      # 1.0 = plain centroid fusion.
    map_nn_radius: float = 0.06       # correspondence radius in map mode
    # Correspondence engine in map mode:
    #   "shortlist" (the default behind "auto") — ONE top-k NN pass
    #     per frame under the warm-start pose builds k candidate map
    #     points per source point; every GN iteration then argmins over
    #     its k-candidate gather (N x k, trivial) instead of re-scanning
    #     the full map. Valid because the warm start absorbs the
    #     predicted motion and GN updates are mm-scale — the true NN
    #     stays inside the candidate neighborhood; the final fitness
    #     pass re-checks against the full map and reports drift via
    #     OdometryDiag.nn_overflow (fraction of points whose shortlist
    #     winner is not the true NN).
    #   "brute" — full brute-force distance tiles every iteration.
    #   "hash" — the voxel-hash engine (persistent across frames; build
    #     paid on keyframe promotion only).
    map_nn: str = "auto"
    map_nn_shortlist: int = 16        # candidates per point (shortlist mode)
    map_nn_polish: int = 2            # final GN iterations re-run full
                                      # brute NN (exact correspondences at
                                      # convergence — ATE-protective when
                                      # the warm-start shortlist staled)
    map_nn_refresh: int = 1           # shortlist builds per frame (>1 =
                                      # rebuild mid-scan from the current
                                      # pose, curing candidate staleness
                                      # under fast motion)
    map_nn_coarse: int = 1            # source stride during the fast
                                      # (shortlisted) iterations (1 =
                                      # off, the default): n>1 runs the
                                      # GN fast phase on every n-th
                                      # source point (grid-stride order
                                      # keeps coverage uniform), halving
                                      # the shortlist build + fast
                                      # iterations at n=2.
    map_nn_recall: float = 0.99       # approx top-k per-element recall
                                      # target (lax.approx_max_k; the
                                      # GPU lowers it to an exact top-k,
                                      # so below 1.0 it has no effect
                                      # there). >= 1.0 selects a
                                      # segmented exact argmin instead:
                                      # the true NN is always a
                                      # candidate, but no local
                                      # runners-up are.
    # Keyframe promotion thresholds
    kf_translation: float = 0.15      # meters
    kf_rotation: float = 0.2          # radians
    kf_min_overlap: float = 0.5       # gated-correspondence fraction


class OdometryState(NamedTuple):
    pose: jax.Array        # (4, 4) world <- camera (current frame)
    kf_pose: jax.Array     # (4, 4) world <- keyframe camera
    kf_points: jax.Array   # (Mk, 3) keyframe cloud, keyframe camera frame
    kf_normals: jax.Array  # (Mk, 3)
    kf_mask: jax.Array     # (Mk,)
    frame_index: jax.Array # () int32
    num_keyframes: jax.Array  # () int32
    # Local fused map (map mode; zero-capacity arrays otherwise),
    # expressed in the current keyframe's camera frame.
    map_points: jax.Array  # (Mb, 3)
    map_normals: jax.Array # (Mb, 3)
    map_mask: jax.Array    # (Mb,)
    # Persistent cell-sorted hash of the map (hash NN mode only; a
    # minimal dummy otherwise). The map changes ONLY on keyframe
    # promotion, so the build sort is paid once per keyframe — not per
    # frame — the incremental maintenance that replaces the reference's
    # per-callback KD-tree rebuild
    # (cuboid_detection/src/iterative_closest_point.cpp:159-178).
    map_hash: Any          # ops.voxelhash.VoxelHash
    map_nrm_hash: jax.Array  # (Mb, 3) normals in hash (cell-sorted) order


class OdometryDiag(NamedTuple):
    fitness: jax.Array       # () mean sq corr distance after ICP
    overlap: jax.Array       # () gated-correspondence fraction
    promoted: jax.Array      # () bool — this frame became a keyframe
    num_corr: jax.Array      # () int32
    nn_overflow: jax.Array   # () voxel-hash per-tile range overflow
                             # fraction on the final correspondence pass
                             # (0.0 on the brute path); nonzero
                             # means tile coherence broke and tail
                             # candidates were dropped — see
                             # ops/voxelhash.query(rng_pts)


def _subsample_indices(n: int, budget: int, phase):
    """Grid-stride subsample indices with a per-frame phase jitter.

    Deterministic, spatially uniform, O(1) (no sort). The jitter shifts
    which raster columns are sampled each frame (phase mod stride), so
    structured scenes don't alias onto the same columns every frame
    while the stride spacing (spatial uniformity) is preserved.
    """
    stride = max(n // budget, 1)
    offset = jnp.asarray(phase, jnp.int32) % stride
    return jnp.clip(jnp.arange(budget) * stride + offset, 0, n - 1)


def _frame_features(camera: PinholeCamera, depth, cfg: OdometryConfig, phase=0):
    """Backproject + normals + subsample one depth image."""
    pts_flat, valid_flat = camera.backproject_depth(
        depth, min_depth=cfg.min_depth, max_depth=cfg.max_depth
    )
    h, w = depth.shape
    normals, nvalid = normals_from_depth(
        pts_flat.reshape(h, w, 3), valid_flat.reshape(h, w), max_edge=cfg.normal_max_edge
    )
    normals = normals.reshape(-1, 3)
    nvalid = nvalid.reshape(-1)
    good = valid_flat & nvalid

    src_idx = _subsample_indices(h * w, cfg.point_budget, phase)
    src_pts, src_mask = pts_flat[src_idx], good[src_idx]

    kf_idx = _subsample_indices(h * w, cfg.keyframe_budget, phase)
    kf_pts = pts_flat[kf_idx]
    kf_norm = normals[kf_idx]
    kf_mask = good[kf_idx]
    return src_pts, src_mask, kf_pts, kf_norm, kf_mask


def _fuse_map(map_pts, map_nrm, map_mask, kf_pts, kf_norm, kf_mask, cfg: OdometryConfig):
    """Merge a keyframe cloud into the local map: concat, voxel-dedup at
    ``map_voxel`` (centroids + renormalized mean normals), decimate to
    ``map_budget``. All inputs in the same (new keyframe) frame.

    With ``map_decay`` < 1 the surviving map points enter the voxel
    average at that weight while the new keyframe's points enter at
    1.0 — exponential forgetting. Map points are re-anchored through
    every promotion with the *measured* relative transform, so old
    points carry accumulated odometry error; recency weighting keeps
    voxels where old and new geometry overlap anchored to the freshly
    registered surface instead of the drift-smeared running average.
    """
    from perception.ops.points import compact_with_attrs, voxel_downsample_with_attrs

    pts = jnp.concatenate([map_pts, kf_pts], axis=0)
    nrm = jnp.concatenate([map_nrm, kf_norm], axis=0)
    msk = jnp.concatenate([map_mask, kf_mask], axis=0)
    weights = None
    if cfg.map_decay != 1.0:
        weights = jnp.concatenate([
            jnp.full(map_pts.shape[0], cfg.map_decay, pts.dtype),
            jnp.ones(kf_pts.shape[0], pts.dtype),
        ])
    fused_pts, fused_nrm, fused_mask = voxel_downsample_with_attrs(
        pts, msk, nrm, cfg.map_voxel, weights=weights
    )
    norm = jnp.linalg.norm(fused_nrm, axis=-1, keepdims=True)
    fused_nrm = fused_nrm / jnp.maximum(norm, 1e-9)
    # Opposed normals can cancel in a voxel; drop those points.
    fused_mask = fused_mask & (norm[:, 0] > 0.2)
    out_pts, out_nrm, out_mask = compact_with_attrs(
        fused_pts, fused_mask, fused_nrm, cfg.map_budget
    )
    return out_pts, out_nrm, out_mask


def _map_engine(cfg: OdometryConfig) -> str:
    """Static (config-time) choice of the map-mode NN engine.

    "auto" resolves to the shortlist: it pays the full (N, M) distance
    field once per frame instead of once per GN iteration."""
    if cfg.map_nn in ("shortlist", "brute", "hash"):
        return cfg.map_nn
    return "shortlist"


def _use_hash(cfg: OdometryConfig) -> bool:
    return cfg.map_budget > 0 and _map_engine(cfg) == "hash"


def _build_map_hash(map_pts, map_nrm, map_mask, cfg: OdometryConfig):
    from perception.ops import voxelhash

    vh = voxelhash.build(map_pts, map_mask, cell_size=cfg.map_nn_radius)
    return vh, map_nrm[vh.order]


def _dummy_hash():
    """Placeholder pytree for configs that never query the hash."""
    from perception.ops.voxelhash import VoxelHash

    z3 = jnp.zeros((1, 3), jnp.float32)
    return (
        VoxelHash(
            points=z3,
            table=jnp.zeros((1, 8), jnp.float32),
            cell_ids=jnp.zeros((1,), jnp.int32),
            origin=jnp.zeros((3,), jnp.float32),
            cell_size=jnp.float32(1.0),
            dims=jnp.ones((3,), jnp.int32),
            sentinel_id=jnp.int32(1),
            order=jnp.zeros((1,), jnp.int32),
        ),
        z3,
    )


def init_state(camera: PinholeCamera, depth0: jax.Array, cfg: OdometryConfig = OdometryConfig()) -> OdometryState:
    """Bootstrap from the first frame (identity pose, first keyframe)."""
    _, _, kf_pts, kf_norm, kf_mask = _frame_features(camera, depth0, cfg)
    eye = jnp.eye(4, dtype=jnp.float32)
    if cfg.map_budget > 0:
        zero_pts = jnp.full((cfg.map_budget, 3), 1.0e6, jnp.float32)
        map_pts, map_nrm, map_mask = _fuse_map(
            zero_pts, jnp.zeros((cfg.map_budget, 3)), jnp.zeros(cfg.map_budget, bool),
            kf_pts, kf_norm, kf_mask, cfg,
        )
    else:
        map_pts = jnp.zeros((0, 3), jnp.float32)
        map_nrm = jnp.zeros((0, 3), jnp.float32)
        map_mask = jnp.zeros((0,), bool)
    if _use_hash(cfg):
        map_hash, map_nrm_hash = _build_map_hash(map_pts, map_nrm, map_mask, cfg)
    else:
        map_hash, map_nrm_hash = _dummy_hash()
    return OdometryState(
        pose=eye,
        kf_pose=eye,
        kf_points=apply_mask(kf_pts, kf_mask),
        kf_normals=kf_norm,
        kf_mask=kf_mask,
        frame_index=jnp.int32(1),
        num_keyframes=jnp.int32(1),
        map_points=map_pts,
        map_normals=map_nrm,
        map_mask=map_mask,
        map_hash=map_hash,
        map_nrm_hash=map_nrm_hash,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def odometry_step(
    state: OdometryState,
    depth: jax.Array,
    camera: PinholeCamera,
    cfg: OdometryConfig = OdometryConfig(),
) -> Tuple[OdometryState, OdometryDiag]:
    """Track one frame; returns (new_state, diagnostics).

    ``cfg`` is static (hashable dataclass); ``camera`` is a pytree with
    static width/height aux data, so one compilation serves the stream.
    """
    src_pts, src_mask, new_kf_pts, new_kf_norm, new_kf_mask = _frame_features(
        camera, depth, cfg, phase=state.frame_index * 97
    )
    src_pts = apply_mask(src_pts, src_mask)

    # ICP in the keyframe's camera frame: T maps current-frame points
    # into keyframe frame; init from the previous pose estimate.
    T0 = f32.matmul(se3.inverse(state.kf_pose), state.pose)
    max_d2 = cfg.max_correspondence_distance**2

    if cfg.map_budget > 0:
        # Dense map mode: point-to-plane GN against the fused local
        # map, NN engine per cfg.map_nn.
        from perception.ops import voxelhash

        engine = _map_engine(cfg)
        r2 = cfg.map_nn_radius**2
        if engine == "shortlist":
            # One top-k pass under the warm start; per-iteration NN is
            # then an (N, k) argmin over the candidate gather. The
            # top-k comes from lax.approx_max_k over the full distance
            # matrix. The exact polish below re-checks against the full
            # map (true fitness + the shortlist-miss fraction in
            # nn_overflow).
            from perception.ops.points import SENTINEL as _SENT

            map_masked = jnp.where(
                state.map_mask[:, None], state.map_points, _SENT
            )
            map_sq = jnp.sum(map_masked * map_masked, axis=1)

            # Coarse-to-fine: the fast phase sees every n-th source
            # point (grid-stride order -> uniform spatial coverage);
            # the exact polish below runs the full set.
            stride = max(cfg.map_nn_coarse, 1)
            src_fast = src_pts[::stride]
            mask_fast = src_mask[::stride]

            def build_shortlist(T):
                src_t = se3.transform_points(T, src_fast)
                d2_full = (
                    jnp.sum(src_t * src_t, axis=1)[:, None]
                    - 2.0 * (f32.matmul(src_t, map_masked.T))
                    + map_sq[None, :]
                )
                if cfg.map_nn_recall >= 1.0:
                    # Exact segmented argmin: k = number of map
                    # segments, each contributing its winner — the TRUE
                    # NN is always candidate #something (100% first-NN
                    # recall at build time), and the pass is a pure
                    # min-reduce (no sorting network, ~matmul-bound).
                    k = cfg.map_nn_shortlist
                    m = d2_full.shape[1]
                    pad = (-m) % k
                    d2p = jnp.pad(d2_full, ((0, 0), (0, pad)),
                                  constant_values=jnp.inf)
                    seg = d2p.reshape(d2p.shape[0], k, -1)
                    ci = (
                        jnp.argmin(seg, axis=2).astype(jnp.int32)
                        + jnp.arange(k, dtype=jnp.int32)[None, :]
                        * (d2p.shape[1] // k)
                    )
                    ci = jnp.minimum(ci, m - 1)
                else:
                    _, ci = jax.lax.approx_max_k(
                        -d2_full, cfg.map_nn_shortlist,
                        recall_target=cfg.map_nn_recall,
                    )
                    ci = ci.astype(jnp.int32)
                return ci, state.map_points[ci]   # (N, k), (N, k, 3)

            def shortlist_query(cand_idx, cand_pts):
                def nn_q(src_t):
                    d2k = jnp.sum((src_t[:, None, :] - cand_pts) ** 2, axis=-1)
                    j = jnp.argmin(d2k, axis=1)
                    idx = jnp.take_along_axis(cand_idx, j[:, None], axis=1)[:, 0]
                    d2 = jnp.take_along_axis(d2k, j[:, None], axis=1)[:, 0]
                    return idx, d2

                return nn_q

            cand_idx0, cand_pts0 = build_shortlist(T0)
            nn_query = shortlist_query(cand_idx0, cand_pts0)
            map_pts_nn = state.map_points
            nrm_sorted = state.map_normals
            # (Fitness/overflow stats ride the exact-polish scan below —
            # no separate full-map stats pass in this engine.)
        elif engine == "hash":
            # Persistent hash (state.map_hash): the cell sort was paid
            # when the map last changed (keyframe promotion), not here.
            vh = state.map_hash
            map_pts_nn = vh.points
            nrm_sorted = state.map_nrm_hash
            # Sort the source into cell order ONCE per frame (under the
            # warm-start transform); every GN iteration then queries
            # with sort=False — the mm-scale pose updates keep the
            # layout tile-coherent, and results come back unpermuted.
            # Residuals/sums are permutation-invariant, so the sorted
            # copies simply replace src everywhere in this branch.
            src_t0 = se3.transform_points(T0, src_pts)
            _, src_order = voxelhash.sort_by_cell(vh, src_t0)
            src_pts = src_pts[src_order]
            src_mask = src_mask[src_order]

            def nn_query(src_t):
                return voxelhash.query(vh, src_t, sort=False)

            def nn_query_stats(src_t):
                # Final-pass overflow accounting (the exactness
                # contract's diagnostic): if a large inter-frame motion
                # broke the once-per-frame tile coherence, the per-tile
                # range cap drops tail candidates — report the fraction
                # instead of degrading silently.
                idx, d2, ov = voxelhash.query(
                    vh, src_t, sort=False, return_stats=True
                )
                return idx, d2, ov
        else:
            map_pts_nn = apply_mask(state.map_points, state.map_mask)
            nrm_sorted = state.map_normals

            def nn_query(src_t):
                return _nn.nearest_neighbor(src_t, map_pts_nn, state.map_mask)

            def nn_query_stats(src_t):
                idx, d2 = nn_query(src_t)
                return idx, d2, jnp.float32(0.0)

        def make_gn_body(query_fn, pts=None, mask=None):
            pts = src_pts if pts is None else pts
            mask = src_mask if mask is None else mask

            def gn_body(T, _):
                src_t = se3.transform_points(T, pts)
                idx, d2 = query_fn(src_t)
                gate = mask & (d2 <= r2)
                q = map_pts_nn[idx]
                nrm = nrm_sorted[idx]
                r = jnp.sum(nrm * (src_t - q), axis=-1)
                w = gate.astype(src_pts.dtype) * _huber_weight(r, cfg.huber_delta)
                J = jnp.concatenate([nrm, jnp.cross(src_t, nrm)], axis=-1)
                Jw = J * w[:, None]
                A = f32.matmul(Jw.T, J) + cfg.damping * jnp.eye(6, dtype=src_pts.dtype)
                b = -(f32.matmul(Jw.T, r))
                xi = jnp.linalg.solve(A, b)
                return f32.matmul(se3.se3_exp(xi), T), None

            return gn_body

        if engine == "shortlist":
            # Shortlist segments (rebuilt map_nn_refresh times from the
            # current pose — staleness control), then exact brute
            # polish: the final correspondences equal the full-scan
            # engine's at convergence.
            polish_eff = max(cfg.map_nn_polish, 1)  # stats need >= 1
            n_fast = max(cfg.icp_iterations - polish_eff, 0)
            refresh = max(cfg.map_nn_refresh, 1)

            def brute_query(src_t):
                return _nn.nearest_neighbor(
                    src_t, apply_mask(state.map_points, state.map_mask),
                    state.map_mask,
                )

            T = T0
            per = [n_fast // refresh] * refresh
            per[-1] += n_fast - sum(per)
            for s, length in enumerate(per):
                q = nn_query if s == 0 else shortlist_query(*build_shortlist(T))
                T, _ = jax.lax.scan(
                    make_gn_body(q, src_fast, mask_fast), T, None, length=length
                )

            # Exact-polish iterations with stats riding the carry (they
            # describe the start of the final iteration — one stale,
            # indistinguishable at convergence) — saving the full-map
            # probe a post-scan stats pass would cost. nn_overflow = shortlist-miss
            # fraction at the same pose the brute pass evaluated.
            def polish_body(carry, _):
                T, _, _, _ = carry
                src_t = se3.transform_points(T, src_pts)
                idx, d2 = brute_query(src_t)
                gate = src_mask & (d2 <= r2)
                # Shortlist-miss fraction, on the coarse subset the
                # shortlist actually served, vs the exact d2 at the
                # same pose. The tolerance must sit ABOVE f32 formula
                # noise: the shortlist computes direct (q-p)^2 while
                # the brute pass uses |q|^2-2qp+|p|^2, which differ by
                # ~1e-6 at unit scale even for the SAME point — only a
                # materially-farther winner counts as a miss.
                _, d2s = nn_query(src_t[::stride])
                ov = jnp.sum(
                    (d2s - d2[::stride] > 1e-5 + 1e-3 * d2[::stride]) & mask_fast
                ) / jnp.maximum(jnp.sum(mask_fast), 1).astype(jnp.float32)
                q = map_pts_nn[idx]
                nrm = nrm_sorted[idx]
                r = jnp.sum(nrm * (src_t - q), axis=-1)
                w = gate.astype(src_pts.dtype) * _huber_weight(r, cfg.huber_delta)
                J = jnp.concatenate([nrm, jnp.cross(src_t, nrm)], axis=-1)
                Jw = J * w[:, None]
                A = f32.matmul(Jw.T, J) + cfg.damping * jnp.eye(6, dtype=src_pts.dtype)
                b = -(f32.matmul(Jw.T, r))
                xi = jnp.linalg.solve(A, b)
                gd2 = jnp.sum(jnp.where(gate, d2, 0.0))
                cnt = jnp.sum(gate, dtype=jnp.int32)
                return (f32.matmul(se3.se3_exp(xi), T), gd2, cnt, ov), None

            (T, gd2, num_corr, nn_overflow), _ = jax.lax.scan(
                polish_body,
                (T, jnp.float32(0.0), jnp.int32(0), jnp.float32(0.0)),
                None,
                length=polish_eff,
            )
            fitness = gd2 / jnp.maximum(num_corr.astype(jnp.float32), 1.0)
        else:
            T, _ = jax.lax.scan(
                make_gn_body(nn_query), T0, None, length=cfg.icp_iterations
            )
            src_tf = se3.transform_points(T, src_pts)
            _, d2, nn_overflow = nn_query_stats(src_tf)
            gate = src_mask & (d2 <= r2)
            num_corr = jnp.sum(gate, dtype=jnp.int32)
            fitness = jnp.sum(jnp.where(gate, d2, 0.0)) / jnp.maximum(
                num_corr.astype(jnp.float32), 1.0
            )
    else:
        def correspondences(T):
            src_t = se3.transform_points(T, src_pts)
            idx, d2 = _nn.nearest_neighbor(src_t, state.kf_points, state.kf_mask)
            gate = src_mask & (d2 <= max_d2)
            return src_t, idx, d2, gate

        def gn_body(T, _):
            src_t, idx, d2, gate = correspondences(T)
            q = state.kf_points[idx]
            nrm = state.kf_normals[idx]
            r = jnp.sum(nrm * (src_t - q), axis=-1)
            w = gate.astype(src_pts.dtype) * _huber_weight(r, cfg.huber_delta)
            J = jnp.concatenate([nrm, jnp.cross(src_t, nrm)], axis=-1)
            Jw = J * w[:, None]
            A = f32.matmul(Jw.T, J) + cfg.damping * jnp.eye(6, dtype=src_pts.dtype)
            b = -(f32.matmul(Jw.T, r))
            xi = jnp.linalg.solve(A, b)
            return f32.matmul(se3.se3_exp(xi), T), None

        T, _ = jax.lax.scan(gn_body, T0, None, length=cfg.icp_iterations)
        _, _, d2, gate = correspondences(T)
        num_corr = jnp.sum(gate, dtype=jnp.int32)
        fitness = jnp.sum(d2 * gate) / jnp.maximum(num_corr.astype(d2.dtype), 1.0)
        nn_overflow = jnp.float32(0.0)  # brute NN scans the full map

    denom = jnp.maximum(jnp.sum(src_mask, dtype=jnp.int32), 1)
    overlap = num_corr.astype(jnp.float32) / denom.astype(jnp.float32)

    # Re-project onto SE(3): the inverse(kf_pose) @ pose warm start
    # doubles any off-manifold drift per frame (see se3.orthonormalize_T).
    new_pose = se3.orthonormalize_T(f32.matmul(state.kf_pose, T))

    # Keyframe promotion decision.
    delta = se3.se3_log(T)
    trans = jnp.linalg.norm(delta[:3])
    rot = jnp.linalg.norm(delta[3:])
    promote = (
        (trans > cfg.kf_translation)
        | (rot > cfg.kf_rotation)
        | (overlap < cfg.kf_min_overlap)
    )

    sel = promote
    if cfg.map_budget > 0:
        # On promotion the map re-anchors to the new keyframe frame and
        # absorbs its cloud; lax.cond skips the fuse (concat + voxel
        # dedup + decimate) on non-promoted frames.
        inv_T = se3.inverse(T)
        hash_mode = _use_hash(cfg)

        def do_merge(_):
            pts, nrm, msk = _fuse_map(
                se3.transform_points(inv_T, state.map_points),
                se3.rotate_points(inv_T, state.map_normals),
                state.map_mask,
                apply_mask(new_kf_pts, new_kf_mask),
                new_kf_norm,
                new_kf_mask,
                cfg,
            )
            if hash_mode:
                # The ONLY place the hash is (re)built: the map just
                # changed and re-anchored, so the cell sort here is
                # amortized over every frame until the next promotion.
                vh2, nrm2 = _build_map_hash(pts, nrm, msk, cfg)
                return pts, nrm, msk, vh2, nrm2
            return pts, nrm, msk, state.map_hash, state.map_nrm_hash

        def keep(_):
            return (state.map_points, state.map_normals, state.map_mask,
                    state.map_hash, state.map_nrm_hash)

        map_pts, map_nrm, map_mask, map_hash, map_nrm_hash = jax.lax.cond(
            sel, do_merge, keep, None
        )
    else:
        map_pts, map_nrm, map_mask = (
            state.map_points, state.map_normals, state.map_mask
        )
        map_hash, map_nrm_hash = state.map_hash, state.map_nrm_hash
    new_state = OdometryState(
        pose=new_pose,
        kf_pose=jnp.where(sel, new_pose, state.kf_pose),
        kf_points=jnp.where(sel, apply_mask(new_kf_pts, new_kf_mask), state.kf_points),
        kf_normals=jnp.where(sel, new_kf_norm, state.kf_normals),
        kf_mask=jnp.where(sel, new_kf_mask, state.kf_mask),
        frame_index=state.frame_index + 1,
        num_keyframes=state.num_keyframes + sel.astype(jnp.int32),
        map_points=map_pts,
        map_normals=map_nrm,
        map_mask=map_mask,
        map_hash=map_hash,
        map_nrm_hash=map_nrm_hash,
    )
    diag = OdometryDiag(fitness=fitness, overlap=overlap, promoted=promote,
                        num_corr=num_corr, nn_overflow=nn_overflow)
    return new_state, diag


def run_odometry(camera: PinholeCamera, depths, cfg: OdometryConfig = OdometryConfig()):
    """Host loop over a depth stream; returns (poses list, diags list)."""
    state = init_state(camera, jnp.asarray(depths[0]), cfg)
    poses = [jnp.eye(4)]
    diags = []
    for depth in depths[1:]:
        state, diag = odometry_step(state, jnp.asarray(depth), camera, cfg)
        poses.append(state.pose)
        diags.append(diag)
    return poses, diags
