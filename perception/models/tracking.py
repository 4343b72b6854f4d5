"""Person/keypoint identity tracking across frames.

Rebuild of the reference's ``PersonIdExtractor``
(``openpose/src/openpose/tracking/personIdExtractor.cpp``): previous
people's keypoints are propagated with pyramidal LK (``updateLK``
``:64-108``), then greedily matched to the new detections by mean
keypoint distance (``matchLKAndOPGreedy`` ``:149-180+``); unmatched
detections get fresh ids. Fixed-capacity track table, fully jitted.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from perception.ops.lk import lk_track


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_tracks: int = 16
    num_parts: int = 25
    match_threshold_px: float = 40.0   # mean keypoint distance gate
    min_shared_parts: int = 3
    lk_levels: int = 3
    lk_radius: int = 7
    # PersonTracker smoothing variant (--tracking;
    # openpose/src/openpose/tracking/personTracker.cpp): when a
    # detection matches a live track, the written keypoints are an EMA
    # merge of the LK-propagated prediction and the new detection —
    # smoothing detector jitter along the trajectory. 0.0 = off
    # (PersonIdExtractor behavior: detections overwrite). Parts seen by
    # only one of the two sources take that source unblended, and
    # detector-skip frames (det_mask all False) keep pure LK
    # propagation — the reference's interleave of tracked and detected
    # frames.
    smooth_alpha: float = 0.0


class TrackState(NamedTuple):
    ids: jax.Array        # (T,) int32 stable person id (-1 free slot)
    keypoints: jax.Array  # (T, P, 2)
    kp_mask: jax.Array    # (T, P)
    next_id: jax.Array    # ()


def tracker_init(cfg: TrackerConfig = TrackerConfig()) -> TrackState:
    T, P = cfg.max_tracks, cfg.num_parts
    return TrackState(
        ids=jnp.full((T,), -1, jnp.int32),
        keypoints=jnp.zeros((T, P, 2)),
        kp_mask=jnp.zeros((T, P), bool),
        next_id=jnp.int32(0),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def tracker_step(
    state: TrackState,
    prev_gray: jax.Array,
    gray: jax.Array,
    det_keypoints: jax.Array,   # (D, P, 3) new detections (x, y, score)
    det_mask: jax.Array,        # (D,)
    cfg: TrackerConfig = TrackerConfig(),
) -> Tuple[TrackState, jax.Array]:
    """Returns (new state, (D,) int32 person id per detection, -1 unmatched)."""
    T, P = cfg.max_tracks, cfg.num_parts
    D = det_keypoints.shape[0]

    # 1. Propagate live track keypoints with LK.
    flat_pts = state.keypoints.reshape(T * P, 2)
    flat_mask = (state.kp_mask & (state.ids >= 0)[:, None]).reshape(T * P)
    flow = lk_track(
        prev_gray, gray, flat_pts, flat_mask,
        levels=cfg.lk_levels, radius=cfg.lk_radius,
    )
    prop_kp = flow.points.reshape(T, P, 2)
    prop_mask = (flow.valid.reshape(T, P)) & state.kp_mask

    det_xy = det_keypoints[..., :2]
    det_part_mask = det_keypoints[..., 2] > 0  # (D, P)

    # 2. Distance matrix: mean distance over shared visible parts.
    shared = prop_mask[:, None, :] & det_part_mask[None, :, :]  # (T, D, P)
    diff = jnp.linalg.norm(prop_kp[:, None] - det_xy[None], axis=-1)  # (T, D, P)
    nshared = jnp.sum(shared, axis=-1)
    dist = jnp.sum(jnp.where(shared, diff, 0.0), axis=-1) / jnp.maximum(nshared, 1)
    feasible = (
        (state.ids >= 0)[:, None]
        & det_mask[None, :]
        & (nshared >= cfg.min_shared_parts)
        & (dist <= cfg.match_threshold_px)
    )
    cost = jnp.where(feasible, dist, jnp.inf)

    # 3. Greedy assignment (reference matchLKAndOPGreedy).
    def body(carry, _):
        c, t_of_d = carry
        best = jnp.argmin(c)
        ti = best // D
        di = best % D
        hit = jnp.isfinite(c.reshape(-1)[best])
        t_of_d = t_of_d.at[di].set(jnp.where(hit, ti, t_of_d[di]))
        c = jnp.where(
            (jnp.arange(T)[:, None] == ti) | (jnp.arange(D)[None, :] == di),
            jnp.inf, c,
        )
        return (c, t_of_d), None

    (_, track_of_det), _ = jax.lax.scan(
        body, (cost, jnp.full((D,), -1, jnp.int32)), None, length=min(T, D)
    )

    # 4. Unmatched detections claim free slots with fresh ids: the k-th
    # unmatched detection takes the k-th free slot (argsort puts free
    # slots first, in order).
    free = state.ids < 0  # (T,)
    unmatched = det_mask & (track_of_det < 0)
    new_rank = jnp.cumsum(unmatched.astype(jnp.int32)) - 1  # (D,)
    slot_order = jnp.argsort(~free, stable=True).astype(jnp.int32)
    det_slot = jnp.where(
        unmatched & (new_rank < jnp.sum(free)), slot_order[jnp.clip(new_rank, 0, T - 1)], -1
    )
    track_of_det = jnp.where(det_slot >= 0, det_slot, track_of_det)
    new_ids_for_det = state.next_id + new_rank

    # 5. Write detections into their tracks. With smoothing on, a
    # matched track's parts blend the LK prediction into the detection
    # (personTracker.cpp merge); fresh slots have no propagation
    # (prop_mask False) and take the detection unblended.
    tgt = jnp.where(track_of_det >= 0, track_of_det, T)  # (D,)
    if cfg.smooth_alpha > 0.0:
        tgt_c = jnp.clip(tgt, 0, T - 1)
        prop_for_det = prop_kp[tgt_c]        # (D, P, 2)
        prop_m_for_det = prop_mask[tgt_c]    # (D, P)
        det_xy = jnp.where(
            (prop_m_for_det & det_part_mask)[..., None],
            cfg.smooth_alpha * prop_for_det
            + (1.0 - cfg.smooth_alpha) * det_xy,
            det_xy,
        )
    new_ids = state.ids
    new_ids = new_ids.at[jnp.clip(tgt, 0, T - 1)].set(
        jnp.where(
            tgt < T,
            jnp.where(det_slot >= 0, new_ids_for_det, state.ids[jnp.clip(tgt, 0, T - 1)]),
            new_ids[jnp.clip(tgt, 0, T - 1)],
        )
    )
    kp = state.keypoints.at[jnp.clip(tgt, 0, T - 1)].set(
        jnp.where((tgt < T)[:, None, None], det_xy, state.keypoints[jnp.clip(tgt, 0, T - 1)])
    )
    km = state.kp_mask.at[jnp.clip(tgt, 0, T - 1)].set(
        jnp.where((tgt < T)[:, None], det_part_mask, state.kp_mask[jnp.clip(tgt, 0, T - 1)])
    )

    # Tracks that matched nothing keep the LK propagation.
    matched_track = jnp.zeros((T,), bool).at[jnp.clip(tgt, 0, T - 1)].set(tgt < T)
    kp = jnp.where(matched_track[:, None, None], kp, prop_kp)
    km = jnp.where(matched_track[:, None], km, prop_mask)

    num_new = jnp.sum(det_slot >= 0)
    new_state = TrackState(
        ids=new_ids,
        keypoints=kp,
        kp_mask=km,
        next_id=state.next_id + num_new,
    )
    person_ids = jnp.where(
        track_of_det >= 0, new_ids[jnp.clip(track_of_det, 0, T - 1)], -1
    ).astype(jnp.int32)
    return new_state, person_ids
