"""Assembled multi-face pipeline: tracker slots + batched per-face chain.

The reference replicates its landmark/AU models ``max_faces`` times and
runs one tracker per face (``openface2_ros/src/openface2_ros.cpp``:
model replication :174-183, detection->free-tracker assignment via TBB
compare-and-swap :252-281, per-face pose/gaze/landmark/AU outputs
:308-441, tracker reset after >4 consecutive failures :260-263,
detector throttling :236-246). This redesign keeps ``max_faces``
fixed-capacity SLOTS as arrays — (F, 4) boxes + (F,) active mask +
(F,) failure counters — and runs the whole per-face chain
(crop -> landmark CNN -> PnP head pose -> gaze -> action units) as ONE
vmapped, jitted dispatch over the slot axis. Detection assignment is a
rank-matching scatter (the data-parallel equivalent of the reference's
CAS loop: k-th unclaimed detection -> k-th free slot).

Everything here is trace-compatible: :func:`multi_face_step` is the
single jitted entry the facade calls per frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from perception.models.face import (
    gaze_from_landmarks,
    head_pose_pnp,
    iou,
    non_overlapping_detections,
    normalize_landmarks,
)

MAX_TRACK_FAILS = 4  # openface2_ros.cpp:260-263


class FaceTrackState(NamedTuple):
    """Fixed-capacity tracker slots (the model-replication analog)."""

    boxes: jax.Array   # (F, 4) last known face box per slot
    active: jax.Array  # (F,) slot holds a live track
    fails: jax.Array   # (F,) consecutive extraction failures


def init_tracks(max_faces: int) -> FaceTrackState:
    return FaceTrackState(
        boxes=jnp.zeros((max_faces, 4), jnp.float32),
        active=jnp.zeros((max_faces,), bool),
        fails=jnp.zeros((max_faces,), jnp.int32),
    )


def assign_detections(
    state: FaceTrackState,
    det_boxes: jax.Array,
    det_mask: jax.Array,
    iou_threshold: float = 0.5,
) -> FaceTrackState:
    """Detections -> tracker slots (openface2_ros.cpp:252-281).

    Active tracks adopt their best-overlapping detection (the re-init
    that keeps a tracker on its face); detections overlapping NO active
    track (``non_overlapping_detections``, :81-99) fill free slots —
    the k-th fresh detection takes the k-th free slot, a deterministic
    rank-match replacing the reference's first-come CAS."""
    ious = iou(det_boxes[:, None, :], state.boxes[None, :, :])  # (D, F)

    # Refresh: each active slot adopts its best detection above the
    # overlap threshold.
    scores = jnp.where(det_mask[:, None], ious, -1.0)
    best = jnp.argmax(scores, axis=0)                      # (F,)
    best_iou = jnp.take_along_axis(scores, best[None, :], axis=0)[0]
    refreshed = state.active & (best_iou > iou_threshold)
    boxes = jnp.where(refreshed[:, None], det_boxes[best], state.boxes)

    # Fresh detections -> free slots by rank matching.
    fresh = non_overlapping_detections(
        state.boxes, state.active, det_boxes, det_mask, iou_threshold
    )
    det_rank = jnp.cumsum(fresh) - 1                        # (D,)
    free = ~state.active
    slot_rank = jnp.cumsum(free) - 1                        # (F,)
    match = (
        fresh[:, None] & free[None, :] & (det_rank[:, None] == slot_rank[None, :])
    )                                                       # (D, F)
    filled = jnp.any(match, axis=0)                         # (F,)
    src = jnp.argmax(match, axis=0)                         # (F,)
    boxes = jnp.where(filled[:, None], det_boxes[src], boxes)
    return FaceTrackState(
        boxes=boxes,
        active=state.active | filled,
        fails=jnp.where(filled | refreshed, 0, state.fails),
    )


def retire_failed_tracks(state: FaceTrackState, ok: jax.Array) -> FaceTrackState:
    """Failure bookkeeping: a slot whose extraction failed increments
    its counter; after > MAX_TRACK_FAILS consecutive failures the
    tracker resets (slot freed) — openface2_ros.cpp:260-263."""
    fails = jnp.where(state.active & ~ok, state.fails + 1, 0)
    return FaceTrackState(
        boxes=state.boxes,
        active=state.active & (fails <= MAX_TRACK_FAILS),
        fails=fails,
    )


def extract_faces(
    params: dict,
    gray: jax.Array,        # (H, W) float, 0-255 scale
    boxes: jax.Array,       # (F, 4)
    mask: jax.Array,        # (F,)
    fx: float, fy: float, cx: float, cy: float,
    crop: int,
    ok_landmark_frac: float = 0.6,
    ok_reproj_px: float = 12.0,
) -> dict:
    """The per-face chain, vmapped over the slot axis: crop ->
    landmark heatmap CNN -> head-pose PnP -> per-eye gaze -> action
    units -> AU02 publish gate (openface2_ros.cpp:308-441,467-476).

    Returns (F, ...)-shaped arrays plus an ``ok`` quality mask (the
    per-tracker success signal feeding :func:`retire_failed_tracks`)."""
    from perception.models import face_fixture as FF
    from perception.models.face import au_gated_pose_mask
    from perception.models.hand import crop_image

    def one(box):
        patch = crop_image(gray, box, crop) / 255.0
        uv, m, score = FF.landmarks_from_crop(params["landmark"], patch, box)
        T, px_err = head_pose_pnp(uv, m, fx, fy, cx, cy)
        gaze_r, gaze_l = gaze_from_landmarks(uv, T, fx, fy, cx, cy)
        inten, presence = FF.tiny_au_head().apply(
            params["au"], normalize_landmarks(uv, m)
        )
        return uv, m, score, T, px_err, jnp.stack([gaze_r, gaze_l]), inten, presence

    uv, m, score, T, px_err, gaze, inten, presence = jax.vmap(one)(boxes)
    m = m & mask[:, None]
    frac = jnp.mean(m, axis=1)
    ok = mask & (frac >= ok_landmark_frac) & (px_err < ok_reproj_px)
    return {
        "boxes": boxes,
        "mask": mask,
        "landmarks": uv,                  # (F, 70, 2)
        "landmark_mask": m,               # (F, 70)
        "landmark_scores": score,         # (F, 70)
        "head_pose": T,                   # (F, 4, 4)
        "reproj_px": px_err,              # (F,)
        "gaze": gaze,                     # (F, 2, 3) [right, left]
        "au_intensities": inten,          # (F, 17)
        "au_presence": presence,          # (F, 17)
        "pose_gate": au_gated_pose_mask(inten) & mask,  # (F,)
        "ok": ok,                         # (F,)
    }


@functools.partial(jax.jit, static_argnames=("crop", "det_threshold"))
def multi_face_step(
    params: dict,
    gray: jax.Array,          # (H, W) float, 0-255 scale
    state: FaceTrackState,
    fx: float, fy: float, cx: float, cy: float,
    detect: jax.Array,        # () bool — run the detector this frame
                              # (cadence throttle, openface2_ros.cpp:236-246)
    crop: int = 96,
    det_threshold: float = 0.3,
) -> Tuple[FaceTrackState, dict]:
    """One frame of the assembled multi-face pipeline (single jitted
    dispatch): detect (throttled) -> slot assignment -> batched per-face
    extraction -> failure retirement."""
    from perception.models import face_fixture as FF

    max_faces = state.boxes.shape[0]
    det = FF.detect_with_net(
        params["det"], gray, threshold=det_threshold, max_faces=max_faces
    )
    state = assign_detections(state, det.boxes, det.mask & detect)
    out = extract_faces(
        params, gray, state.boxes, state.active, fx, fy, cx, cy, crop
    )
    state = retire_failed_tracks(state, out["ok"])
    return state, out
