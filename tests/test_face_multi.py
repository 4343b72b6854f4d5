"""Assembled multi-face pipeline tests (VERDICT r4 missing 2).

The reference's core multi-face behavior — max_faces model replication,
detection -> free-tracker assignment, per-face landmark/pose/gaze/AU
outputs, tracker retirement after repeated failures
(``openface2_ros/src/openface2_ros.cpp:174-183, 252-281, 308-441,
260-263``) — exercised end-to-end on a 3-face render, through the
jitted ``models/face_multi.multi_face_step`` and the facade.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from perception.models import face_fixture as FF
from perception.models import face_multi as FM
from perception.models.face import iou
from perception.models.face_data import (
    crop_box_from_landmarks,
    render_faces,
    sample_face_at,
)

HW = (256, 256)
FX = FF.FIXTURE_FX
OFFSETS = [(-0.14, -0.14), (0.14, -0.14), (0.0, 0.14)]


def three_face_scene(seed: int = 0, au02=None):
    key = jax.random.key(seed)
    scenes = [
        sample_face_at(
            jax.random.fold_in(key, i), HW, FX, FX, o, 0.62,
            au02=None if au02 is None else au02[i],
        )
        for i, o in enumerate(OFFSETS)
    ]
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *scenes)
    img = render_faces(stacked, HW, key=jax.random.fold_in(key, 99))
    return scenes, img


# ------------------------- slot-machinery units ----------------------

def test_assign_fills_free_slots_in_rank_order():
    state = FM.init_tracks(4)
    det = jnp.asarray(
        [[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50]], jnp.float32
    )
    mask = jnp.asarray([True, False, True])
    state = FM.assign_detections(state, det, mask)
    assert state.active.tolist() == [True, True, False, False]
    np.testing.assert_allclose(state.boxes[0], det[0])
    np.testing.assert_allclose(state.boxes[1], det[2])  # rank-matched


def test_assign_refreshes_overlapping_track_not_new_slot():
    state = FM.init_tracks(2)
    det0 = jnp.asarray([[10, 10, 50, 50]], jnp.float32)
    state = FM.assign_detections(state, det0, jnp.asarray([True]))
    # Slightly moved detection of the SAME face: must refresh slot 0,
    # not occupy slot 1 (NonOverlapingDetections, openface2_ros:81-99).
    det1 = jnp.asarray([[12, 12, 52, 52]], jnp.float32)
    state = FM.assign_detections(state, det1, jnp.asarray([True]))
    assert state.active.tolist() == [True, False]
    np.testing.assert_allclose(state.boxes[0], det1[0])


def test_retire_after_consecutive_failures():
    state = FM.init_tracks(1)
    state = FM.assign_detections(
        state, jnp.asarray([[0, 0, 10, 10]], jnp.float32), jnp.asarray([True])
    )
    ok = jnp.asarray([False])
    for _ in range(FM.MAX_TRACK_FAILS):
        state = FM.retire_failed_tracks(state, ok)
        assert bool(state.active[0])  # still within the failure budget
    state = FM.retire_failed_tracks(state, ok)
    assert not bool(state.active[0])  # >4 consecutive failures -> reset
    # A success resets the counter.
    state = FM.assign_detections(
        state, jnp.asarray([[0, 0, 10, 10]], jnp.float32), jnp.asarray([True])
    )
    state = FM.retire_failed_tracks(state, jnp.asarray([True]))
    assert int(state.fails[0]) == 0


# ----------------------------- e2e -----------------------------------

fixture_needed = pytest.mark.skipif(
    not FF.fixture_available(), reason="face fixture not trained"
)


@fixture_needed
@pytest.mark.slow
def test_three_faces_recovered_end_to_end():
    scenes, img = three_face_scene(seed=0)
    params = FF.load_fixture()
    state = FM.init_tracks(4)
    state, out = FM.multi_face_step(
        params, img, state, FX, FX, HW[1] / 2, HW[0] / 2, jnp.bool_(True)
    )
    assert int(out["mask"].sum()) == 3
    assert int(state.active.sum()) == 3
    gt_boxes = [crop_box_from_landmarks(s.landmarks2d) for s in scenes]
    matched = set()
    for j in range(4):
        if not bool(out["mask"][j]):
            continue
        ious = [float(iou(out["boxes"][j], g)) for g in gt_boxes]
        k = int(np.argmax(ious))
        assert ious[k] > 0.5
        matched.add(k)
        # Per-face landmarks land on that face's GT points.
        m = np.asarray(out["landmark_mask"][j])
        err = np.linalg.norm(
            np.asarray(out["landmarks"][j]) - np.asarray(scenes[k].landmarks2d),
            axis=-1,
        )
        assert float(err[m].mean()) < 5.0
        # Per-face head pose translation matches that face's placement.
        t_err = float(
            jnp.linalg.norm(out["head_pose"][j][:3, 3] - scenes[k].pose[:3, 3])
        )
        assert t_err < 0.05, t_err
    assert matched == {0, 1, 2}  # all three faces, each exactly once


@fixture_needed
@pytest.mark.slow
def test_tracker_carries_faces_through_detector_throttle():
    # Frame 0 detects; frames 1-2 run with the detector throttled off
    # (openface2_ros.cpp:236-246) — the slots must keep extracting.
    scenes, img = three_face_scene(seed=1)
    params = FF.load_fixture()
    state = FM.init_tracks(4)
    state, out0 = FM.multi_face_step(
        params, img, state, FX, FX, HW[1] / 2, HW[0] / 2, jnp.bool_(True)
    )
    n0 = int(out0["mask"].sum())
    assert n0 == 3
    for _ in range(2):
        state, out = FM.multi_face_step(
            params, img, state, FX, FX, HW[1] / 2, HW[0] / 2, jnp.bool_(False)
        )
        assert int(out["mask"].sum()) == 3
        assert bool(jnp.all(out["ok"] == out["mask"]))


@fixture_needed
@pytest.mark.slow
def test_au02_gate_is_per_face():
    # Face 0 raises brows, faces 1-2 neutral: the publish gate must fire
    # per slot (openface2_ros.cpp:467-476), not globally.
    scenes, img = three_face_scene(seed=2, au02=[1.0, 0.05, 0.05])
    params = FF.load_fixture()
    state = FM.init_tracks(4)
    state, out = FM.multi_face_step(
        params, img, state, FX, FX, HW[1] / 2, HW[0] / 2, jnp.bool_(True)
    )
    assert int(out["mask"].sum()) == 3
    gt_boxes = [crop_box_from_landmarks(s.landmarks2d) for s in scenes]
    raised = []
    for j in range(4):
        if not bool(out["mask"][j]):
            continue
        k = int(np.argmax([float(iou(out["boxes"][j], g)) for g in gt_boxes]))
        if bool(out["pose_gate"][j]):
            raised.append(k)
    assert raised == [0], raised


@fixture_needed
@pytest.mark.slow
def test_facade_returns_per_face_slots():
    from perception.wrapper import (
        Perception,
        WrapperStructFace,
        WrapperStructPose,
    )

    scenes, img = three_face_scene(seed=3)
    engine = Perception(
        pose=WrapperStructPose(enabled=False),
        face=WrapperStructFace(enabled=True, max_faces=4, detect_every=2),
    )
    rgb = np.repeat(np.asarray(img)[..., None], 3, axis=-1)
    d0 = engine.emplace_and_pop(rgb, frame_index=0)
    assert d0.faces["head_pose"].shape == (4, 4, 4)
    assert d0.faces["landmarks"].shape[0] == 4
    assert int(np.asarray(d0.faces["mask"]).sum()) == 3
    # Second frame: detector throttled (detect_every=2) -> tracks carry.
    d1 = engine.emplace_and_pop(rgb, frame_index=1)
    assert int(np.asarray(d1.faces["mask"]).sum()) == 3
