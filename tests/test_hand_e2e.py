"""End-to-end hand stack from raw pixels with the in-repo trained
fixture (completes the fixture treatment: pose r2, face r3, hand r3).
Reference capability: OpenPose HandDetector (ROI beyond the wrist along
the forearm) + HandExtractorCaffe 21-keypoint net (SURVEY.md §2.5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from perception.models import hand_fixture as HF
from perception.models.hand import hand_roi_from_pose
from perception.models.hand_data import hand_box, render_hand, sample_hand

pytestmark = [pytest.mark.slow, pytest.mark.skipif(
    not HF.fixture_available(), reason="hand fixture not trained"
)]


def test_hand_landmarks_from_pixels():
    params = HF.load_fixture()
    ok = 0
    n = 8
    for i in range(n):
        k = jax.random.fold_in(jax.random.key(11), i)
        k1, k2 = jax.random.split(k)
        scene = sample_hand(k1, HF.FIXTURE_HW)
        img = render_hand(scene, HF.FIXTURE_HW, key=k2)
        uv, m, _ = HF.extract_hand_tiny(params, img, hand_box(scene.joints))
        err = np.asarray(jnp.linalg.norm(uv - scene.joints, axis=-1))
        if float(np.mean(err[np.asarray(m)])) < 3.0:
            ok += 1
    assert ok >= n - 1, ok


def test_hand_roi_composes_with_extractor():
    """The reference topology: body wrist/elbow -> ROI -> crop ->
    landmarks. Build a scene whose hand sits exactly where the ROI
    heuristic looks (beyond the wrist along the forearm)."""
    params = HF.load_fixture()
    k1, k2 = jax.random.split(jax.random.key(21))
    scene = sample_hand(k1, HF.FIXTURE_HW, scale_range=(0.5, 0.6))
    img = render_hand(scene, HF.FIXTURE_HW, key=k2)

    # Synthesize wrist/elbow so hand_roi_from_pose reproduces the GT
    # box: center = wrist + 0.3 d, size = 1.2 |d| -> choose |d| from
    # the box size and place the wrist accordingly.
    box = np.asarray(hand_box(scene.joints))
    c = 0.5 * (box[:2] + box[2:])
    size = box[2] - box[0]
    L = size / 1.2
    d = np.array([L, 0.0])
    wrist = c - 0.3 * d
    elbow = wrist - d
    kp = np.zeros((25, 3), np.float32)
    kp[3] = (*elbow, 1.0)
    kp[4] = (*wrist, 1.0)

    roi, valid = hand_roi_from_pose(jnp.asarray(kp), arm=(3, 4))
    assert bool(valid)
    np.testing.assert_allclose(np.asarray(roi), box, atol=1.0)

    uv, m, _ = HF.extract_hand_tiny(params, img, roi)
    err = np.asarray(jnp.linalg.norm(uv - scene.joints, axis=-1))
    assert float(np.mean(err[np.asarray(m)])) < 3.0
