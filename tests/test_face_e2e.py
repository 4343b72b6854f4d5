"""End-to-end face stack from raw pixels (VERDICT r2 item 3).

Mirrors tests/test_pose_e2e.py: the in-repo-trained fixture
(tests/fixtures/facenet_tiny.msgpack) drives the complete reference
path — image -> face detection -> 70 landmarks -> head-pose PnP ->
gaze -> AU02 publish gate — with NO ground-truth inputs anywhere in
the pipeline (GT is used only to assert). Reference capability:
openface2_ros.cpp:198-490 (detect 236-246, landmarks 276-285, pose
308-315, gaze 329-384, AU gate 467-476).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from perception.models import face_fixture as FF
from perception.models.face import (
    au_gated_pose_mask,
    gaze_from_landmarks,
    head_pose_pnp,
    iou,
    normalize_landmarks,
)
from perception.models.face_data import (
    crop_box_from_landmarks,
    render_face,
    sample_face,
)
from perception.models.hand import crop_image

pytestmark = [pytest.mark.slow, pytest.mark.skipif(
    not FF.fixture_available(), reason="face fixture not trained"
)]

HW = FF.FIXTURE_HW
FX = FF.FIXTURE_FX
CX, CY = HW[1] / 2.0, HW[0] / 2.0


def run_pipeline(params, img):
    """Pixels -> (box, landmarks, mask, head pose, gaze, AU intensities).
    Everything downstream of `img` is detector/net output only."""
    det = FF.detect_with_net(params["det"], img)
    box = det.boxes[0]
    patch = crop_image(img, box, FF.FIXTURE_CROP) / 255.0
    uv, m, _ = FF.landmarks_from_crop(params["landmark"], patch, box)
    T, px_err = head_pose_pnp(uv, m, FX, FX, CX, CY)
    gaze_r, gaze_l = gaze_from_landmarks(uv, T, FX, FX, CX, CY)
    inten, _ = FF.tiny_au_head().apply(params["au"], normalize_landmarks(uv, m))
    return det, box, uv, m, T, px_err, gaze_r, gaze_l, inten


def test_face_pipeline_from_pixels_alone():
    params = FF.load_fixture()
    n_ok = 0
    gate_ok = 0
    n = 10
    for i in range(n):
        k = jax.random.fold_in(jax.random.key(321), i)
        k1, k2 = jax.random.split(k)
        scene = sample_face(k1, HW, FX, FX)
        img = render_face(scene, HW, key=k2)

        det, box, uv, m, T, px_err, gr, gl, inten = run_pipeline(params, img)

        # Detection localizes the face.
        assert bool(det.mask[0])
        gt_box = crop_box_from_landmarks(scene.landmarks2d)
        assert float(iou(box, gt_box)) > 0.5

        # Landmarks from the DETECTED crop land on the GT points.
        err = np.asarray(jnp.linalg.norm(uv - scene.landmarks2d, axis=-1))
        lm_err = float(np.mean(err[np.asarray(m)]))
        assert lm_err < 4.0, lm_err

        # Head pose: translation within 3 cm, rotation within ~0.15 rad.
        t_err = float(jnp.linalg.norm(T[:3, 3] - scene.pose[:3, 3]))
        R_err = np.asarray(T[:3, :3] @ scene.pose[:3, :3].T)
        ang = float(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
        if t_err < 0.03 and ang < 0.15:
            n_ok += 1

        # Gaze rays are unit vectors pointing back toward the camera
        # (the synthetic faces always look near-frontally).
        for g in (gr, gl):
            assert abs(float(jnp.linalg.norm(g)) - 1.0) < 1e-4
            assert float(g[2]) < 0.0

        # AU02 publish gate agrees with the rendered brow state.
        gate = bool(au_gated_pose_mask(inten))
        truth = float(scene.au02) > 0.4
        gate_ok += int(gate == truth)

    assert n_ok >= n - 1, f"head pose within bounds on only {n_ok}/{n}"
    assert gate_ok >= n - 1, f"AU02 gate matched on only {gate_ok}/{n}"


def test_face_pipeline_is_jittable_end_to_end():
    """The whole pixels->outputs path compiles as one jitted function
    (fixed shapes, no host round-trips) — the fixed-shape property the
    reference's per-stage OpenFace pipeline lacks."""
    params = FF.load_fixture()

    @jax.jit
    def pipeline(img):
        det = FF.detect_with_net(params["det"], img)
        box = det.boxes[0]
        patch = crop_image(img, box, FF.FIXTURE_CROP) / 255.0
        uv, m, _ = FF.landmarks_from_crop(params["landmark"], patch, box)
        T, _ = head_pose_pnp(uv, m, FX, FX, CX, CY)
        inten, _ = FF.tiny_au_head().apply(
            params["au"], normalize_landmarks(uv, m)
        )
        return T, au_gated_pose_mask(inten)

    k1, k2 = jax.random.split(jax.random.key(5))
    scene = sample_face(k1, HW, FX, FX)
    img = render_face(scene, HW, key=k2)
    T, gate = pipeline(img)
    assert bool(jnp.all(jnp.isfinite(T)))
    t_err = float(jnp.linalg.norm(T[:3, 3] - scene.pose[:3, 3]))
    assert t_err < 0.05, t_err
