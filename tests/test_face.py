import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.geometry import se3
from perception.models.face import (
    AU_NAMES,
    ActionUnitHead,
    FaceLandmarkNet,
    NUM_FACE_LANDMARKS,
    PNP_LANDMARK_IDS,
    PNP_MODEL_POINTS,
    decode_landmarks,
    face_roi_from_pose,
    gaze_from_landmarks,
    head_pose_pnp,
    iou,
    non_overlapping_detections,
    normalize_landmarks,
)

FX, FY, CX, CY = 616.8, 616.6, 321.8, 239.9


def test_face_roi_from_pose():
    kp = np.zeros((25, 3), np.float32)
    # nose, eyes, ears around (200, 100)
    for pid, (x, y) in zip((0, 15, 16, 17, 18), [(200, 105), (190, 95), (210, 95), (180, 100), (220, 100)]):
        kp[pid] = (x, y, 1.0)
    box = np.asarray(face_roi_from_pose(jnp.asarray(kp)))
    cx_, cy_ = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
    assert abs(cx_ - 200) < 2 and abs(cy_ - 99) < 4
    assert box[2] - box[0] > 20  # sensible size


def test_iou_and_dedup():
    a = jnp.array([[0.0, 0, 10, 10]])
    b = jnp.array([[5.0, 0, 15, 10], [20.0, 20, 30, 30]])
    v = np.asarray(iou(b, a[0]))
    assert abs(v[0] - 1 / 3) < 1e-6 and v[1] == 0
    keep = non_overlapping_detections(
        a, jnp.ones(1, bool), b, jnp.ones(2, bool), threshold=0.3
    )
    np.testing.assert_array_equal(np.asarray(keep), [False, True])


def test_head_pose_pnp_recovers_synthetic():
    T_true = np.asarray(se3.se3_exp(jnp.asarray([0.05, -0.03, 0.7, 0.1, 0.2, -0.1], jnp.float32)))
    pc = PNP_MODEL_POINTS @ T_true[:3, :3].T + T_true[:3, 3]
    uv6 = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    lms = np.zeros((NUM_FACE_LANDMARKS, 2), np.float32)
    mask = np.zeros(NUM_FACE_LANDMARKS, bool)
    lms[PNP_LANDMARK_IDS] = uv6
    mask[PNP_LANDMARK_IDS] = True
    T, err = head_pose_pnp(jnp.asarray(lms), jnp.asarray(mask), FX, FY, CX, CY, iterations=15)
    assert float(err) < 0.5
    np.testing.assert_allclose(np.asarray(T)[:3, 3], T_true[:3, 3], atol=5e-3)
    dR = np.degrees(np.arccos(np.clip((np.trace(np.asarray(T)[:3, :3].T @ T_true[:3, :3]) - 1) / 2, -1, 1)))
    assert dR < 1.0


def test_gaze_straight_ahead():
    # Frontal face at 0.6 m, pupils centered in the eye rings -> gaze ~ +z.
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 0.6
    lms = np.zeros((NUM_FACE_LANDMARKS, 2), np.float32)
    # Eye rings: circles around (300, 200) and (340, 200).
    for i, ang in zip(range(36, 42), np.linspace(0, 2 * np.pi, 6, endpoint=False)):
        lms[i] = (300 + 6 * np.cos(ang), 200 + 3 * np.sin(ang))
    for i, ang in zip(range(42, 48), np.linspace(0, 2 * np.pi, 6, endpoint=False)):
        lms[i] = (340 + 6 * np.cos(ang), 200 + 3 * np.sin(ang))
    lms[68] = (300, 200)
    lms[69] = (340, 200)
    gr, gl = gaze_from_landmarks(jnp.asarray(lms), jnp.asarray(T), FX, FY, CX, CY)
    assert float(gr[2]) > 0.9 and float(gl[2]) > 0.9


@pytest.mark.slow  # ~10-12 s on the 2-core CI host (CI-budget triage, r5)
def test_landmark_net_and_decode_shapes():
    net = FaceLandmarkNet()
    params = net.init(jax.random.key(0), jnp.zeros((1, 64, 64, 1)))
    hm = net.apply(params, jnp.zeros((1, 64, 64, 1)))[0]
    assert hm.shape == (16, 16, NUM_FACE_LANDMARKS)
    lms, mask, score = decode_landmarks(hm, jnp.array([100.0, 50.0, 164.0, 114.0]))
    assert lms.shape == (NUM_FACE_LANDMARKS, 2)


def test_decode_landmarks_maps_to_crop():
    hm = jnp.zeros((16, 16, NUM_FACE_LANDMARKS))
    hm = hm.at[4, 8, 0].set(1.0)  # landmark 0 peak at (x=8, y=4)
    lms, mask, _ = decode_landmarks(hm, jnp.array([100.0, 50.0, 164.0, 114.0]))
    assert bool(mask[0])
    # heatmap 16px spans 64px -> scale 4; x = 100 + (8+.5)*4 = 134
    np.testing.assert_allclose(np.asarray(lms[0]), [134.0, 68.0], atol=0.6)


def test_au_head_shapes():
    net = ActionUnitHead()
    lms = jnp.zeros((NUM_FACE_LANDMARKS, 2))
    params = net.init(jax.random.key(0), lms)
    intensity, presence = net.apply(params, lms)
    assert intensity.shape == (len(AU_NAMES),)
    assert float(intensity.min()) >= 0 and float(intensity.max()) <= 5.0


def test_normalize_landmarks_invariance():
    rng = np.random.RandomState(0)
    lms = rng.rand(NUM_FACE_LANDMARKS, 2).astype(np.float32) * 100
    mask = np.ones(NUM_FACE_LANDMARKS, bool)
    n1 = normalize_landmarks(jnp.asarray(lms), jnp.asarray(mask))
    n2 = normalize_landmarks(jnp.asarray(lms * 3.0 + 50.0), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(n1), np.asarray(n2), atol=1e-5)


def test_au_gated_pose_mask():
    # Reference semantics (openface2_ros.cpp:467-476): pose published
    # only when AU02 (brow raiser) intensity > 2.0.
    from perception.models.face import au_gated_pose_mask

    i = np.zeros((3, len(AU_NAMES)), np.float32)
    au02 = AU_NAMES.index("AU02")
    i[0, au02] = 2.5
    i[1, au02] = 2.0   # boundary: strict >
    i[2, au02] = 0.1
    i[2, 0] = 5.0      # other AUs never gate
    mask = np.asarray(au_gated_pose_mask(jnp.asarray(i)))
    assert mask.tolist() == [True, False, False]
