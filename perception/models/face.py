"""Face analysis: landmarks, head pose, gaze, action units.

Equivalent of the reference's OpenFace 2 wrapper
(``openface2_ros/src/openface2_ros.cpp``) plus OpenPose's face module:

  * ``face_roi_from_pose`` — derive the face box from body keypoints
    (nose/eyes/ears), the reference ``FaceDetector`` approach;
  * ``non_overlapping_detections`` — IoU > 0.5 dedup of candidate boxes
    against live tracks (``NonOverlapingDetections``,
    ``openface2_ros.cpp:81-99``);
  * ``FaceLandmarkNet`` — 70-landmark heatmap CNN on a face crop (the
    OpenPose ``FaceExtractorCaffe`` topology: 68 contour/feature points
    + 2 pupils), decoded with the shared subpixel NMS;
  * ``head_pose_pnp`` — 6-DoF head pose from 2-D landmarks and a rigid
    3-D canonical face model, Gauss-Newton on the se(3) twist
    (replaces OpenFace ``GetPose``);
  * ``gaze_from_landmarks`` — per-eye gaze ray from eyeball center
    through the pupil landmark (OpenFace ``GazeAnalysis`` geometry);
  * ``ActionUnitHead`` — linear AU intensity/presence readout on
    pose-normalized landmark geometry (trainable; OpenFace predicts
    17 AUs from HOG+landmarks — the interface and output schema match,
    weights are learned separately).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry import se3
from perception.ops.heatmap import nms_heatmap

NUM_FACE_LANDMARKS = 70  # 68 + 2 pupils (OpenPose face model)

AU_NAMES = [
    "AU01", "AU02", "AU04", "AU05", "AU06", "AU07", "AU09", "AU10",
    "AU12", "AU14", "AU15", "AU17", "AU20", "AU23", "AU25", "AU26", "AU45",
]

# Minimal rigid 3-D face model (meters, head frame: x right, y down,
# z forward out of the face) for the PnP landmarks used by standard
# head-pose estimators: nose tip(30), chin(8), left/right eye outer
# corners(36, 45), mouth corners(48, 54).
PNP_LANDMARK_IDS = np.array([30, 8, 36, 45, 48, 54], np.int32)
PNP_MODEL_POINTS = np.array(
    [
        (0.0, 0.0, 0.0),          # nose tip
        (0.0, 0.066, -0.013),     # chin
        (-0.045, -0.034, -0.027), # right eye outer corner (image-left)
        (0.045, -0.034, -0.027),  # left eye outer corner
        (-0.029, 0.033, -0.024),  # mouth right
        (0.029, 0.033, -0.024),   # mouth left
    ],
    np.float32,
)

RIGHT_EYE_RING = np.arange(36, 42)
LEFT_EYE_RING = np.arange(42, 48)
RIGHT_PUPIL, LEFT_PUPIL = 68, 69


def face_roi_from_pose(keypoints: jax.Array, part_ids=(0, 15, 16, 17, 18)) -> jax.Array:
    """Body keypoints (P, 3) -> face box (x1, y1, x2, y2).

    Uses nose/eyes/ears (BODY_25 ids); box = centered square of
    1.5x the keypoint spread (the OpenPose FaceDetector heuristic)."""
    ids = jnp.asarray(part_ids)
    pts = keypoints[ids, :2]
    w = keypoints[ids, 2] > 0
    cnt = jnp.maximum(jnp.sum(w), 1)
    c = jnp.sum(pts * w[:, None], axis=0) / cnt
    spread = jnp.sqrt(
        jnp.sum(jnp.sum((pts - c) ** 2, axis=-1) * w) / cnt
    )
    half = jnp.maximum(spread * 1.5, 8.0)
    return jnp.array([c[0] - half, c[1] - half, c[0] + half, c[1] + half])


def iou(a: jax.Array, b: jax.Array) -> jax.Array:
    """IoU of boxes (..., 4) vs (..., 4)."""
    x1 = jnp.maximum(a[..., 0], b[..., 0])
    y1 = jnp.maximum(a[..., 1], b[..., 1])
    x2 = jnp.minimum(a[..., 2], b[..., 2])
    y2 = jnp.minimum(a[..., 3], b[..., 3])
    inter = jnp.maximum(x2 - x1, 0) * jnp.maximum(y2 - y1, 0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / jnp.maximum(area_a + area_b - inter, 1e-9)


def non_overlapping_detections(
    track_boxes: jax.Array, track_mask: jax.Array, det_boxes: jax.Array, det_mask: jax.Array,
    threshold: float = 0.5,
) -> jax.Array:
    """Keep detections whose IoU with every live track is <= threshold
    (openface2_ros.cpp:81-99)."""
    ious = iou(det_boxes[:, None, :], track_boxes[None, :, :])  # (D, T)
    clash = jnp.any((ious > threshold) & track_mask[None, :], axis=1)
    return det_mask & ~clash


class FaceLandmarkNet(nn.Module):
    """Heatmap CNN on a face crop: (N, S, S, 1|3) -> (N, S/4, S/4, 70)."""

    width: int = 64

    @nn.compact
    def __call__(self, x):
        for w in (self.width, self.width * 2):
            x = nn.Conv(w, (3, 3), padding="SAME")(x)
            x = nn.relu(x)
            x = nn.Conv(w, (3, 3), padding="SAME")(x)
            x = nn.relu(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = nn.Conv(self.width * 2, (3, 3), padding="SAME")(x)
        x = nn.relu(x)
        return nn.Conv(NUM_FACE_LANDMARKS, (1, 1))(x)


def decode_landmarks(heatmaps: jax.Array, crop_box: jax.Array, threshold: float = 0.05):
    """(H', W', 70) crop heatmaps -> (70, 2) image-space landmarks +
    (70,) validity, mapping through the crop box."""
    hm = jnp.transpose(heatmaps, (2, 0, 1))  # (70, H', W')
    peaks = nms_heatmap(hm, threshold=threshold, max_peaks=1)
    xy = peaks.xy[:, 0]   # (70, 2) in heatmap coords
    Hh, Wh = hm.shape[1:]
    x1, y1, x2, y2 = crop_box[0], crop_box[1], crop_box[2], crop_box[3]
    sx = (x2 - x1) / Wh
    sy = (y2 - y1) / Hh
    img_xy = jnp.stack([x1 + (xy[:, 0] + 0.5) * sx, y1 + (xy[:, 1] + 0.5) * sy], axis=-1)
    return img_xy, peaks.mask[:, 0], peaks.score[:, 0]


@functools.partial(jax.jit, static_argnames=("iterations",))
def head_pose_pnp(
    landmarks: jax.Array,   # (70, 2) image-space
    lm_mask: jax.Array,     # (70,)
    fx, fy, cx, cy,
    iterations: int = 10,
) -> Tuple[jax.Array, jax.Array]:
    """6-DoF head pose (camera <- head, (4, 4)) + mean reprojection
    error, via GN on the 6-point rigid model."""
    ids = jnp.asarray(PNP_LANDMARK_IDS)
    uv = landmarks[ids]
    w = lm_mask[ids].astype(jnp.float32)
    X = jnp.asarray(PNP_MODEL_POINTS)

    # Init: face ~0.6 m in front, centered on the observed points. GN
    # is raced from BOTH orientation hypotheses — identity and the
    # y-flip (subject facing the camera): the 6-point model is
    # near-planar enough that gradient descent from the wrong side
    # converges to the mirror solution, which projects almost as well
    # but reverses the head's forward axis (and with it every gaze ray).
    z0 = 0.6
    mean_uv = jnp.sum(uv * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1)
    t0 = jnp.array([(mean_uv[0] - cx) / fx * z0, (mean_uv[1] - cy) / fy * z0, z0])
    R_flip = se3.so3_exp(jnp.asarray([0.0, jnp.pi, 0.0]))
    T0s = jnp.stack([se3.make_T(jnp.eye(3), t0), se3.make_T(R_flip, t0)])

    def gn(T, _):
        pc = se3.transform_points(T, X)  # (6, 3)
        z = jnp.maximum(pc[:, 2], 1e-6)
        pred = jnp.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], axis=-1)
        r = (pred - uv) * w[:, None]
        zero = jnp.zeros_like(z)
        Jproj = jnp.stack(
            [
                jnp.stack([fx / z, zero, -fx * pc[:, 0] / (z * z)], axis=-1),
                jnp.stack([zero, fy / z, -fy * pc[:, 1] / (z * z)], axis=-1),
            ],
            axis=-2,
        )  # (6, 2, 3)
        I3 = jnp.broadcast_to(jnp.eye(3), (6, 3, 3))
        dpc = jnp.concatenate([I3, -se3.hat(pc)], axis=-1)  # (6, 3, 6)
        J = jnp.einsum("nab,nbc->nac", Jproj, dpc) * w[:, None, None]
        H = jnp.einsum("nai,naj->ij", J, J) + 1e-4 * jnp.eye(6)
        g = -jnp.einsum("nai,na->i", J, r)
        dxi = jnp.linalg.solve(H, g)
        return se3.se3_exp(dxi) @ T, None

    def solve_from(T0):
        T, _ = jax.lax.scan(gn, T0, None, length=iterations)
        pc = se3.transform_points(T, X)
        z = jnp.maximum(pc[:, 2], 1e-6)
        pred = jnp.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], axis=-1)
        err = jnp.sum(jnp.linalg.norm(pred - uv, axis=-1) * w) / jnp.maximum(
            jnp.sum(w), 1
        )
        return T, err

    Ts, errs = jax.vmap(solve_from)(T0s)
    # A diverged branch reports NaN; argmin must never select it.
    errs = jnp.where(jnp.isfinite(errs), errs, jnp.inf)
    best = jnp.argmin(errs)
    return Ts[best], errs[best]


def gaze_from_landmarks(
    landmarks: jax.Array,
    head_pose: jax.Array,
    fx, fy, cx, cy,
    eyeball_depth: float = 0.012,
) -> Tuple[jax.Array, jax.Array]:
    """Per-eye unit gaze vectors (camera frame): right (3,), left (3,).

    Geometry: the eyeball center sits behind the eye-ring centroid
    (along head +z reversed); gaze = normalized(pupil_3d - center_3d)
    with both points placed on the head-pose plane."""
    def eye_gaze(ring_ids, pupil_id):
        ring = landmarks[jnp.asarray(ring_ids)]
        center_2d = jnp.mean(ring, axis=0)
        pupil_2d = landmarks[pupil_id]
        # Back-project at the eye's depth from the head pose.
        z_eye = head_pose[2, 3]
        def bp(uv):
            return jnp.array([(uv[0] - cx) / fx * z_eye, (uv[1] - cy) / fy * z_eye, z_eye])
        center_3d = bp(center_2d) - head_pose[:3, 2] * eyeball_depth
        pupil_3d = bp(pupil_2d)
        g = pupil_3d - center_3d
        return g / jnp.maximum(jnp.linalg.norm(g), 1e-9)

    return eye_gaze(RIGHT_EYE_RING, RIGHT_PUPIL), eye_gaze(LEFT_EYE_RING, LEFT_PUPIL)


class ActionUnitHead(nn.Module):
    """AU intensity (17,) + presence logits (17,) from normalized
    landmark geometry (the OpenFace FaceAnalyser output schema)."""

    hidden: int = 64

    @nn.compact
    def __call__(self, landmarks_norm):  # (70, 2) pose-normalized
        x = landmarks_norm.reshape(-1)
        x = nn.relu(nn.Dense(self.hidden)(x))
        intensity = 5.0 * nn.sigmoid(nn.Dense(len(AU_NAMES))(x))
        presence = nn.Dense(len(AU_NAMES))(x)
        return intensity, presence


def normalize_landmarks(landmarks: jax.Array, lm_mask: jax.Array) -> jax.Array:
    """Translation/scale-normalize for the AU head."""
    w = lm_mask.astype(landmarks.dtype)[:, None]
    c = jnp.sum(landmarks * w, axis=0) / jnp.maximum(jnp.sum(w), 1)
    d = landmarks - c
    scale = jnp.sqrt(jnp.sum(d * d * w) / jnp.maximum(jnp.sum(w), 1))
    return d / jnp.maximum(scale, 1e-6)


def au_gated_pose_mask(
    intensities: jax.Array,
    au_name: str = "AU02",
    threshold: float = 2.0,
) -> jax.Array:
    """Per-face publish gate on an action-unit intensity.

    The reference emits the head ``PoseStamped`` only while the brow
    raiser fires: AU02 intensity > 2.0
    (``openface2_ros/src/openface2_ros.cpp:467-476``). ``intensities``
    is (..., len(AU_NAMES)) from ``ActionUnitHead``; returns a (...)
    bool mask — True where the pose should be emitted.

    Intentionally out of scope from that block: the reference also
    overwrites ``head_pose.position.z`` from a ROS TF lookup of the
    camera frame before publishing (``:472-474``) — a ROS-transport
    detail with no analog here, where ``head_pose_pnp`` already returns
    the pose in the metric camera frame (consumers composing additional
    frame transforms apply them to the returned (4, 4) directly).
    """
    return intensities[..., AU_NAMES.index(au_name)] > threshold
