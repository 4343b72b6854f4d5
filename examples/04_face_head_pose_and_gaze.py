"""Example 04 — face detection -> landmarks -> head pose + gaze.

The openface2_ros flow (openface2_ros.cpp:145-490): detect faces in
the image (MTCNN with Haar/HOG fallback there; the multi-scale
Haar-contrast detector here — no body pose needed), then 68+2
landmarks -> 6-DoF head pose (GN PnP on a rigid 6-point face model,
the GetPose equivalent) -> per-eye gaze vectors -> action-unit readout
schema. The landmarks are synthesized from a known head pose so the
recovered pose can be checked; in the full pipeline they come from
`FaceLandmarkNet` heatmaps via the shared subpixel NMS decoder.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples._common import setup_backend, print_pose  # noqa: E402

setup_backend()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from perception.geometry import se3  # noqa: E402
from perception.models.face import (  # noqa: E402
    PNP_LANDMARK_IDS,
    PNP_MODEL_POINTS,
    gaze_from_landmarks,
    head_pose_pnp,
    non_overlapping_detections,
)


def main() -> None:
    fx = fy = 615.0
    cx, cy = 320.0, 240.0

    # --- image-based face detection (no pose input) --------------------
    from perception.models.face_detect import detect_faces
    from tests.test_face_detect import render_face

    img, gt_box = render_face(H=240, W=320, cx=160, cy=120, size=48)
    dets = detect_faces(jnp.asarray(img))
    got = np.asarray(dets.boxes)[np.asarray(dets.mask)]
    assert len(got) >= 1, "face detector found nothing"
    b = got[0]
    print(f"detected face box: ({b[0]:.0f},{b[1]:.0f})-({b[2]:.0f},{b[3]:.0f}) "
          f"(gt {gt_box.round(0)})")

    # Ground-truth head pose: 0.7 m out, slight yaw + tilt.
    T_gt = np.asarray(se3.se3_exp(jnp.asarray([0.05, -0.02, 0.7, 0.05, 0.3, 0.0])))

    # Synthesize the 70-landmark array: project the 6 rigid model points
    # into the image at their landmark slots; park the rest near the
    # face center so the gaze ring lookups stay in range.
    pts_cam = PNP_MODEL_POINTS @ T_gt[:3, :3].T + T_gt[:3, 3]
    uv6 = np.stack([fx * pts_cam[:, 0] / pts_cam[:, 2] + cx,
                    fy * pts_cam[:, 1] / pts_cam[:, 2] + cy], -1)
    landmarks = np.full((70, 2), [cx, cy], np.float32)
    landmarks[PNP_LANDMARK_IDS] = uv6
    # Eye rings + pupils (looking slightly right).
    landmarks[36:42] = uv6[2] + np.array([[-8, 0], [-4, -3], [4, -3], [8, 0], [4, 3], [-4, 3]])
    landmarks[42:48] = uv6[3] + np.array([[-8, 0], [-4, -3], [4, -3], [8, 0], [4, 3], [-4, 3]])
    landmarks[68] = uv6[2] + np.array([2.0, 0.0])
    landmarks[69] = uv6[3] + np.array([2.0, 0.0])
    # Landmarks 36/45 are both eye-ring corners AND PnP points — keep
    # their exact projections so the pose solve stays consistent.
    landmarks[PNP_LANDMARK_IDS] = uv6
    lm_mask = np.ones(70, bool)

    T_est, reproj_err = jax.jit(
        lambda lm, m: head_pose_pnp(lm, m, fx, fy, cx, cy, iterations=40)
    )(jnp.asarray(landmarks), jnp.asarray(lm_mask))
    print_pose("camera<-head (estimated)", T_est)
    t_err = float(jnp.linalg.norm(T_est[:3, 3] - jnp.asarray(T_gt[:3, 3])))
    print(f"reprojection error = {float(reproj_err):.3f} px, "
          f"translation error vs GT = {t_err * 1000:.1f} mm")
    assert t_err < 0.02 and float(reproj_err) < 1.0

    gaze_r, gaze_l = gaze_from_landmarks(jnp.asarray(landmarks), T_est, fx, fy, cx, cy)
    print(f"gaze right = {np.asarray(gaze_r).round(3)}  left = {np.asarray(gaze_l).round(3)}")

    # Multi-face dedup (NonOverlapingDetections, IoU > 0.5 with a live
    # tracker suppressed): one tracker already covers the first box.
    tracks = jnp.asarray([[100.0, 100, 200, 200]])
    dets = jnp.asarray([[110.0, 105, 205, 210], [400.0, 80, 470, 160]])
    keep = non_overlapping_detections(tracks, jnp.ones(1, bool), dets, jnp.ones(2, bool))
    print(f"non_overlapping_detections keeps {int(keep.sum())} of 2 detections")
    assert int(keep.sum()) == 1




def main_facade() -> None:
    """Same stack via the Perception facade (wrapper.py) — the
    Wrapper::configure/exec surface of the reference; face/hand ride
    the trained fixtures when present."""
    import numpy as np

    from perception.models import face_fixture as FF
    from perception.models import hand_fixture as HF
    from perception.models import pose_fixture as PF
    from perception.wrapper import (
        Perception,
        WrapperStructFace,
        WrapperStructHand,
        WrapperStructInput,
        WrapperStructPose,
    )

    if not (PF.fixture_available() and FF.fixture_available()
            and HF.fixture_available()):
        print("facade demo skipped (fixtures missing)")
        return
    frames = [np.random.RandomState(7).rand(128, 128, 3).astype(np.float32)]
    engine = Perception(
        pose=WrapperStructPose(topology=PF.FIXTURE_TOPOLOGY, net_hw=PF.FIXTURE_HW),
        face=WrapperStructFace(enabled=True),
        hand=WrapperStructHand(enabled=True),
        input=WrapperStructInput(source=frames),
    )
    for datum in engine.exec():
        # Multi-face facade outputs are (max_faces, ...) slot arrays.
        print(f"facade: people={int(np.asarray(datum.people.mask).sum())}, "
              f"faces={int(np.asarray(datum.faces['mask']).sum())}, "
              f"face reproj={float(datum.faces['reproj_px'][0]):.2f} px, "
              f"hand lms={int(np.asarray(datum.hands['landmark_mask']).sum())}")


if __name__ == "__main__":
    main()
    main_facade()
