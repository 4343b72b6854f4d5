"""Example 11 — the fully TRAINED face stack from raw pixels.

Where example 04 synthesizes landmarks from a known pose to demo the
geometry, this one runs the complete learned pipeline on a rendered
image with the in-repo-trained fixture
(tests/fixtures/facenet_tiny.msgpack — tools/train_face_fixture.py):

  pixels -> FaceDetectorNet (center heatmap, the MTCNN analog)
         -> crop -> FaceLandmarkNet (70 heatmaps) -> decode
         -> head-pose PnP -> gaze rays -> ActionUnitHead -> AU02 gate

the openface2_ros topology end to end (openface2_ros.cpp:198-490),
with no ground-truth inputs anywhere in the pipeline.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples._common import setup_backend  # noqa: E402

setup_backend()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main() -> None:
    from perception.models import face_fixture as FF
    from perception.models.face import (
        au_gated_pose_mask,
        gaze_from_landmarks,
        head_pose_pnp,
        normalize_landmarks,
    )
    from perception.models.face_data import render_face, sample_face
    from perception.models.hand import crop_image

    if not FF.fixture_available():
        print("face fixture missing — run tools/train_face_fixture.py")
        return

    params = FF.load_fixture()
    hw = FF.FIXTURE_HW
    fx = FF.FIXTURE_FX
    cx, cy = hw[1] / 2.0, hw[0] / 2.0

    for i in range(3):
        k1, k2 = jax.random.split(jax.random.fold_in(jax.random.key(0), i))
        scene = sample_face(k1, hw, fx, fx)
        img = render_face(scene, hw, key=k2)

        det = FF.detect_with_net(params["det"], img)
        assert bool(det.mask[0]), "trained detector found no face"
        box = det.boxes[0]
        patch = crop_image(img, box, FF.FIXTURE_CROP) / 255.0
        uv, m, _ = FF.landmarks_from_crop(params["landmark"], patch, box)
        T, px_err = head_pose_pnp(uv, m, fx, fx, cx, cy)
        gaze_r, gaze_l = gaze_from_landmarks(uv, T, fx, fx, cx, cy)
        inten, _ = FF.tiny_au_head().apply(
            params["au"], normalize_landmarks(uv, m)
        )
        gate = bool(au_gated_pose_mask(inten))

        t_err = float(jnp.linalg.norm(T[:3, 3] - scene.pose[:3, 3]))
        lm_err = float(
            jnp.mean(
                jnp.where(m, jnp.linalg.norm(uv - scene.landmarks2d, axis=-1), 0.0)
            )
        )
        print(
            f"face {i}: {int(jnp.sum(m))}/70 landmarks (err {lm_err:.2f} px), "
            f"head at {np.round(np.asarray(T[:3, 3]), 3)} "
            f"(gt err {t_err*100:.1f} cm, reproj {float(px_err):.2f} px), "
            f"gaze_z ({float(gaze_r[2]):+.2f}, {float(gaze_l[2]):+.2f}), "
            f"AU02 {float(inten[1]):.2f} -> publish={gate} "
            f"(brow raise gt {float(scene.au02):.2f})"
        )
        assert t_err < 0.05
        assert gate == (float(scene.au02) > 0.4)
    print("ok")




def main_facade() -> None:
    """The trained face pipeline through the Perception facade."""
    import numpy as np

    from perception.models import face_fixture as FF
    from perception.wrapper import (
        Perception,
        WrapperStructFace,
        WrapperStructPose,
    )

    if not FF.fixture_available():
        print("facade demo skipped (face fixture missing)")
        return
    engine = Perception(pose=WrapperStructPose(enabled=False),
                        face=WrapperStructFace(enabled=True))
    img = np.random.RandomState(3).rand(128, 128, 3).astype(np.float32) * 255
    datum = engine.emplace_and_pop(img)
    # Slot 0 of the (max_faces, ...) multi-face outputs.
    print(f"facade face: reproj {float(datum.faces['reproj_px'][0]):.2f} px, "
          f"AU02 {float(datum.faces['au_intensities'][0, 1]):.2f}")


if __name__ == "__main__":
    main()
    main_facade()
