"""Tiny trained face fixture: landmark net + AU head, save/load/eval.

Mirrors ``models/pose_fixture.py`` (VERDICT r2 item 3: "train and ship a
face fixture, mirroring the pose one"): the reference's capability comes
from downloaded CLNF/MTCNN/AU models (``openface2_ros.cpp:145-196``); in
a zero-egress build the capability proof is a tiny ``FaceLandmarkNet`` +
``ActionUnitHead`` trained in-repo on the synthetic face scenes of
``models/face_data.py``, shipped as
``tests/fixtures/facenet_tiny.msgpack`` and exercised end to end —
pixels -> detect -> 70 landmarks -> head-pose PnP -> gaze -> AU02 gate —
by ``tests/test_face_e2e.py``. Train with
``tools/train_face_fixture.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from perception.models.face import (
    ActionUnitHead,
    FaceLandmarkNet,
    decode_landmarks,
    normalize_landmarks,
)
from perception.models.face_detect import (
    FaceDetectorNet,
    decode_detector_net,
)

FIXTURE_HW = (128, 128)     # full-image render size used in training
FIXTURE_CROP = 96           # landmark-net input crop
FIXTURE_FX = 300.0
FIXTURE_PATH = (
    Path(__file__).resolve().parents[2]
    / "tests" / "fixtures" / "facenet_tiny.msgpack"
)


def tiny_facenet() -> FaceLandmarkNet:
    """Fixture architecture: narrow FaceLandmarkNet (~0.2 M params,
    <0.5 MB at f16) — small enough to train in minutes and commit."""
    return FaceLandmarkNet(width=24)


def tiny_au_head() -> ActionUnitHead:
    return ActionUnitHead(hidden=64)


def tiny_detector() -> FaceDetectorNet:
    """Trained center-heatmap detector — the MTCNN-capability analog
    (the classical contrast detector in face_detect.detect_faces fires
    on these renders but localizes eye sub-windows, not face boxes)."""
    return FaceDetectorNet(features=(16, 32, 64))


def init_tiny(key) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    lm = tiny_facenet().init(
        k1, jnp.zeros((1, FIXTURE_CROP, FIXTURE_CROP, 1), jnp.float32)
    )
    au = tiny_au_head().init(k2, jnp.zeros((70, 2), jnp.float32))
    det = tiny_detector().init(
        k3, jnp.zeros(FIXTURE_HW + (1,), jnp.float32)
    )
    return {"landmark": lm, "au": au, "det": det}


def detect_with_net(det_params, gray, threshold: float = 0.3, max_faces: int = 4):
    """Full-image gray [0,255] -> FaceDetections via the trained
    detector (heat is MSE-trained against a [0,1] Gaussian, so the
    peak threshold is on that scale)."""
    heat, size = tiny_detector().apply(det_params, gray[..., None] / 255.0)
    return decode_detector_net(heat, size, threshold=threshold, max_faces=max_faces)


def save_fixture(params, path=FIXTURE_PATH) -> None:
    from flax import serialization

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    half = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float16), params)
    path.write_bytes(serialization.to_bytes(half))


def load_fixture(path=FIXTURE_PATH) -> dict:
    from flax import serialization

    template = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float16), init_tiny(jax.random.key(0))
    )
    half = serialization.from_bytes(template, Path(path).read_bytes())
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), half)


def fixture_available() -> bool:
    return FIXTURE_PATH.exists()


def landmarks_from_crop(lm_params, patch, box):
    """(S, S) crop in [0,1] + its image-space box -> image-space
    landmarks (70, 2) + validity + scores."""
    maps = tiny_facenet().apply(lm_params, patch[None, ..., None])[0]
    return decode_landmarks(maps, box)


def evaluate(params, key, n_scenes: int = 16, rot_range: float = 0.30,
             z_range=(0.45, 0.75), pixel_noise: float = 0.0
             ) -> Tuple[float, float, float]:
    """(mean landmark error in image px on GT crops, AU02 separation =
    min intensity on raised brows - max on neutral, mean detector IoU
    vs the GT face box).

    ``rot_range``/``z_range``/``pixel_noise`` select held-out scene
    families (training used the defaults and noise-free renders) for
    the robustness evidence in FIXTURES.md."""
    from perception.models.face import iou as box_iou
    from perception.models.face_data import (
        crop_box_from_landmarks,
        render_face,
        sample_face,
    )
    from perception.models.hand import crop_image

    errs = []
    raised, neutral = [], []
    ious = []
    for i in range(n_scenes):
        k = jax.random.fold_in(key, i)
        k1, k2 = jax.random.split(k)
        scene = sample_face(k1, FIXTURE_HW, FIXTURE_FX, FIXTURE_FX,
                            rot_range=rot_range, z_range=z_range)
        img = render_face(scene, FIXTURE_HW, key=k2)
        if pixel_noise > 0.0:
            img = jnp.clip(
                img + jax.random.normal(jax.random.fold_in(k2, 99),
                                        img.shape) * pixel_noise * 255.0,
                0.0, 255.0,
            )
        box = crop_box_from_landmarks(scene.landmarks2d)
        patch = crop_image(img, box, FIXTURE_CROP) / 255.0
        uv, m, _ = landmarks_from_crop(params["landmark"], patch, box)
        e = jnp.linalg.norm(uv - scene.landmarks2d, axis=-1)
        errs.append(float(jnp.mean(jnp.where(m, e, jnp.nan))))

        inten, _ = tiny_au_head().apply(
            params["au"], normalize_landmarks(uv, m)
        )
        au02 = float(inten[1])  # AU_NAMES.index("AU02") == 1
        if float(scene.au02) > 0.5:
            raised.append(au02)
        else:
            neutral.append(au02)

        det = detect_with_net(params["det"], img)
        ious.append(
            float(box_iou(det.boxes[0], box)) if bool(det.mask[0]) else 0.0
        )
    err_px = float(np.nanmean(errs))
    sep = (min(raised) - max(neutral)) if raised and neutral else float("nan")
    return err_px, sep, float(np.mean(ious))
