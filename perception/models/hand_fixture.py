"""Tiny trained hand fixture: config, save/load, evaluation.

Completes the fixture treatment across the extractor zoo (pose r2,
face r3, hand here): OpenPose's hand module wraps a downloaded
21-keypoint .caffemodel (``handExtractorCaffe.cpp``); this fixture
trains ``HandLandmarkNet`` in-repo on ``models/hand_data.py`` scenes,
ships as ``tests/fixtures/handnet_tiny.msgpack``, and is exercised by
``tests/test_hand_e2e.py`` (body keypoints -> ROI -> crop -> 21
landmarks, no GT inputs).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from perception.models.face import decode_landmarks
from perception.models.hand import HandLandmarkNet, crop_image

FIXTURE_HW = (96, 96)
FIXTURE_CROP = 64
FIXTURE_PATH = (
    Path(__file__).resolve().parents[2]
    / "tests" / "fixtures" / "handnet_tiny.msgpack"
)


def tiny_handnet() -> HandLandmarkNet:
    return HandLandmarkNet(width=24)


def init_tiny(key) -> dict:
    return tiny_handnet().init(
        key, jnp.zeros((1, FIXTURE_CROP, FIXTURE_CROP, 1), jnp.float32)
    )


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


def extract_hand_tiny(params, image, box):
    """Image + box -> (landmarks (21, 2) image px, mask, scores) via the
    fixture-sized net (models/hand.extract_hand uses the full-width
    architecture)."""
    patch = crop_image(image, box, FIXTURE_CROP)
    hm = tiny_handnet().apply(params, patch[None, ..., None] / 255.0)[0]
    return decode_landmarks(hm, box)


def evaluate(params, key, n_scenes: int = 12,
             pixel_noise: float = 0.0) -> float:
    """Mean landmark error (image px) over fresh scenes with GT boxes;
    ``pixel_noise`` (fraction of full scale) selects held-out noisy
    families for FIXTURES.md."""
    from perception.models.hand_data import hand_box, render_hand, sample_hand

    errs = []
    for i in range(n_scenes):
        k = jax.random.fold_in(key, i)
        k1, k2 = jax.random.split(k)
        scene = sample_hand(k1, FIXTURE_HW)
        img = render_hand(scene, FIXTURE_HW, key=k2)
        if pixel_noise > 0.0:
            img = jnp.clip(
                img + jax.random.normal(jax.random.fold_in(k2, 99),
                                        img.shape) * pixel_noise * 255.0,
                0.0, 255.0,
            )
        uv, m, _ = extract_hand_tiny(params, img, hand_box(scene.joints))
        e = jnp.linalg.norm(uv - scene.joints, axis=-1)
        errs.append(float(jnp.mean(jnp.where(m, e, jnp.nan))))
    return float(np.nanmean(errs))
