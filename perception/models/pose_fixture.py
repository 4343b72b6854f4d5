"""Tiny trained PoseNet fixture: config, save/load, and PCK evaluation.

Proves the image -> CNN -> NMS -> PAF -> people path end-to-end with
weights trained *in-repo* on synthetic skeleton scenes
(``models/pose_data.py``): the capability the reference gets from
downloaded .caffemodels (``netCaffe.cpp:142-169`` +
``poseExtractorCaffe.cpp:202-340``). Train with
``tools/train_pose_fixture.py``; the result ships as
``tests/fixtures/posenet_mpi15_tiny.msgpack`` and is exercised by
``tests/test_pose_e2e.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from perception.models.pose import PoseNet, extract_people
from perception.models.pose_data import make_batch

FIXTURE_HW = (128, 128)
FIXTURE_TOPOLOGY = "MPI_15"
FIXTURE_PATH = (
    Path(__file__).resolve().parents[2]
    / "tests" / "fixtures" / "posenet_mpi15_tiny.msgpack"
)


def tiny_posenet() -> PoseNet:
    """The fixture architecture: a 2-stage PoseNet small enough to train
    in minutes and to commit (~1 MB of weights)."""
    return PoseNet(
        num_parts=15, num_limbs=14, num_stages=2,
        backbone_widths=(16, 24, 32), stage_width=64, stage_depth=3,
    )


def init_tiny(key) -> dict:
    net = tiny_posenet()
    return net.init(key, jnp.zeros((1,) + FIXTURE_HW + (3,), jnp.float32))


def save_fixture(params, path=FIXTURE_PATH) -> None:
    from flax import serialization

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    half = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float16), params
    )
    path.write_bytes(serialization.to_bytes(half))


def load_fixture(path=FIXTURE_PATH) -> dict:
    from flax import serialization

    template = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float16), init_tiny(jax.random.key(0))
    )
    half = serialization.from_bytes(template, Path(path).read_bytes())
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float32), half
    )


def fixture_available() -> bool:
    return FIXTURE_PATH.exists()


def evaluate_pck(
    params,
    key,
    n_scenes: int = 8,
    tol_px: float = 10.0,
    stride: int = 8,
) -> Tuple[float, float]:
    """PCK on fresh synthetic scenes: fraction of GT joints matched by a
    detected person's keypoint within ``tol_px`` (image pixels), plus
    the fraction of GT people detected at all.

    ``extract_people`` merges maps at net resolution (the reference's
    x8 resizeAndMerge), so keypoints arrive in image pixels already —
    up to the bilinear-resize half-pixel shift of (stride/2 - 0.5)."""
    batch = make_batch(key, n_scenes, FIXTURE_HW)
    return pck_on_images(
        params, np.asarray(batch["image"]), batch["scene"],
        tol_px=tol_px, stride=stride,
    )


def pck_on_images(params, images, scenes, tol_px: float = 10.0,
                  stride: int = 8):
    """PCK/recall on caller-provided (images, SkeletonScene batch) —
    the held-out-family robustness harness (tools/fixtures_robustness)
    feeds generator families the training run never produced."""
    n_scenes = images.shape[0]
    net = tiny_posenet()
    hits = total = found_people = total_people = 0
    for i in range(n_scenes):
        ppl = extract_people(
            params, jnp.asarray(images[i]), topology=FIXTURE_TOPOLOGY,
            net_hw=FIXTURE_HW, net=net, peak_threshold=0.2,
            min_person_parts=5,
        )
        kp = np.asarray(ppl.keypoints)   # (Pmax, P, 3) in map pixels
        pmask = np.asarray(ppl.mask)
        gt = np.asarray(scenes.joints[i])     # (N, P, 2) image pixels
        gvalid = np.asarray(scenes.valid[i])
        for n in range(gt.shape[0]):
            if not gvalid[n]:
                continue
            total_people += 1
            total += gt.shape[1]
            best = -1
            best_hits = 0
            for m in range(kp.shape[0]):
                if not pmask[m]:
                    continue
                pred = kp[m, :, :2] - (stride / 2.0 - 0.5)
                present = kp[m, :, 2] > 0
                d = np.linalg.norm(pred - gt[n], axis=-1)
                h = int(((d < tol_px) & present).sum())
                if h > best_hits:
                    best_hits, best = h, m
            if best >= 0 and best_hits >= 5:
                found_people += 1
            hits += best_hits
    pck = hits / max(total, 1)
    recall = found_people / max(total_people, 1)
    return pck, recall
