"""End-to-end pose proof: raw image -> CNN -> NMS -> PAF -> skeletons
with in-repo trained weights (tests/fixtures/posenet_mpi15_tiny.msgpack,
trained by tools/train_pose_fixture.py on synthetic scenes).

This is the capability the reference demonstrates with downloaded
.caffemodels (netCaffe.cpp:142-169 + poseExtractorCaffe.cpp:202-340):
the full image->people path, not a synthetic-heatmap decode test."""

import jax
import numpy as np
import pytest

from perception.models.pose_fixture import (
    evaluate_pck,
    fixture_available,
    load_fixture,
)

pytestmark = [pytest.mark.slow, pytest.mark.skipif(
    not fixture_available(), reason="pose fixture not trained"
)]


def test_trained_net_recovers_skeletons_from_images():
    params = load_fixture()
    # Fresh scenes: a key never seen in training or model selection.
    pck, recall = evaluate_pck(params, jax.random.key(1234), n_scenes=6)
    assert recall >= 0.9, f"person recall {recall:.2f}"
    assert pck >= 0.75, f"joint PCK {pck:.2f}"


def test_trained_net_multi_person_separation():
    """Two people in one frame must come out as two distinct skeletons."""
    import jax.numpy as jnp

    from perception.models.pose import extract_people
    from perception.models.pose_data import SkeletonScene, render_people
    from perception.models.pose_fixture import FIXTURE_HW, tiny_posenet

    params = load_fixture()
    # Hand-placed, well-separated pair.
    from perception.models.pose_data import _CANONICAL_MPI15

    base = np.asarray(_CANONICAL_MPI15)
    j1 = base * 60 + np.array([8.0, 30.0])
    j2 = base * 60 + np.array([68.0, 30.0])
    scene = SkeletonScene(
        joints=jnp.asarray(np.stack([j1, j2]), jnp.float32),
        valid=jnp.array([True, True]),
    )
    img = render_people(scene, FIXTURE_HW)
    ppl = extract_people(
        params, img, topology="MPI_15", net_hw=FIXTURE_HW,
        net=tiny_posenet(), peak_threshold=0.2, min_person_parts=5,
    )
    assert int(np.asarray(ppl.mask).sum()) == 2
    kp = np.asarray(ppl.keypoints)
    pm = np.asarray(ppl.mask)
    # Each GT person matched by a distinct detection (match by mean
    # distance over present joints).
    off = 8 / 2.0 - 0.5
    used = set()
    for gt in (j1, j2):
        best, best_d = None, np.inf
        for m in range(kp.shape[0]):
            if not pm[m] or m in used:
                continue
            present = kp[m, :, 2] > 0
            if present.sum() < 5:
                continue
            d = np.linalg.norm(kp[m, :, :2] - off - gt, axis=-1)[present].mean()
            if d < best_d:
                best, best_d = m, d
        assert best is not None and best_d < 8.0, f"unmatched person (d={best_d:.1f})"
        used.add(best)
