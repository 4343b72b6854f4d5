"""Topology zoo structure tests vs the reference's declared sizes
(poseParameters.cpp POSE_NUMBER_BODY_PARTS / POSE_BODY_PART_PAIRS) and
the official COCO keypoint JSON round-trip (CocoJsonSaver capability)."""

import numpy as np
import pytest

from perception.models.topologies import (
    FULL_ZOO,
    REFERENCE_NUM_PARTS,
    get_topology,
)


@pytest.mark.parametrize("name", sorted(REFERENCE_NUM_PARTS))
def test_part_counts_match_reference(name):
    parts, pairs = get_topology(name)
    assert len(parts) == REFERENCE_NUM_PARTS[name]
    assert len(set(parts)) == len(parts), "duplicate part names"


@pytest.mark.parametrize("name", sorted(FULL_ZOO))
def test_pairs_are_valid_and_connected(name):
    parts, pairs = FULL_ZOO[name]
    P = len(parts)
    assert pairs.dtype == np.int32 and pairs.ndim == 2 and pairs.shape[1] == 2
    assert pairs.min() >= 0 and pairs.max() < P
    assert not np.any(pairs[:, 0] == pairs[:, 1]), "self-loop limb"
    # No duplicate limbs (as unordered pairs).
    canon = {tuple(sorted(p)) for p in pairs.tolist()}
    assert len(canon) == len(pairs)
    # The limb graph must connect every part into one skeleton
    # (union-find over pairs).
    parent = list(range(P))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in pairs.tolist():
        parent[find(a)] = find(b)
    roots = {find(i) for i in range(P)}
    assert len(roots) == 1, f"{name}: skeleton graph has {len(roots)} components"


def test_body_135_block_structure():
    parts, pairs = get_topology("BODY_135")
    # body(25) + left hand(20) + right hand(20) + face(70)
    assert parts[25] == "LThumb1CMC"
    assert parts[45] == "RThumb1CMC"
    assert parts[65] == "FaceContour0"
    assert parts[133] == "RPupil" and parts[134] == "LPupil"
    # Left-hand block links only to LWrist (body idx 9) outside itself.
    hand = set(range(25, 45))
    external = {
        a if b in hand else b
        for a, b in pairs.tolist()
        if (a in hand) != (b in hand)
    }
    assert external == {9}
    # Eyebrow numbering is mirrored: LEyeBrow runs 4..0.
    brow = parts[65 + 17 : 65 + 27]
    assert brow == [
        "REyeBrow0", "REyeBrow1", "REyeBrow2", "REyeBrow3", "REyeBrow4",
        "LEyeBrow4", "LEyeBrow3", "LEyeBrow2", "LEyeBrow1", "LEyeBrow0",
    ]


def test_zoo_plugs_into_posenet():
    import jax

    from perception.models.pose import PoseNet, lookup_topology

    parts, pairs = lookup_topology("BODY_25B")
    net = PoseNet(num_parts=len(parts), num_limbs=len(pairs), num_stages=1,
                  backbone_widths=(8, 8, 8))
    params = net.init(jax.random.key(0), np.zeros((1, 64, 64, 3), np.float32))
    paf, hm = net.apply(params, np.zeros((1, 64, 64, 3), np.float32))
    assert paf.shape[-1] == 2 * len(pairs)
    assert hm.shape[-1] == len(parts) + 1


def test_coco_json_roundtrip(tmp_path):
    from perception.io.savers import (
        coco_keypoint_results,
        coco_results_to_keypoints,
        load_coco_json,
        save_coco_json,
    )

    rng = np.random.default_rng(0)
    P = 17  # official COCO person category keypoint count
    kps = rng.uniform(0, 640, size=(3, P, 3)).astype(np.float32)
    kps[:, :, 2] = rng.uniform(0.2, 1.0, size=(3, P))
    kps[1, 4, 2] = 0.0  # one invisible keypoint
    mask = np.array([True, True, False])
    scores = np.array([0.9, 0.7, 0.1], np.float32)

    results = coco_keypoint_results([7], [kps], [mask], [scores])
    assert len(results) == 2  # third person masked out
    # Official format: flat [x1, y1, v1, ...] with v in {0, 2}, plus
    # image_id / category_id / score.
    for r in results:
        assert set(r) == {"image_id", "category_id", "keypoints", "score"}
        assert len(r["keypoints"]) == 3 * P
        assert set(np.asarray(r["keypoints"]).reshape(-1, 3)[:, 2]) <= {0.0, 2.0}

    path = tmp_path / "results.json"
    save_coco_json(path, results)
    back = coco_results_to_keypoints(load_coco_json(path))
    got_kp, got_vis, got_scores = back[7]
    assert got_kp.shape == (2, P, 2)
    np.testing.assert_allclose(got_kp, kps[:2, :, :2], rtol=1e-6)
    assert not got_vis[1, 4] and got_vis[0].all()
    np.testing.assert_allclose(got_scores, scores[:2], rtol=1e-6)
