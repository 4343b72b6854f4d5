import jax
import jax.numpy as jnp
import numpy as np

from perception.ops.heatmap import gaussian_heatmap, nms_heatmap, resize_and_merge
from perception.ops.paf import (
    assemble_people,
    greedy_match,
    paf_pair_scores,
)
from perception.models.pose import (
    BODY_25_PAIRS,
    BODY_25_PARTS,
    COCO_18_PAIRS,
    decode_people,
    extract_people,
    init_posenet,
)


def test_nms_finds_gaussian_peaks():
    centers = jnp.array([[20.5, 30.25], [80.0, 15.0]])
    hm = gaussian_heatmap((64, 96), centers, sigma=2.0)  # (2, 64, 96)
    peaks = nms_heatmap(hm, threshold=0.3, max_peaks=8)
    assert bool(peaks.mask[0, 0]) and bool(peaks.mask[1, 0])
    # Subpixel refinement should land within ~0.2 px of the true center.
    np.testing.assert_allclose(np.asarray(peaks.xy[0, 0]), [20.5, 30.25], atol=0.2)
    np.testing.assert_allclose(np.asarray(peaks.xy[1, 0]), [80.0, 15.0], atol=0.2)
    # One peak per channel only.
    assert int(peaks.mask[0].sum()) == 1


def test_nms_threshold():
    hm = gaussian_heatmap((32, 32), jnp.array([[16.0, 16.0]])) * 0.04
    peaks = nms_heatmap(hm, threshold=0.05)
    assert int(peaks.mask.sum()) == 0


def test_resize_and_merge_average():
    a = jnp.zeros((1, 8, 8)).at[0, 2, 2].set(1.0)
    b = jnp.zeros((1, 8, 8)).at[0, 2, 2].set(3.0)
    merged = resize_and_merge(jnp.stack([a, b]), (8, 8))
    assert merged.shape == (1, 8, 8)
    np.testing.assert_allclose(merged[0, 2, 2], 2.0)


def test_resize_and_merge_upsamples():
    hm = gaussian_heatmap((23, 31), jnp.array([[15.0, 11.0]]), sigma=1.5)
    merged = resize_and_merge(hm[None], (184, 248))
    assert merged.shape == (1, 184, 248)
    # Peak roughly at the scaled position.
    idx = jnp.argmax(merged[0])
    py, px = int(idx) // 248, int(idx) % 248
    assert abs(px - 15 * 8) <= 8 and abs(py - 11 * 8) <= 8


def synthetic_limb_field(hw, a, b, width=3.0):
    """PAF (2, H, W) pointing from a to b along the segment."""
    H, W = hw
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    p = np.stack([xx, yy], -1).astype(np.float64)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = b - a
    L = np.linalg.norm(d)
    u = d / L
    rel = p - a
    t = rel @ u
    perp = np.abs(rel @ np.array([-u[1], u[0]]))
    on = (t >= 0) & (t <= L) & (perp <= width)
    fx = np.where(on, u[0], 0.0)
    fy = np.where(on, u[1], 0.0)
    return jnp.asarray(np.stack([fx, fy]), jnp.float32)


def test_paf_pair_scores_true_pair_wins():
    field = synthetic_limb_field((64, 96), (20, 20), (70, 45))
    a_xy = jnp.array([[20.0, 20.0], [20.0, 50.0]])  # second is a decoy
    b_xy = jnp.array([[70.0, 45.0], [85.0, 10.0]])
    m = jnp.ones(2, bool)
    s = paf_pair_scores(field[0], field[1], a_xy, m, b_xy, m)
    assert float(s[0, 0]) > 0.9
    assert float(s[0, 1]) < 0.5
    assert float(s[1, 0]) < 0.5


def test_greedy_match_one_to_one():
    scores = jnp.array([
        [0.9, 0.2, -1.0],
        [0.8, 0.85, -1.0],
        [-1.0, -1.0, -1.0],
    ])
    m = greedy_match(scores, max_connections=3)
    got = {(int(a), int(b)) for a, b, ok in zip(m.a_idx, m.b_idx, m.mask) if bool(ok)}
    # Greedy: (0,0)=0.9 first, then (1,1)=0.85.
    assert got == {(0, 0), (1, 1)}


def test_decode_two_people():
    # Two 3-part "people" (parts 0-1-2, limbs 0-1 and 1-2).
    H, W = 96, 128
    pairs = jnp.asarray(np.array([(0, 1), (1, 2)], np.int32))
    pA = [(30.0, 20.0), (30.0, 45.0), (30.0, 70.0)]   # person A (x const)
    pB = [(90.0, 25.0), (90.0, 50.0), (90.0, 75.0)]   # person B
    hms = []
    for part in range(3):
        centers = jnp.array([pA[part], pB[part]])
        hms.append(gaussian_heatmap((H, W), centers, sigma=2.0).max(axis=0))
    hms = jnp.stack(hms)
    pafs = []
    for (a, b) in [(0, 1), (1, 2)]:
        fa = synthetic_limb_field((H, W), pA[a], pA[b])
        fb = synthetic_limb_field((H, W), pB[a], pB[b])
        f = fa + fb
        pafs.extend([f[0], f[1]])
    pafs = jnp.stack(pafs)

    people = decode_people(
        pafs, hms, pairs, num_parts=3, max_peaks=8, max_people=4,
        peak_threshold=0.3, min_person_parts=3,
    )
    assert int(people.mask.sum()) == 2
    kps = np.asarray(people.keypoints)[np.asarray(people.mask)]
    xs = np.sort(kps[:, :, 0].mean(axis=1))
    np.testing.assert_allclose(xs, [30.0, 90.0], atol=1.0)
    # Each person has all 3 parts with sane y-ordering.
    for p in kps:
        assert (np.diff(p[:, 1]) > 0).all()


def test_posenet_shapes_and_extract():
    params = init_posenet(jax.random.key(0), "COCO_18", net_hw=(64, 64))
    img = jnp.zeros((80, 100, 3))
    people = extract_people(
        params, img, topology="COCO_18", net_hw=(64, 64),
        max_peaks=8, max_people=4,
    )
    # Random weights: shape/type contract only.
    assert people.keypoints.shape == (4, 18, 3)
    assert people.mask.shape == (4,)


def test_topologies_consistent():
    assert len(BODY_25_PARTS) == 25
    assert BODY_25_PAIRS.max() == 24
    assert COCO_18_PAIRS.max() == 17
    # every part except root appears in some pair
    assert set(BODY_25_PAIRS.flatten()) == set(range(25))
