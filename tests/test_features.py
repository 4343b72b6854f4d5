import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry import se3
from perception.ops.features import (
    Keypoints,
    brief_describe,
    fast_detect,
    match_descriptors,
)
from perception.ops.registration import ransac_rigid


def checkerboard(h=120, w=160, sq=20):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (((yy // sq) + (xx // sq)) % 2 * 200.0 + 20.0).astype(np.float32)


def blobs_image(h=120, w=160, n=12, seed=0):
    rng = np.random.RandomState(seed)
    img = np.full((h, w), 50.0, np.float32)
    for _ in range(n):
        y, x = rng.randint(25, h - 25), rng.randint(25, w - 25)
        s = rng.randint(4, 9)
        img[y - s : y + s, x - s : x + s] = 220.0
    return img


def test_fast_finds_square_corners():
    # A FAST corner needs a contiguous arc >= 9; an isolated square's
    # L-corners qualify (checkerboard X-junctions famously do NOT —
    # their arc is exactly 8).
    img = np.full((120, 160), 40.0, np.float32)
    img[40:80, 50:110] = 220.0
    kps = fast_detect(jnp.asarray(img), threshold=30.0, max_keypoints=64)
    n = int(kps.mask.sum())
    assert n >= 4
    uv = np.asarray(kps.uv)[np.asarray(kps.mask)]
    corners = np.array([[50, 40], [109, 40], [50, 79], [109, 79]], np.float32)
    for c in corners:
        assert np.linalg.norm(uv - c, axis=1).min() <= 3.0


def test_fast_rejects_checkerboard_x_junctions():
    img = checkerboard()
    kps = fast_detect(jnp.asarray(img), threshold=30.0, max_keypoints=256)
    assert int(kps.mask.sum()) == 0


def test_fast_flat_image_no_corners():
    img = jnp.full((100, 100), 100.0)
    kps = fast_detect(img, threshold=20.0)
    assert int(kps.mask.sum()) == 0


def test_fast_respects_border():
    img = checkerboard()
    kps = fast_detect(jnp.asarray(img), threshold=30.0, border=16)
    uv = np.asarray(kps.uv)[np.asarray(kps.mask)]
    assert (uv[:, 0] >= 16).all() and (uv[:, 0] < 160 - 16).all()
    assert (uv[:, 1] >= 16).all() and (uv[:, 1] < 120 - 16).all()


def test_brief_deterministic_and_packed():
    img = jnp.asarray(blobs_image())
    kps = fast_detect(img, threshold=30.0, max_keypoints=64)
    d1 = brief_describe(img, kps)
    d2 = brief_describe(img, kps)
    assert d1.shape == (64, 8) and d1.dtype == jnp.uint32
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_match_identical_sets():
    img = jnp.asarray(blobs_image())
    kps = fast_detect(img, threshold=30.0, max_keypoints=64)
    d = brief_describe(img, kps)
    m = match_descriptors(d, kps.mask, d, kps.mask, max_matches=64)
    got = int(m.mask.sum())
    # Identical blobs produce identical descriptors; mutual-best drops
    # such ties, so only require a healthy majority to self-match.
    assert got >= int(kps.mask.sum()) * 3 // 4
    ia = np.asarray(m.idx_a)[np.asarray(m.mask)]
    ib = np.asarray(m.idx_b)[np.asarray(m.mask)]
    np.testing.assert_array_equal(ia, ib)  # self-match is the identity
    assert (np.asarray(m.distance)[np.asarray(m.mask)] == 0).all()


def test_match_translated_image():
    base = blobs_image(seed=3)
    shifted = np.roll(base, (7, 11), (0, 1))
    i1, i2 = jnp.asarray(base), jnp.asarray(shifted)
    k1 = fast_detect(i1, threshold=30.0, max_keypoints=128)
    k2 = fast_detect(i2, threshold=30.0, max_keypoints=128)
    d1 = brief_describe(i1, k1)
    d2 = brief_describe(i2, k2)
    m = match_descriptors(d1, k1.mask, d2, k2.mask, max_matches=128)
    assert int(m.mask.sum()) >= 8
    mm = np.asarray(m.mask)
    uv1 = np.asarray(k1.uv)[np.asarray(m.idx_a)[mm]]
    uv2 = np.asarray(k2.uv)[np.asarray(m.idx_b)[mm]]
    disp = uv2 - uv1
    # Majority displacement should be (11, 7) (x, y).
    med = np.median(disp, axis=0)
    np.testing.assert_allclose(med, [11, 7], atol=1.5)


def test_ransac_rigid_recovers_transform():
    rng = np.random.RandomState(0)
    src = rng.randn(100, 3).astype(np.float32)
    T = np.asarray(se3.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.1, 0.2, -0.1], jnp.float32)))
    dst = src @ T[:3, :3].T + T[:3, 3]
    # 30% outliers
    dst[:30] += rng.randn(30, 3) * 2.0
    mask = np.ones(100, bool)
    fit = ransac_rigid(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
                       jax.random.key(0), threshold=0.02)
    assert bool(fit.valid)
    assert int(fit.num_inliers) >= 65
    np.testing.assert_allclose(np.asarray(fit.transform), T, atol=5e-3)


def test_ransac_rigid_all_masked_invalid():
    src = jnp.zeros((20, 3))
    fit = ransac_rigid(src, src, jnp.zeros(20, bool), jax.random.key(1))
    assert not bool(fit.valid)
