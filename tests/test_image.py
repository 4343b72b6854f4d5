import jax
import jax.numpy as jnp
import numpy as np
import cv2

from perception.ops.image import (
    rgb_to_hsv_cv,
    in_range,
    erode,
    dilate,
    largest_component_bbox,
    bilinear_resize,
)
from perception.models.color_detect import detect_red_object, red_mask
from perception.models.bbox_filter import filter_by_rect, project_P, project_bbox


def test_rgb_to_hsv_matches_opencv():
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (32, 32, 3), np.uint8)
    ours = np.asarray(rgb_to_hsv_cv(jnp.asarray(rgb)))
    theirs = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV).astype(np.float32)
    # H wraps at 180; compare circularly. OpenCV uint8 HSV rounds.
    dh = np.abs(ours[..., 0] - theirs[..., 0])
    dh = np.minimum(dh, 180 - dh)
    assert dh.max() <= 1.0
    assert np.abs(ours[..., 1] - theirs[..., 1]).max() <= 1.5
    assert np.abs(ours[..., 2] - theirs[..., 2]).max() <= 0.5


def test_morphology_matches_opencv():
    rng = np.random.RandomState(1)
    mask = (rng.rand(64, 64) > 0.7).astype(np.uint8) * 255
    kernel = np.ones((5, 5), np.uint8)
    cv_er = cv2.erode(mask, kernel, iterations=2) > 0
    cv_di = cv2.dilate(mask, kernel, iterations=2) > 0
    ours_er = np.asarray(erode(jnp.asarray(mask > 0), 5, 2))
    ours_di = np.asarray(dilate(jnp.asarray(mask > 0), 5, 2))
    np.testing.assert_array_equal(ours_er, cv_er)
    np.testing.assert_array_equal(ours_di, cv_di)


def test_largest_component_bbox():
    mask = np.zeros((50, 60), bool)
    mask[5:15, 10:30] = True    # area 200 (largest)
    mask[30:35, 40:45] = True   # area 25
    bb = largest_component_bbox(jnp.asarray(mask))
    assert bool(bb.valid)
    assert (int(bb.x1), int(bb.y1), int(bb.x2), int(bb.y2)) == (10, 5, 29, 14)
    assert int(bb.area) == 200


def test_largest_component_bbox_empty():
    bb = largest_component_bbox(jnp.zeros((20, 20), bool))
    assert not bool(bb.valid)


def test_largest_component_snake():
    # L-shaped component exercises multi-hop label propagation.
    mask = np.zeros((40, 40), bool)
    mask[5, 5:35] = True
    mask[5:35, 34] = True
    mask[20, 5:10] = True  # separate small piece
    bb = largest_component_bbox(jnp.asarray(mask))
    assert int(bb.area) == 30 + 29
    assert (int(bb.x1), int(bb.y1), int(bb.x2), int(bb.y2)) == (5, 5, 34, 34)


def test_detect_red_object_matches_reference_semantics():
    # Build an image with a red rectangle; reference gives boundingRect
    # +/- 10 px margin (object_detection.py:63-65).
    img = np.full((120, 160, 3), (30, 80, 40), np.uint8)  # greenish bg
    img[40:70, 50:100] = (200, 20, 20)  # red block (RGB)
    rect = detect_red_object(jnp.asarray(img))
    assert bool(rect.valid)
    assert (int(rect.x1), int(rect.y1)) == (50 - 10, 40 - 10)
    assert (int(rect.x2), int(rect.y2)) == (99 + 10, 69 + 10)
    m = np.asarray(red_mask(jnp.asarray(img)))
    assert m[50, 70] and not m[10, 10]


def test_detect_red_wraparound_hue():
    # Red with hue just below 180 (wrap range) must also be detected.
    hsv = np.zeros((40, 40, 3), np.uint8)
    hsv[..., 0] = 177; hsv[..., 1] = 200; hsv[..., 2] = 220
    rgb = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    img = np.full((60, 60, 3), 255, np.uint8)  # white bg (S=0, excluded)
    img[10:50, 10:50] = rgb
    rect = detect_red_object(jnp.asarray(img))
    assert bool(rect.valid)
    assert int(rect.x1) == 0 and int(rect.x2) >= 49


def test_filter_by_rect():
    # P from the reference's color camera (README.md:39-55).
    P = jnp.asarray(np.array([
        [616.8246459960938, 0.0, 321.81976318359375, 0.0],
        [0.0, 616.609375, 239.91116333007812, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ], np.float32))
    pts = jnp.asarray(np.array([
        [0.0, 0.0, 1.0],     # center -> (321.8, 239.9)
        [0.5, 0.0, 1.0],     # -> (630, 239.9) right edge
        [0.0, 0.0, -1.0],    # behind camera
    ], np.float32))
    mask = jnp.ones(3, bool)
    out = filter_by_rect(pts, mask, P, (300, 220, 340, 260))
    np.testing.assert_array_equal(np.asarray(out), [True, False, False])


def test_project_bbox_chain():
    P = jnp.asarray(np.array([
        [600.0, 0, 320, 0], [0, 600.0, 240, 0], [0, 0, 1, 0]], np.float32))
    E = jnp.eye(4)
    verts = jnp.asarray(np.array([[0, 0, 2.0]] * 8, np.float32))
    uv = project_bbox(P, E, verts)
    np.testing.assert_allclose(uv, np.tile([320.0, 240.0], (8, 1)), atol=1e-4)


def test_bilinear_resize_shapes():
    img = jnp.asarray(np.random.RandomState(2).rand(46, 57).astype(np.float32))
    out = bilinear_resize(img, (92, 114))
    assert out.shape == (92, 114)
    # 8x upsample of heatmaps is the OpenPose use case.
    out8 = bilinear_resize(img[..., None], (46 * 8, 57 * 8))
    assert out8.shape == (368, 456, 1)
