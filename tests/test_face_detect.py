import jax
import jax.numpy as jnp
import numpy as np

from perception.models.face_detect import (
    FaceDetectorNet,
    decode_detector_net,
    detect_faces,
)


def render_face(H=120, W=160, cx=80, cy=60, size=40, skin=180.0, bg=100.0, seed=0):
    """Synthetic frontal face: skin ellipse, dark eyes/brows/mouth,
    bright nose bridge — the contrast structure real faces have."""
    rng = np.random.RandomState(seed)
    img = np.full((H, W), bg) + rng.randn(H, W) * 2.0
    yy, xx = np.mgrid[0:H, 0:W].astype(float)

    def ellipse(cx_, cy_, rx, ry):
        return ((xx - cx_) / rx) ** 2 + ((yy - cy_) / ry) ** 2 <= 1.0

    s = size / 24.0  # canonical window units
    img[ellipse(cx, cy, 10.5 * s, 12 * s)] = skin
    # Eyes (dark) at canonical rows ~9-11, cols ~6.5 / 17.5 of 24.
    for ex in (-5.5 * s, 5.5 * s):
        img[ellipse(cx + ex, cy - 2.0 * s, 2.6 * s, 1.5 * s)] = 60.0
        img[ellipse(cx + ex, cy - 4.5 * s, 2.8 * s, 0.7 * s)] = 80.0  # brow
    # Mouth (dark) near canonical row 20.
    img[ellipse(cx, cy + 7.0 * s, 3.5 * s, 1.3 * s)] = 70.0
    # Nose shadowless bridge stays skin-bright.
    gt_box = np.array([cx - 12 * s, cy - 12 * s, cx + 12 * s, cy + 12 * s])
    return img.astype(np.float32), gt_box


def box_iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    area = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(area, 1e-9)


def best_detection_iou(dets, gt_box):
    boxes = np.asarray(dets.boxes)
    mask = np.asarray(dets.mask)
    if not mask.any():
        return 0.0
    return max(box_iou(b, gt_box) for b in boxes[mask])


def test_detects_face_without_pose():
    # VERDICT r1 item 4: faces must resolve from the image alone.
    img, gt = render_face()
    dets = detect_faces(jnp.asarray(img))
    assert bool(np.asarray(dets.mask).any()), "no detection on a clear face"
    assert best_detection_iou(dets, gt) > 0.35


def test_detects_across_scales_and_positions():
    for cx, cy, size, seed in [(50, 40, 28, 1), (110, 70, 56, 2)]:
        img, gt = render_face(cx=cx, cy=cy, size=size, seed=seed)
        dets = detect_faces(jnp.asarray(img))
        iou = best_detection_iou(dets, gt)
        assert iou > 0.3, f"size={size} pos=({cx},{cy}): IoU {iou}"


def test_no_detection_on_flat_or_noise():
    flat = jnp.full((120, 160), 128.0)
    dets = detect_faces(flat)
    assert not bool(np.asarray(dets.mask).any())

    rng = np.random.RandomState(0)
    noise = jnp.asarray(rng.randn(120, 160).astype(np.float32) * 30 + 128)
    dets = detect_faces(noise)
    # Pure noise may produce rare weak peaks but never strong ones.
    scores = np.asarray(dets.scores)[np.asarray(dets.mask)]
    assert scores.size == 0 or scores.max() < 2.5


def test_two_faces_dedup():
    img1, gt1 = render_face(cx=45, cy=55, size=36, seed=3)
    img2, gt2 = render_face(cx=120, cy=60, size=36, seed=4)
    img = np.maximum(img1, img2)  # second face onto the first image
    dets = detect_faces(jnp.asarray(img))
    assert best_detection_iou(dets, gt1) > 0.3
    assert best_detection_iou(dets, gt2) > 0.3


def test_detector_net_shapes_and_decode():
    net = FaceDetectorNet()
    x = jnp.zeros((96, 96, 1))
    params = net.init(jax.random.key(0), x)
    heat, size = net.apply(params, x)
    assert heat.shape == (24, 24) and size.shape == (24, 24)
    # Hand-crafted outputs decode to the right box.
    heat = jnp.full((24, 24), -5.0).at[12, 10].set(3.0)
    size = jnp.full((24, 24), jnp.log(8.0))  # 8*4 = 32 px faces
    dets = decode_detector_net(heat, size, threshold=0.0, max_faces=4)
    assert bool(dets.mask[0])
    b = np.asarray(dets.boxes[0])
    np.testing.assert_allclose(b, [40 - 16, 48 - 16, 40 + 16, 48 + 16], atol=3)
