import json
import socket

import numpy as np
import pytest

from perception.io.imgcodec import array_to_image, convert_color, image_to_array
from perception.io.savers import (
    UdpSender,
    coco_keypoint_results,
    load_heatmaps,
    save_coco_json,
    save_heatmaps,
    save_people_json,
)


def test_people_json(tmp_path):
    kps = np.random.RandomState(0).rand(3, 5, 3).astype(np.float32)
    mask = np.array([True, False, True])
    p = tmp_path / "people.json"
    save_people_json(p, kps, mask, part_names=["a", "b", "c", "d", "e"])
    doc = json.loads(p.read_text())
    assert len(doc["people"]) == 2
    assert len(doc["people"][0]["pose_keypoints_2d"]) == 15


def test_coco_results_format(tmp_path):
    kps = np.zeros((2, 4, 3), np.float32)
    kps[0, :, :2] = 10
    kps[0, :, 2] = 0.9
    mask = np.array([True, False])
    res = coco_keypoint_results([42], [kps], [mask], [np.array([0.8, 0.0])])
    assert len(res) == 1
    assert res[0]["image_id"] == 42
    assert len(res[0]["keypoints"]) == 12
    assert res[0]["keypoints"][2] == 2  # visible flag
    save_coco_json(tmp_path / "c.json", res)
    assert json.loads((tmp_path / "c.json").read_text())[0]["score"] == pytest.approx(0.8)


def test_heatmap_roundtrip(tmp_path):
    hm = np.random.RandomState(1).rand(4, 16, 16).astype(np.float32)
    p = tmp_path / "hm.npz"
    save_heatmaps(p, hm)
    np.testing.assert_array_equal(load_heatmaps(p), hm)


def test_udp_roundtrip():
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(5.0)
    port = recv.getsockname()[1]
    sender = UdpSender("127.0.0.1", port)
    arr = np.arange(12, dtype=np.float32)
    sender.send_array(arr, tag=7)
    data, _ = recv.recvfrom(65536)
    seq, tag, back = UdpSender.parse(data)
    assert seq == 0 and tag == 7
    np.testing.assert_array_equal(back, arr)
    sender.close()
    recv.close()


def test_imgcodec_roundtrip():
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 255, (10, 12, 3), np.uint8)
    msg = array_to_image(arr, "rgb8")
    back = image_to_array(msg)
    np.testing.assert_array_equal(back, arr)


def test_imgcodec_mono16():
    arr = np.arange(20, dtype=np.uint16).reshape(4, 5) * 1000
    msg = array_to_image(arr, "mono16")
    np.testing.assert_array_equal(image_to_array(msg), arr)


def test_color_conversions():
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 255, (6, 6, 3), np.uint8)
    bgr = convert_color(rgb, "rgb8", "bgr8")
    np.testing.assert_array_equal(bgr[..., 0], rgb[..., 2])
    np.testing.assert_array_equal(convert_color(bgr, "bgr8", "rgb8"), rgb)
    gray = convert_color(rgb, "rgb8", "mono8")
    assert gray.shape == (6, 6)
    # cv2 parity for grayscale.
    import cv2

    expected = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    assert np.abs(gray.astype(int) - expected.astype(int)).max() <= 1
    rgba = convert_color(rgb, "rgb8", "rgba8")
    assert rgba.shape == (6, 6, 4) and (rgba[..., 3] == 255).all()


def test_unsupported_encoding():
    with pytest.raises(ValueError):
        array_to_image(np.zeros((2, 2)), "yuv422")


def test_rgb_color_table():
    """146 named colors, modulo wrap (rgb_colors.cpp getRGBColor)."""
    from perception.io import colors

    assert colors.N_COLORS == 146
    c0 = colors.get_rgb_color(0)
    assert c0.shape == (3,) and (0.0 <= c0).all() and (c0 <= 1.0).all()
    # aliceblue is first alphabetically, as in the reference enum.
    assert colors.color_name(0) == "aliceblue"
    np.testing.assert_allclose(colors.get_rgb_color(146), c0)
    # The CSS3 list has 7 gray/grey alias pairs (as in the reference
    # enum, rgb_colors.h), so 139 distinct RGB values among 146 names.
    tab = np.stack([colors.get_rgb_color(i) for i in range(colors.N_COLORS)])
    assert len(np.unique(np.round(tab * 255).astype(int), axis=0)) == 139


def test_label_image_to_rgb8():
    from perception.io.colors import label_image_to_rgb8

    labels = np.array([[-1, 0], [1, 200]], np.int32)
    img = label_image_to_rgb8(labels)
    assert img.shape == (2, 2, 3) and img.dtype == np.uint8
    assert (img[0, 0] == 0).all()                 # background -> black
    assert not (img[0, 1] == img[1, 0]).all()     # distinct labels differ
    # wraps modulo table size
    assert (img[1, 1] == label_image_to_rgb8(np.array([[200 % 146]]))[0, 0]).all()


def test_cvt_color_for_display_depth_and_labels():
    from perception.io.imgcodec import cvt_color_for_display

    depth = np.linspace(0.2, 2.0, 12, dtype=np.float32).reshape(3, 4)
    depth[0, 0] = np.nan
    out = cvt_color_for_display(depth, "32FC1", "bgr8", do_dynamic_scaling=True)
    assert out.shape == (3, 4, 3) and out.dtype == np.uint8
    assert (out[0, 0] == 0).all()          # NaN -> black
    assert out[2, 3, 0] == 255             # max scales to 255
    # Fixed window
    out2 = cvt_color_for_display(depth, "32FC1", "mono8",
                                 min_image_value=0.0, max_image_value=4.0)
    assert out2[2, 3] == int(round(2.0 / 4.0 * 255))
    # Label branch + passthrough branch
    lab = cvt_color_for_display(np.array([[0, 1]], np.int32), "32SC1", "rgb8")
    assert lab.shape == (1, 2, 3)
    rgb = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    assert (cvt_color_for_display(rgb, "rgb8", "bgr8") == rgb[..., ::-1]).all()


def test_coco_variant_index_maps():
    """Foot/face/hand/car COCO output variants (cocoJsonSaver.cpp:98-181)."""
    from perception.io.savers import coco_order_indexes

    # BODY_25 -> COCO-17 reorder starts at the nose and maps eyes/ears.
    body25 = coco_order_indexes(25, "body")
    assert len(body25) == 17 and body25[0] == 0 and body25[1:5] == [16, 15, 18, 17]
    assert coco_order_indexes(18, "body")[1:5] == [15, 14, 17, 16]
    # Foot: the 6 foot keypoints of BODY_25 / whole-body models.
    assert coco_order_indexes(25, "foot") == [19, 20, 21, 22, 23, 24]
    assert coco_order_indexes(135, "foot") == [19, 20, 21, 22, 23, 24]
    assert coco_order_indexes(23, "foot") == [17, 18, 19, 20, 21, 22]
    # Face: 68 keypoints from the BODY_135 face block.
    face = coco_order_indexes(135, "face")
    assert len(face) == 68 and face[0] == 65 and face[-1] == 132
    # Hands: wrist + 20 hand points each (left 25..44, right 45..64).
    h21 = coco_order_indexes(135, "hand21")
    assert len(h21) == 21 and h21[0] == 10 and h21[1] == 45 and h21[-1] == 64
    h42 = coco_order_indexes(135, "hand42")
    assert len(h42) == 42 and h42[0] == 9 and h42[1] == 25
    assert h42[21] == 10 and h42[22] == 45
    # Car datasets.
    assert len(coco_order_indexes(12, "car")) == 14  # duplicated corners
    assert coco_order_indexes(22, "car", variant=0)[-2:] == [16, 17]
    assert coco_order_indexes(22, "car", variant=1)[-2:] == [20, 21]
    assert coco_order_indexes(22, "car", variant=2) == list(range(20))
    with pytest.raises(ValueError):
        coco_order_indexes(25, "face")


def test_coco_variant_results_subset():
    from perception.io.savers import coco_keypoint_results

    kps = np.zeros((1, 25, 3), np.float32)
    kps[0, :, 0] = np.arange(25)  # x encodes the model part id
    kps[0, :, 2] = 1.0
    res = coco_keypoint_results(
        [7], [kps], [np.array([True])], [np.array([0.5])], fmt="foot"
    )
    xs = res[0]["keypoints"][0::3]
    assert xs == [19.0, 20.0, 21.0, 22.0, 23.0, 24.0]
    assert len(res[0]["keypoints"]) == 18
