import numpy as np
import pytest

from perception.io.producers import ImageDirectoryReader, VideoReader
from perception.io.savers import VideoWriter
from perception.models.viz import (
    depth_to_vis,
    draw_bbox_2d,
    draw_cuboid_bbox,
    draw_skeletons,
    landmarks_overlay,
)
from perception.io.templates import CUBOID_EDGES


def test_draw_skeletons():
    img = np.zeros((100, 120, 3), np.uint8)
    kps = np.zeros((2, 3, 3), np.float32)
    kps[0] = [(20, 20, 1), (40, 40, 1), (20, 60, 1)]
    kps[1] = [(80, 20, 1), (90, 40, 1), (80, 60, 0)]  # last part missing
    pairs = np.array([(0, 1), (1, 2)])
    out = draw_skeletons(img, kps, np.array([True, True]), pairs)
    assert out.shape == img.shape
    assert out.sum() > 0
    assert img.sum() == 0  # original untouched


def test_draw_bboxes():
    img = np.zeros((100, 120, 3), np.uint8)
    out = draw_bbox_2d(img, (10, 10, 50, 60))
    assert out[10, 30].any()
    verts = np.array([[20 + 10 * (i & 1), 30 + 10 * ((i >> 1) & 1)] for i in range(8)], np.float32)
    out2 = draw_cuboid_bbox(img, verts, CUBOID_EDGES)
    assert out2.sum() > 0


def test_depth_vis():
    d = np.full((40, 50), 2.0, np.float32)
    d[0, 0] = np.nan
    v = depth_to_vis(d)
    assert v.shape == (40, 50, 3) and v.dtype == np.uint8


def test_landmarks_overlay():
    img = np.zeros((50, 50, 3), np.uint8)
    lms = np.array([[10.0, 10.0], [30.0, 30.0]])
    out = landmarks_overlay(img, lms, np.array([True, False]))
    assert out[10, 10].any() and not out[30, 30].any()


def test_image_directory_reader_with_prefetch(tmp_path):
    import cv2

    for i in range(5):
        img = np.full((20, 30, 3), i * 40, np.uint8)
        cv2.imwrite(str(tmp_path / f"{i:03d}.png"), img)
    reader = ImageDirectoryReader(tmp_path)
    frames = list(reader.frames())
    assert len(frames) == 5
    for i, (t, img) in enumerate(frames):
        assert img.shape == (20, 30, 3)
        assert int(img[0, 0, 0]) == i * 40


def test_video_roundtrip(tmp_path):
    p = tmp_path / "out.mp4"
    w = VideoWriter(p, fps=10)
    for i in range(8):
        frame = np.full((48, 64, 3), i * 30, np.uint8)
        w.write(frame)
    w.close()
    r = VideoReader(p)
    frames = list(r.frames())
    r.close()
    assert len(frames) == 8
    assert frames[0][1].shape == (48, 64, 3)
