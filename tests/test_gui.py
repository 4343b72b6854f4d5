"""GUI layer tests (headless paths: overlay, sink fallback, key logic,
3-D orbit animation)."""

import numpy as np
import pytest

from perception.io.gui import (
    FrameDisplayer,
    Gui,
    Gui3D,
    GuiInfoAdder,
    display_available,
)


@pytest.fixture(autouse=True)
def force_headless(monkeypatch):
    monkeypatch.setenv("PERCEPTION_FORCE_HEADLESS", "1")


def test_display_available_respects_force():
    assert not display_available()


def test_info_adder_overlays_and_tracks_fps():
    info = GuiInfoAdder()
    frame = np.zeros((64, 128, 3), np.uint8)
    out1 = info.add_info(frame.copy(), frame_id=0, num_people=2)
    out2 = info.add_info(frame.copy(), frame_id=1, num_people=2)
    assert out1.shape == frame.shape
    assert out1.any(), "overlay drew nothing"
    assert info._fps > 0 or out2.any()


def test_displayer_headless_sink():
    got = []
    d = FrameDisplayer(sink=got.append)
    frame = np.zeros((32, 32, 3), np.uint8)
    d.display(frame)
    d.display(frame)
    assert d.frames_shown == 2
    assert len(got) == 2
    d.close()


def test_displayer_headless_no_sink_counts():
    d = FrameDisplayer()
    d.display(np.zeros((8, 8, 3), np.uint8))
    assert d.frames_shown == 1


def test_gui_loop_and_keys():
    gui = Gui(displayer=FrameDisplayer())
    frame = np.zeros((48, 48, 3), np.uint8)
    assert gui.update(frame, num_people=1)
    gui.handle_key(ord(" "))
    assert gui.paused
    gui.handle_key(ord(" "))
    assert not gui.paused
    gui.handle_key(ord("q"))
    assert gui.quit
    assert not gui.update(frame)
    gui.close()


def test_gui3d_orbits_and_renders():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.2, 0.2, size=(500, 3)) + [0.0, 0.0, 0.8]
    sink = []
    g = Gui3D(hw=(120, 160), displayer=FrameDisplayer(sink=sink.append))
    img1 = g.update(pts.astype(np.float32))
    img2 = g.update(pts.astype(np.float32))
    assert img1.shape == (120, 160, 3)
    assert img1.any()
    assert not np.array_equal(img1, img2), "orbit did not move the camera"
    assert len(sink) == 2
