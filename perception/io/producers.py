"""Frame producers: video, webcam, image directory, synthetic.

The reference's producer layer (``openpose/src/openpose/producer/``:
VideoReader, WebcamReader, ImageDirectoryReader, IpCameraReader with
fps-keeping and rotation). Host-edge cv2 capture + the native prefetch
ring (`runtime.FramePrefetcher`) for directory streams; each producer
yields RGB uint8 frames (+ timestamps), ready to stage onto the device.
"""

from __future__ import annotations

import glob
import time
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np


class VideoReader:
    """cv2-backed video file reader (VideoReader equivalent)."""

    def __init__(self, path, rotation: int = 0):
        import cv2

        self.cap = cv2.VideoCapture(str(path))
        if not self.cap.isOpened():
            raise FileNotFoundError(path)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.rotation = rotation

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        import cv2

        t = 0.0
        while True:
            ok, bgr = self.cap.read()
            if not ok:
                break
            rgb = bgr[..., ::-1]
            if self.rotation:
                rgb = np.rot90(rgb, self.rotation // 90)
            yield t, np.ascontiguousarray(rgb)
            t += 1.0 / self.fps

    def close(self) -> None:
        self.cap.release()


class WebcamReader(VideoReader):
    """Live camera (WebcamReader equivalent; index instead of path)."""

    def __init__(self, index: int = 0, width: int = 640, height: int = 480):
        import cv2

        self.cap = cv2.VideoCapture(index)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open camera {index}")
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.rotation = 0

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        import cv2

        while True:
            ok, bgr = self.cap.read()
            if not ok:
                break
            yield time.time(), np.ascontiguousarray(bgr[..., ::-1])


class IpCameraReader(VideoReader):
    """RTSP/HTTP stream reader (IpCameraReader equivalent,
    ``producer/ipCameraReader.cpp``). cv2 speaks both protocols; frames
    are timestamped with wall clock like the webcam path."""

    def __init__(self, url: str, rotation: int = 0):
        import cv2

        self.cap = cv2.VideoCapture(url)
        if not self.cap.isOpened():
            raise ConnectionError(f"cannot open stream {url}")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.rotation = rotation

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        while True:
            ok, bgr = self.cap.read()
            if not ok:
                break
            rgb = bgr[..., ::-1]
            if self.rotation:
                rgb = np.rot90(rgb, self.rotation // 90)
            yield time.time(), np.ascontiguousarray(rgb)


class FlirReader:
    """Point Grey / FLIR stereo rig capture (FlirReader +
    SpinnakerWrapper equivalent, ``producer/spinnakerWrapper.cpp``).

    The Spinnaker SDK ships as the vendor package ``PySpin``; this
    environment has no cameras or SDK, so construction degrades with a
    clear error (the reference likewise compiles the wrapper out unless
    ``WITH_FLIR_CAMERA`` is set). When PySpin is present, frames from
    all cameras on the bus are returned synchronized (hardware trigger
    assumed configured) and undistorted via per-camera ``PinholeCamera``
    models when calibration is supplied."""

    def __init__(self, camera_params=None, undistort: bool = True):
        try:
            import PySpin  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "FlirReader requires the Spinnaker SDK (PySpin); "
                "not available in this environment"
            ) from e
        self._system = PySpin.System.GetInstance()
        self._cams = self._system.GetCameras()
        if self._cams.GetSize() == 0:
            raise RuntimeError("no FLIR cameras on the bus")
        for cam in self._cams:
            cam.Init()
            cam.BeginAcquisition()
        self.camera_params = camera_params
        self.undistort = undistort

    def frames(self) -> Iterator[Tuple[float, list]]:
        while True:
            views = []
            for cam in self._cams:
                img = cam.GetNextImage()
                arr = np.asarray(img.GetNDArray())
                img.Release()
                views.append(arr)
            yield time.time(), views

    def close(self) -> None:
        for cam in self._cams:
            cam.EndAcquisition()
            cam.DeInit()
        self._cams.Clear()
        self._system.ReleaseInstance()


class ImageDirectoryReader:
    """Sorted image-directory stream (ImageDirectoryReader equivalent)
    with native read-ahead via the C++ prefetcher."""

    def __init__(self, directory, pattern: str = "*.png", prefetch: bool = True):
        self.paths = sorted(glob.glob(str(Path(directory) / pattern)))
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.paths)

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        import cv2

        if self.prefetch and self.paths:
            from perception.runtime import FramePrefetcher

            for i, raw in enumerate(FramePrefetcher(self.paths, threads=2, ring=4)):
                buf = np.frombuffer(raw, np.uint8)
                img = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
                if img is None:
                    continue
                if img.ndim == 3:
                    img = img[..., ::-1]
                yield float(i), np.ascontiguousarray(img)
        else:
            for i, p in enumerate(self.paths):
                img = cv2.imread(p, cv2.IMREAD_UNCHANGED)
                if img is None:
                    continue
                if img.ndim == 3:
                    img = img[..., ::-1]
                yield float(i), np.ascontiguousarray(img)


def paced(frames, target_fps: float, drop: bool = True):
    """fps-keeping wrapper over a (timestamp, frame) iterator.

    The reference ``Producer`` paces reads to the source fps and drops
    frames when the consumer lags (producer.cpp fps-keeping). For
    faster-than-real-time sources (directory/video decode) this sleeps
    to hold ``target_fps``; when the consumer is slower than the
    target and ``drop`` is set, backlogged frames are skipped so the
    stream stays live instead of drifting behind.
    """
    import time as _time

    period = 1.0 / float(target_fps)
    t_next = None
    for t, frame in frames:
        now = _time.monotonic()
        if t_next is None:
            t_next = now
        if now < t_next:
            _time.sleep(t_next - now)
        elif drop and now - t_next > period:
            # Consumer lagged more than one period: drop this frame to
            # catch up (count full periods missed).
            missed = int((now - t_next) / period)
            t_next += period * missed
            if missed > 0:
                continue
        t_next += period
        yield t, frame
