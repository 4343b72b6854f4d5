"""Image encoding bridge: the cv_bridge capability without ROS.

Parity with ``vision_opencv/cv_bridge``: an encoding registry
(``getCvType``, ``cv_bridge.cpp:72-113``), conversion between encodings
(``getConversionCode`` channel/bit-depth rules ``:199-244``, color
table ``:143-197``), and raw-buffer <-> array views with explicit
endianness (``matFromImage``). "Messages" here are plain dicts with
``encoding``, ``height``, ``width``, ``step``, ``is_bigendian``,
``data`` — the sensor_msgs/Image wire layout minus ROS.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# encoding -> (numpy dtype, channels)
ENCODINGS: Dict[str, tuple] = {
    "mono8": (np.uint8, 1),
    "mono16": (np.uint16, 1),
    "bgr8": (np.uint8, 3),
    "rgb8": (np.uint8, 3),
    "bgra8": (np.uint8, 4),
    "rgba8": (np.uint8, 4),
    "8UC1": (np.uint8, 1),
    "8UC3": (np.uint8, 3),
    "16UC1": (np.uint16, 1),
    "16SC1": (np.int16, 1),
    "32SC1": (np.int32, 1),
    "32FC1": (np.float32, 1),
    "32FC3": (np.float32, 3),
    "64FC1": (np.float64, 1),
}


def encoding_dtype(encoding: str):
    if encoding not in ENCODINGS:
        raise ValueError(f"unsupported encoding {encoding!r}")
    return ENCODINGS[encoding]


def image_to_array(msg: dict) -> np.ndarray:
    """Image dict -> numpy array view (byteswapped if needed)."""
    dtype, ch = encoding_dtype(msg["encoding"])
    h, w, step = msg["height"], msg["width"], msg["step"]
    buf = np.frombuffer(msg["data"], np.uint8).reshape(h, step)
    row_bytes = w * ch * np.dtype(dtype).itemsize
    rows = np.ascontiguousarray(buf[:, :row_bytes])
    arr = rows.view(dtype)  # (h, w*ch) after the byte view
    arr = arr.reshape(h, w, ch) if ch > 1 else arr.reshape(h, w)
    big = bool(msg.get("is_bigendian", False))
    if big != (np.dtype(dtype).byteorder == ">") and np.dtype(dtype).itemsize > 1:
        arr = arr.byteswap()
    return arr


def array_to_image(arr: np.ndarray, encoding: str) -> dict:
    dtype, ch = encoding_dtype(encoding)
    arr = np.asarray(arr, dtype)
    if ch == 1 and arr.ndim == 3:
        arr = arr[..., 0]
    if ch > 1 and (arr.ndim != 3 or arr.shape[2] != ch):
        raise ValueError(f"array shape {arr.shape} does not match {encoding}")
    h, w = arr.shape[:2]
    return {
        "encoding": encoding,
        "height": h,
        "width": w,
        "step": w * ch * np.dtype(dtype).itemsize,
        "is_bigendian": False,
        "data": np.ascontiguousarray(arr).tobytes(),
    }


def array_to_compressed(arr: np.ndarray, fmt: str = "jpg", quality: int = 95) -> dict:
    """Encode to a CompressedImage-shaped dict (``toCompressedImageMsg``,
    cv_bridge.h:111 — JPG/PNG). ``fmt`` is 'jpg' or 'png'; input is RGB
    (or mono) uint8; encoding happens at the host edge via cv2."""
    import cv2

    if fmt not in ("jpg", "jpeg", "png"):
        raise ValueError(f"unsupported compressed format {fmt!r}")
    bgr = arr[..., ::-1] if arr.ndim == 3 else arr
    params = (
        [cv2.IMWRITE_JPEG_QUALITY, quality] if fmt.startswith("jp")
        else [cv2.IMWRITE_PNG_COMPRESSION, 3]
    )
    ok, buf = cv2.imencode("." + fmt, np.ascontiguousarray(bgr), params)
    if not ok:
        raise ValueError("encode failed")
    return {"format": fmt, "data": buf.tobytes()}


def compressed_to_array(msg: dict) -> np.ndarray:
    """CompressedImage dict -> numpy array (``toCvCopy`` on compressed
    messages). 3-channel output is RGB."""
    import cv2

    buf = np.frombuffer(msg["data"], np.uint8)
    img = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError("decode failed")
    if img.ndim == 3:
        img = img[..., :3][..., ::-1]
    return np.ascontiguousarray(img)


_COLOR_PERMUTES = {
    ("bgr8", "rgb8"): [2, 1, 0],
    ("rgb8", "bgr8"): [2, 1, 0],
    ("bgra8", "rgba8"): [2, 1, 0, 3],
    ("rgba8", "bgra8"): [2, 1, 0, 3],
}

_GRAY_WEIGHTS = {"rgb8": (0.299, 0.587, 0.114), "bgr8": (0.114, 0.587, 0.299)}


def convert_color(arr: np.ndarray, src: str, dst: str) -> np.ndarray:
    """cvtColor-equivalent conversions between the registry encodings."""
    if src == dst:
        return arr
    key = (src, dst)
    if key in _COLOR_PERMUTES:
        return arr[..., _COLOR_PERMUTES[key]]
    if src in _GRAY_WEIGHTS and dst == "mono8":
        w = np.asarray(_GRAY_WEIGHTS[src])
        return np.clip(arr[..., :3].astype(np.float32) @ w, 0, 255).astype(np.uint8)
    if src == "mono8" and dst in ("rgb8", "bgr8"):
        return np.repeat(arr[..., None], 3, axis=-1)
    if src == "mono16" and dst == "mono8":
        return (arr >> 8).astype(np.uint8)
    if src == "mono8" and dst == "mono16":
        return arr.astype(np.uint16) << 8
    # Drop/add alpha.
    if src in ("rgba8", "bgra8") and dst == src[:3] + "8":
        return arr[..., :3]
    if src in ("rgb8", "bgr8") and dst == src[:3] + "a8":
        a = np.full(arr.shape[:2] + (1,), 255, np.uint8)
        return np.concatenate([arr, a], axis=-1)
    raise ValueError(f"no conversion {src} -> {dst}")


def cvt_color_for_display(
    arr: np.ndarray,
    src_encoding: str,
    dst_encoding: str = "bgr8",
    *,
    do_dynamic_scaling: bool = False,
    min_image_value: float = 0.0,
    max_image_value: float = 0.0,
) -> np.ndarray:
    """Convert any registry image to a displayable 8-bit color image.

    Capability parity with ``cv_bridge::cvtColorForDisplay``
    (vision_opencv/cv_bridge/src/cv_bridge.cpp; API doc in
    cv_bridge.h:263-299): depth/float images are range-scaled to 8 bit
    (either a fixed [min, max] window or dynamic min/max scaling),
    32-bit integer images are treated as label maps and colorized with
    the named-color table, and everything else goes through
    ``convert_color``.
    """
    from perception.io.colors import label_image_to_rgb8

    arr = np.asarray(arr)
    if src_encoding == "32SC1":  # label image -> distinct colors
        rgb = label_image_to_rgb8(arr)
        return convert_color(rgb, "rgb8", dst_encoding)
    if arr.dtype in (np.float32, np.float64, np.uint16, np.int16) and arr.ndim == 2:
        finite = np.isfinite(arr)
        if min_image_value != max_image_value:
            lo, hi = float(min_image_value), float(max_image_value)
        elif do_dynamic_scaling:
            vals = arr[finite]
            lo = float(vals.min()) if vals.size else 0.0
            hi = float(vals.max()) if vals.size else 1.0
        else:
            # The reference errors here for float input; default depth
            # window of [0, 10] m keeps the call usable headless.
            lo, hi = 0.0, 10.0 if arr.dtype in (np.float32, np.float64) else 65535.0
        scale = 255.0 / (hi - lo) if hi > lo else 1.0
        mono = np.clip((arr.astype(np.float64) - lo) * scale, 0, 255)
        mono = np.where(finite, np.round(mono), 0).astype(np.uint8)
        return convert_color(mono, "mono8", dst_encoding)
    return convert_color(arr, src_encoding, dst_encoding)
