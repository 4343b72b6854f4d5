"""Camera parameter file I/O (intrinsics/extrinsics per serial).

Equivalent of OpenPose's ``CameraParameterReader``
(``3d/cameraParameterReader.cpp``: per-camera XML files with intrinsic
matrix, distortion, extrinsics). Format here is JSON (one file per rig):

    {"cameras": {"<name>": {"K": [9], "dist": [5],
                             "extrinsics": [16],   # world->cam, row-major
                             "width": W, "height": H}}}
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from perception.geometry.camera import PinholeCamera


def save_camera_rig(path, cameras: Dict[str, dict]) -> None:
    """cameras: name -> {K (3,3), dist (5,), extrinsics (4,4), width, height}."""
    doc = {"cameras": {}}
    for name, c in cameras.items():
        doc["cameras"][name] = {
            "K": np.asarray(c["K"], np.float64).reshape(-1).tolist(),
            "dist": np.asarray(c.get("dist", np.zeros(5)), np.float64).reshape(-1).tolist(),
            "extrinsics": np.asarray(c.get("extrinsics", np.eye(4)), np.float64).reshape(-1).tolist(),
            "width": int(c.get("width", 640)),
            "height": int(c.get("height", 480)),
        }
    Path(path).write_text(json.dumps(doc, indent=1))


def load_camera_rig(path) -> Dict[str, dict]:
    """Returns name -> {camera: PinholeCamera, extrinsics (4,4) np,
    P (3,4) np} — P = K [R|t] ready for triangulation."""
    doc = json.loads(Path(path).read_text())
    out = {}
    for name, c in doc["cameras"].items():
        K = np.asarray(c["K"], np.float32).reshape(3, 3)
        E = np.asarray(c["extrinsics"], np.float32).reshape(4, 4)
        cam = PinholeCamera.from_K(
            K, width=c.get("width", 640), height=c.get("height", 480),
            dist=np.asarray(c.get("dist", np.zeros(5)), np.float32),
        )
        out[name] = {
            "camera": cam,
            "extrinsics": E,
            "P": (K @ E[:3, :4]).astype(np.float32),
        }
    return out
