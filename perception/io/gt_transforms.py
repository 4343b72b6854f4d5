"""transforms.txt-style ground-truth pose files.

The reference's only ground truth is a hand-measured TF dump per object
(``object_detection/templates/transforms.txt``: named sections, each a
ROS TransformStamped YAML echo with translation + quaternion). This
module reads and writes that protocol so synthetic harnesses and real
captures share one GT format.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict

import numpy as np

from perception.geometry import se3


def save_gt_transforms(
    path,
    poses: Dict[str, np.ndarray],
    frame_id: str = "/camera_depth_optical_frame",
    child_frame_id: str = "/object_frame",
) -> None:
    """Write {name: (4, 4) camera->object pose} in the reference's
    transforms.txt section layout."""
    lines = []
    for name, T in poses.items():
        T = np.asarray(T, np.float64)
        q = np.asarray(se3.matrix_to_quat(T[:3, :3]))  # (w, x, y, z)
        t = T[:3, 3]
        lines += [
            f"############# {name} #############",
            "transforms: ",
            "  - ",
            "    header: ",
            "      seq: 0",
            "      stamp: ",
            "        secs: 0",
            "        nsecs: 0",
            f'      frame_id: "{frame_id}"',
            f'    child_frame_id: "{child_frame_id}"',
            "    transform: ",
            "      translation: ",
            f"        x: {t[0]:.10g}",
            f"        y: {t[1]:.10g}",
            f"        z: {t[2]:.10g}",
            "      rotation: ",
            f"        x: {q[1]:.12g}",
            f"        y: {q[2]:.12g}",
            f"        z: {q[3]:.12g}",
            f"        w: {q[0]:.12g}",
            "",
        ]
    Path(path).write_text("\n".join(lines))


def load_gt_transforms(path) -> Dict[str, np.ndarray]:
    """Parse a transforms.txt-style file -> {name: (4, 4) float64 pose}.

    Tolerant of the reference's hand-edited formatting: sections are
    ``##... name ##...`` headers; within a section the first
    translation/rotation blocks are used."""
    text = Path(path).read_text()
    sections = re.split(r"#{2,}\s*([^#\n]+?)\s*#{2,}", text)
    out: Dict[str, np.ndarray] = {}
    # re.split gives [prefix, name1, body1, name2, body2, ...]
    for name, body in zip(sections[1::2], sections[2::2]):
        def grab(block: str, key: str) -> float:
            m = re.search(
                rf"{block}:\s*\n(?:.*\n)*?\s*{key}:\s*([-\d.eE+]+)", body
            )
            if m is None:
                raise ValueError(f"missing {block}.{key} in section {name!r}")
            return float(m.group(1))

        t = np.array(
            [grab("translation", k) for k in ("x", "y", "z")], np.float64
        )
        qx, qy, qz, qw = (grab("rotation", k) for k in ("x", "y", "z", "w"))
        R = np.asarray(
            se3.quat_to_matrix(np.array([qw, qx, qy, qz], np.float64))
        )
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        out[name.strip()] = T
    return out
