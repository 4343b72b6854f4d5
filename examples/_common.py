"""Shared example scaffolding.

The examples default to the CPU backend so they run anywhere (and the
test suite can smoke-run them, the way the reference CI smoke-runs its
tutorials at tiny net resolution — openpose scripts/travis/run_tests.sh).
Set ``PERCEPTION_EXAMPLES_DEVICE=gpu`` to run on the GPU.
"""

from __future__ import annotations

import os

import numpy as np


def setup_backend() -> None:
    if os.environ.get("PERCEPTION_EXAMPLES_DEVICE", "cpu") == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")


def small_camera(width: int = 160, height: int = 120):
    """D435 depth intrinsics scaled down 4x — keeps example compiles fast."""
    from perception.geometry.camera import PinholeCamera

    d435 = PinholeCamera.d435_depth()
    s = width / d435.width
    return PinholeCamera.from_K(
        [float(d435.fx) * s, 0.0, float(d435.cx) * s,
         0.0, float(d435.fy) * s, float(d435.cy) * s,
         0.0, 0.0, 1.0],
        width=width, height=height,
    )


def print_pose(name: str, T) -> None:
    T = np.asarray(T)
    t = T[:3, 3]
    print(f"{name}: t = [{t[0]:+.4f} {t[1]:+.4f} {t[2]:+.4f}] m")
    for row in T[:3, :3]:
        print(f"    R | {row[0]:+.3f} {row[1]:+.3f} {row[2]:+.3f}")
