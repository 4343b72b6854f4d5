"""Multi-object service benchmark: steady-state detect_objects latency.

The reference's service is a one-shot ROS RPC (~seconds of sequential
PCL per call: KD-tree clustering + up-to-10-restart ICP per cluster,
object_pose_detection.cpp:270-442). Here the whole service — filters,
plane removal, clustering, (cluster x restart) batched ICP, winner
gate — is one jitted call.

Run: python -m benchmarks.objects_bench
"""

from __future__ import annotations

import time


def run(classes=("eraser", "screwdriver", "clamp", "marker")) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from benchmarks.clutter_scene import (
        captured_template,
        render_depth_clutter,
        standard_clutter_poses,
    )
    from perception.geometry.camera import PinholeCamera
    from perception.models.objects import ObjectConfig, detect_object

    cam = PinholeCamera.d435_depth()
    poses = standard_clutter_poses()
    depth = render_depth_clutter(cam, poses, seed=3)
    pts, mask = cam.backproject_depth(jnp.asarray(depth))
    # Full-res scene: min cluster size / gate scaled to the 4 mm voxel.
    cfg = ObjectConfig(cluster_min_size=40, size_gate=250)

    out = {}
    per_class_ms = {}
    succ = 0
    for name in classes:
        tmpl = jnp.asarray(captured_template(name, cam))
        tm = jnp.ones(len(tmpl), bool)
        fn = jax.jit(
            lambda p, m, t, tmsk, k: detect_object(p, m, t, tmsk, k, cfg)
        )
        res = fn(pts, mask, tmpl, tm, jax.random.key(0))
        jax.block_until_ready(res)
        reps = 5
        t0 = time.perf_counter()
        for i in range(reps):
            res = fn(pts, mask, tmpl, tm, jax.random.key(i))
        jax.block_until_ready(res)
        per_class_ms[name] = round((time.perf_counter() - t0) / reps * 1000, 2)
        succ += int(bool(res.success))
    out["per_class_ms"] = per_class_ms
    out["mean_ms"] = round(float(np.mean(list(per_class_ms.values()))), 2)
    out["successes"] = succ
    out["classes"] = len(classes)
    return out


def main() -> None:
    for k, v in run().items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
