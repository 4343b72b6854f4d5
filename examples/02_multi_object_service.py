"""Example 02 — clustering + multi-object ICP "service".

The reference's `detect_objects` service (object_pose_detection.cpp
service_callback :270-442): passthrough -> voxel -> plane removal ->
Euclidean clustering -> per-cluster template ICP -> winner by point
count. Here the per-(cluster, restart) ICPs run as ONE vmapped batch
on device instead of a sequential loop with ≤10 restarts.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples._common import setup_backend, small_camera, print_pose  # noqa: E402

setup_backend()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from perception.io.templates import cuboid_template  # noqa: E402
from perception.models.objects import ObjectConfig, detect_object  # noqa: E402
from benchmarks.scene import render_depth_tabletop  # noqa: E402


def main() -> None:
    # Half-resolution D435: the winner gate compares cluster point count
    # against the voxelized template, so the camera must sample the
    # object at roughly the template's density.
    camera = small_camera(width=320, height=240)
    dims = (0.12, 0.05, 0.04)  # an "eraser"-sized object class
    depth = render_depth_tabletop(
        camera, cuboid_pose_twist=(0.04, 0.0, 0.60, 0.0, 0.0, 0.5), dims=dims,
        table_z=0.68,
    )

    pts, mask = camera.backproject_depth(jnp.asarray(depth))

    template_np = cuboid_template(*dims, 0.004)
    template = jnp.asarray(template_np)
    tmask = jnp.ones(len(template_np), bool)

    # Param overrides, the way the reference's launch files override the
    # node defaults — the small example camera sees far fewer points
    # than a 640x480 D435.
    config = ObjectConfig(cluster_min_size=60)
    result = jax.block_until_ready(
        jax.jit(lambda p, m, t, tm, k: detect_object(p, m, t, tm, k, config))(
            pts, mask, template, tmask, jax.random.key(0)
        )
    )

    sizes = np.asarray(result.cluster_sizes)
    print(f"clusters found = {int(result.num_clusters)}  sizes = {sizes[sizes > 0]}")
    print(f"service response: success = {bool(result.success)}  "
          f"(winner slot {int(result.cluster_id)}, size diff {int(result.size_diff)}, "
          f"fitness {float(result.fitness):.2e})")
    print_pose("camera<-object", result.pose)
    assert bool(result.success)


if __name__ == "__main__":
    main()
