"""Example 01 — cuboid pose from a single depth frame.

The flagship pipeline (the reference's `roslaunch cuboid_detection
iterative_closest_point.launch` flow, SURVEY.md §3.1): depth image ->
backproject -> passthrough -> voxel downsample -> RANSAC ground plane ->
dominant-cluster extraction -> multi-restart template ICP -> 6-DoF pose
+ fitness gate + 8-vertex bounding box.

Everything from backprojection to the accept gate is ONE jitted XLA
program; the depth frame is the only host->device transfer per call.
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
from perception.models.cuboid import (  # noqa: E402
    CuboidConfig,
    cuboid_pipeline_from_depth,
    template_features,
)
from benchmarks.scene import render_depth_tabletop  # noqa: E402


def main() -> None:
    camera = small_camera()
    dims = (0.2, 0.1, 0.03)  # the L200_W100_H30 template of the launch file

    # Synthetic tabletop frame with a known ground-truth cuboid pose.
    gt_twist = (0.05, 0.03, 0.80, 0.0, 0.0, 0.3)
    depth = render_depth_tabletop(camera, cuboid_pose_twist=gt_twist, dims=dims)

    # Template prep is host-side and session-constant.
    template_np = cuboid_template(*dims, 0.004)
    config = CuboidConfig()
    template, tnormals, tmask = template_features(
        jnp.asarray(template_np), jnp.ones(len(template_np), bool), config
    )

    fn = jax.jit(
        lambda d, k: cuboid_pipeline_from_depth(
            d, camera, template, tmask, k, config, template_normals=tnormals
        )
    )
    result = jax.block_until_ready(fn(jnp.asarray(depth), jax.random.key(0)))

    print(f"accepted = {bool(result.accepted)}  "
          f"fitness = {float(result.fitness):.2e} (gate {config.fitness_threshold})")
    print_pose("estimated camera<-cuboid", result.pose)
    bbox_cam = np.asarray(result.bbox)
    print("bbox vertex z range: "
          f"[{bbox_cam[:, 2].min():.3f}, {bbox_cam[:, 2].max():.3f}] m")
    assert bool(result.accepted), "fitness gate should accept the synthetic scene"


if __name__ == "__main__":
    main()
