"""perception — an accelerator-native RGB-D perception + SLAM engine.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
``dash-robotics/perception`` reference stack (depth backprojection, RANSAC
plane segmentation, Euclidean clustering, template-ICP pose estimation,
2-D color detection, camera geometry) extended to a full keyframe SLAM
pipeline (feature detection/matching, point-to-plane ICP odometry, bundle
adjustment, pose-graph optimization) that scales over device meshes.

Design principles (see SURVEY.md §7):
  * fixed-capacity arrays + validity masks everywhere (XLA static shapes);
  * nearest-neighbor search via brute-force distance tiles and voxel-hash
    gathers — never KD-trees;
  * RANSAC scoring, ICP Gauss-Newton, and Schur-complement BA as fused
    batched linear algebra (Pallas kernels on the hot paths);
  * multi-chip scaling via jax.sharding meshes + collectives.
"""

__version__ = "0.1.0"

from perception.geometry import se3, camera  # noqa: F401
