"""Every f32 matrix product on the geometric paths asks for full f32.

On the GPU an f32 dot at default precision may run in TF32 (about three
decimal digits). At room-scale coordinates that error is larger than
the map-mode correspondence radius, so every dot that the cuboid, SLAM
and tracking steps lower must carry ``precision = HIGHEST``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.geometry.camera import PinholeCamera


def _cam():
    return PinholeCamera.from_K([60.0, 0, 48, 0, 60.0, 36, 0, 0, 1], width=96, height=72)


def _depth(cam):
    h, w = cam.height, cam.width
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return jnp.asarray(1.5 + 0.1 * np.sin(uu / 9.0) + 0.05 * vv / h, jnp.float32)


def _cuboid():
    from perception.io.templates import cuboid_template
    from perception.models.cuboid import (
        CuboidConfig,
        cuboid_pipeline_from_depth,
        template_features,
    )

    cam = _cam()
    cfg = CuboidConfig(pre_capacity=1024, work_capacity=512, box_capacity=128,
                       template_capacity=128, ransac_hypotheses=64,
                       icp_max_iterations=2)
    t = cuboid_template(0.2, 0.1, 0.03, 0.01)
    tp, tn, tm = template_features(t, np.ones(len(t), bool), cfg)
    fn = jax.jit(lambda d, k: cuboid_pipeline_from_depth(
        d, cam, tp, tm, k, cfg, template_normals=tn))
    return fn.lower(_depth(cam), jax.random.key(0))


def _odometry_map_mode():
    from perception.models.slam.odometry import OdometryConfig, init_state, odometry_step

    cam = _cam()
    cfg = OdometryConfig(point_budget=256, keyframe_budget=512, map_budget=1024,
                         icp_iterations=3)
    state = init_state(cam, _depth(cam), cfg)
    return odometry_step.lower(state, _depth(cam), cam, cfg)


def _slam():
    from perception.models.slam.odometry import OdometryConfig
    from perception.models.slam.system import SlamConfig, slam_init, slam_step

    cam = _cam()
    cfg = SlamConfig(
        odometry=OdometryConfig(point_budget=256, keyframe_budget=512, icp_iterations=3),
        max_keyframes=8, max_edges=16, features_per_kf=32, max_landmarks=64,
        max_observations=128, ba_iterations=1, pg_iterations=1,
    )
    d = _depth(cam)
    gray = jnp.asarray(np.random.RandomState(0).rand(cam.height, cam.width) * 255, jnp.float32)
    state = slam_init(cam, d, gray, cfg)
    return slam_step.lower(state, d, gray, cam, jax.random.key(0), cfg)


def _tracking():
    from perception.io.templates import cuboid_template
    from perception.models.object_tracking import (
        TrackingConfig,
        init_tracks,
        track_step_from_depth,
    )
    from perception.models.objects import ObjectConfig

    cam = _cam()
    cfg = TrackingConfig(
        detection=ObjectConfig(work_capacity=512, offplane_capacity=256,
                               cluster_capacity=256, cluster_min_size=10,
                               ransac_hypotheses=64, icp_max_iterations=2),
        max_tracks=2, depth_stride=1, warm_icp_iterations=2,
    )
    t = cuboid_template(0.2, 0.1, 0.03, 0.02)
    tmpl = jnp.broadcast_to(jnp.asarray(t), (2,) + t.shape)
    tmask = jnp.ones(tmpl.shape[:2], bool)
    fn = jax.jit(lambda s, d, k: track_step_from_depth(s, d, cam, tmpl, tmask, k, cfg))
    return fn.lower(init_tracks(cfg), _depth(cam), jax.random.key(0))


CASES = {
    "cuboid_pipeline_from_depth": _cuboid,
    "odometry_step": _odometry_map_mode,
    "slam_step": _slam,
    "track_step": _tracking,
}


def f32_dots_below_highest(text: str):
    """StableHLO dot ops on f32 operands that do not ask for HIGHEST."""
    bad = []
    for line in text.splitlines():
        if not re.search(r"stablehlo\.dot(_general)?\b", line):
            continue
        types = line.rsplit(":", 1)[-1]
        if "f32" in types and "precision = [HIGHEST, HIGHEST]" not in line:
            bad.append(line.strip())
    return bad


@pytest.mark.parametrize("name", list(CASES))
def test_every_f32_dot_is_highest(name):
    text = CASES[name]().as_text()
    assert "stablehlo.dot_general" in text  # the path does have products
    bad = f32_dots_below_highest(text)
    assert not bad, f"{len(bad)} f32 dots below HIGHEST, first: {bad[0]}"
