"""Streaming multi-cuboid tracking tests (BASELINE config #2).

VERDICT r2 item 4: K tracked object slots over a frame stream with
warm-started ICP and the reference's latch/republish semantics
(iterative_closest_point.cpp:139-147, object_pose_detection.cpp:249-268).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from perception.geometry.camera import PinholeCamera
from perception.io.templates import cuboid_template
from perception.models.objects import ObjectConfig
from perception.models.object_tracking import (
    TrackingConfig,
    init_tracks,
    track_step_from_depth,
)
from benchmarks.tracking_scene import (
    CUBOID_SET,
    camera_trajectory,
    render_depth_cuboids,
)

# Long e2e sweeps: run with `-m slow` (core suite excludes them).
pytestmark = pytest.mark.slow

K = 3


def small_camera():
    return PinholeCamera.from_K(
        [192.0, 0, 160, 0, 192.0, 120, 0, 0, 1], width=320, height=240
    )


def stacked_templates(density=0.004):
    tmpls = [cuboid_template(*dims, density=density) for dims, _ in CUBOID_SET]
    Nt = max(len(t) for t in tmpls)
    templates = np.zeros((K, Nt, 3), np.float32)
    masks = np.zeros((K, Nt), bool)
    for k, t in enumerate(tmpls):
        templates[k, : len(t)] = t
        masks[k, : len(t)] = True
    return jnp.asarray(templates), jnp.asarray(masks)


def tracking_cfg():
    return TrackingConfig(
        detection=ObjectConfig(
            cluster_min_size=60,
            work_capacity=16384,
            table_z_cut=0.9,
            z_limits=(0.0, 0.9),
            x_limits=(-0.35, 0.35),
        ),
        max_tracks=K,
    )


def nearest_gt_err(pose, gt_poses):
    p = np.asarray(pose)[:3, 3]
    return min(np.linalg.norm(p - np.asarray(g)[:3, 3]) for g in gt_poses)


def test_tracks_all_cuboids_with_warm_icp():
    camera = small_camera()
    templates, tmasks = stacked_templates()
    cfg = tracking_cfg()
    traj = camera_trajectory(8)
    slots = init_tracks(cfg)
    key = jax.random.key(0)
    warm_hits = 0
    for i, Twc in enumerate(traj):
        depth, gt = render_depth_cuboids(camera, Twc, seed=i)
        key, sub = jax.random.split(key)
        slots, diag = track_step_from_depth(
            slots, jnp.asarray(depth), camera, templates, tmasks, sub, cfg
        )
        if i >= 1:
            warm_hits += int(np.asarray(diag.used_warm).sum())
    # All three objects latched; slot k tracks ITS OWN object (identity
    # binding via normalized-size cold assignment) within 3 cm.
    assert bool(jnp.all(slots.latched))
    depth, gt = render_depth_cuboids(camera, traj[-1], seed=len(traj) - 1)
    errs = [
        float(np.linalg.norm(np.asarray(slots.pose[k])[:3, 3] - gt[k][:3, 3]))
        for k in range(K)
    ]
    assert max(errs) < 0.03, errs
    # Warm-started continuation carried the tracks (not per-frame
    # re-detection): most post-latch frames used the warm row.
    assert warm_hits >= (len(traj) - 1) * K - 3, warm_hits


@pytest.mark.slow
def test_latch_republishes_then_redetects_on_loss():
    """Reference latch semantics: a lost object's slot republishes the
    cached pose for up to max_misses frames, then re-enters detection;
    when the object reappears the slot re-latches."""
    camera = small_camera()
    templates, tmasks = stacked_templates()
    cfg = tracking_cfg()
    import dataclasses
    cfg = dataclasses.replace(cfg, max_misses=2)
    Twc = camera_trajectory(1)[0]

    slots = init_tracks(cfg)
    key = jax.random.key(1)
    # Latch all three.
    for i in range(3):
        depth, _ = render_depth_cuboids(camera, Twc, seed=i)
        key, sub = jax.random.split(key)
        slots, _ = track_step_from_depth(
            slots, jnp.asarray(depth), camera, templates, tmasks, sub, cfg
        )
    assert bool(jnp.all(slots.latched))
    cached_pose = np.asarray(slots.pose[2])

    # Remove object 2 from the scene.
    without = CUBOID_SET[:2]
    for i in range(2):
        depth, _ = render_depth_cuboids(camera, Twc, cuboids=without, seed=10 + i)
        key, sub = jax.random.split(key)
        slots, _ = track_step_from_depth(
            slots, jnp.asarray(depth), camera, templates, tmasks, sub, cfg
        )
        # Republish phase: still latched, pose cached, misses counting.
        assert bool(slots.latched[2])
        np.testing.assert_allclose(np.asarray(slots.pose[2]), cached_pose, atol=1e-6)
    # Third consecutive miss exceeds max_misses=2 -> slot unlatches.
    depth, _ = render_depth_cuboids(camera, Twc, cuboids=without, seed=12)
    key, sub = jax.random.split(key)
    slots, _ = track_step_from_depth(
        slots, jnp.asarray(depth), camera, templates, tmasks, sub, cfg
    )
    assert not bool(slots.latched[2])

    # Object returns -> the open slot re-detects and re-latches.
    for i in range(2):
        depth, gt = render_depth_cuboids(camera, Twc, seed=20 + i)
        key, sub = jax.random.split(key)
        slots, _ = track_step_from_depth(
            slots, jnp.asarray(depth), camera, templates, tmasks, sub, cfg
        )
    assert bool(slots.latched[2])
    assert nearest_gt_err(slots.pose[2], gt) < 0.03


@pytest.mark.slow
def test_other_slots_unaffected_by_one_loss():
    camera = small_camera()
    templates, tmasks = stacked_templates()
    cfg = tracking_cfg()
    Twc = camera_trajectory(1)[0]
    slots = init_tracks(cfg)
    key = jax.random.key(2)
    for i in range(2):
        depth, _ = render_depth_cuboids(camera, Twc, seed=i)
        key, sub = jax.random.split(key)
        slots, _ = track_step_from_depth(
            slots, jnp.asarray(depth), camera, templates, tmasks, sub, cfg
        )
    depth, gt = render_depth_cuboids(camera, Twc, cuboids=CUBOID_SET[:2], seed=5)
    key, sub = jax.random.split(key)
    slots, _ = track_step_from_depth(
        slots, jnp.asarray(depth), camera, templates, tmasks, sub, cfg
    )
    assert bool(slots.latched[0]) and bool(slots.latched[1])
    assert nearest_gt_err(slots.pose[0], gt) < 0.03
    assert nearest_gt_err(slots.pose[1], gt) < 0.03
