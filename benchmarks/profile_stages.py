"""Per-stage roofline breakdown of the cuboid pipeline + SLAM odometry.

For every stage: steady-state ms, XLA-reported FLOPs and bytes moved,
achieved GFLOP/s and GB/s, and % of the card's f32 / HBM peaks
(utils/roofline.py). Run on the GPU: python -m
benchmarks.profile_stages [--json out.json]
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from perception.utils.roofline import (
    HEADER,
    device_peaks,
    measure_stage,
)


def cuboid_stages(results):
    from perception.geometry.camera import PinholeCamera
    from perception.models.cuboid import (
        CuboidConfig, cuboid_pipeline_from_depth, estimate_cuboid_pose,
        template_features,
    )
    from perception.ops import points as P
    from perception.ops.cluster import euclidean_cluster
    from perception.ops.ransac import ransac_plane
    from benchmarks.scene import render_depth_tabletop, benchmark_template

    camera = PinholeCamera.d435_depth()
    config = CuboidConfig()
    template_np = benchmark_template()
    template, tnormals, tmask = template_features(
        template_np, np.ones(len(template_np), bool), config
    )
    depth = jnp.asarray(render_depth_tabletop(camera, seed=0))
    key = jax.random.key(0)

    @jax.jit
    def s1(depth):
        st = config.depth_stride
        cam = camera
        if st > 1:
            o = st // 2
            depth = depth[o::st, o::st]
            cam = dataclasses.replace(camera, fx=camera.fx/st, fy=camera.fy/st,
                                      cx=(camera.cx-o)/st, cy=(camera.cy-o)/st,
                                      width=depth.shape[1], height=depth.shape[0])
        pts, m = cam.backproject_depth(depth)
        m = P.passthrough(pts, m, 2, *config.z_limits)
        m = P.passthrough(pts, m, 0, *config.x_limits)
        return P.compact(pts, m, config.pre_capacity)

    cpts, cm = s1(depth)
    results.append(measure_stage("cuboid/backproject+compact", s1, depth))

    @jax.jit
    def s2(cpts, cm):
        d0, m0 = P.voxel_downsample(cpts, cm, config.voxel_size)
        return P.compact(d0, m0, config.work_capacity)

    dpts, dm = s2(cpts, cm)
    results.append(measure_stage("cuboid/voxel+compact", s2, cpts, cm))

    @jax.jit
    def s3(dpts, dm, key):
        return ransac_plane(dpts, dm, key, threshold=config.ransac_threshold,
                            num_hypotheses=config.ransac_hypotheses)

    fit = s3(dpts, dm, key)
    results.append(measure_stage("cuboid/ransac-plane", s3, dpts, dm, key))

    @jax.jit
    def s4a(dpts, dm, inl):
        box_pts, box_m = P.compact(dpts, dm & ~inl, config.box_capacity)
        cl = euclidean_cluster(box_pts, box_m, tolerance=config.cluster_tolerance,
                               min_size=1, max_size=config.box_capacity, max_clusters=8)
        box_m = box_m & (cl.labels == 0)
        return P.apply_mask(box_pts, box_m), box_m

    box_pts, box_m = s4a(dpts, dm, fit.inliers)
    results.append(measure_stage("cuboid/compact+cluster", s4a, dpts, dm, fit.inliers))

    @jax.jit
    def s4(box_pts, box_m):
        return estimate_cuboid_pose(box_pts, box_m, template, tmask, config,
                                    template_normals=tnormals)

    _ = s4(box_pts, box_m)
    results.append(measure_stage(
        f"cuboid/icp({config.icp_restarts}x{config.icp_max_iterations})",
        s4, box_pts, box_m,
    ))

    fn = jax.jit(lambda d, k: cuboid_pipeline_from_depth(
        d, camera, template, tmask, k, config, template_normals=tnormals))
    _ = fn(depth, key)
    results.append(measure_stage("cuboid/FULL-pipeline", fn, depth, key))


def odometry_stages(results):
    """SLAM odometry: frame features, brute-NN GN (keyframe mode), and
    voxel-hash NN (map mode at 32k) — the stages the GN-ICP kernel
    verdict rests on."""
    from benchmarks.slam_scene import render_textured_room, sweep_trajectory
    from perception.geometry.camera import PinholeCamera
    from perception.models.slam.odometry import (
        OdometryConfig, _frame_features, init_state, odometry_step,
    )
    from perception.ops import nn as _nn
    from perception.ops import voxelhash

    W, H = 640, 480
    fx = 307.0 * W / 320.0
    camera = PinholeCamera.from_K(
        [fx, 0, W / 2, 0, fx, H / 2, 0, 0, 1], width=W, height=H
    )
    gt = sweep_trajectory(n=4)
    frames = [render_textured_room(camera, T, seed=i)[1] for i, T in enumerate(gt)]
    cfg = OdometryConfig(point_budget=2048, keyframe_budget=4096,
                         icp_iterations=8, min_depth=0.1, max_depth=6.0,
                         normal_max_edge=0.1)

    d0 = jnp.asarray(frames[0])
    d1 = jnp.asarray(frames[1])

    feat = jax.jit(lambda d: _frame_features(camera, d, cfg))
    _ = feat(d1)
    results.append(measure_stage("odom/frame-features(640x480)", feat, d1))

    state = init_state(camera, d0, cfg)
    step = jax.jit(lambda s, d: odometry_step(s, d, camera, cfg))
    _ = step(state, d1)
    results.append(measure_stage("odom/step-keyframe(2048x4096)", step, state, d1))

    # Isolated brute NN at odometry shapes (the GN inner loop's cost).
    q = jax.random.normal(jax.random.key(0), (2048, 3))
    ref = jax.random.normal(jax.random.key(1), (4096, 3))
    mask = jnp.ones(4096, bool)
    nn_j = jax.jit(lambda a, b, m: _nn.nearest_neighbor(a, b, m))
    _ = nn_j(q, ref, mask)
    results.append(measure_stage("odom/brute-NN(2048x4096)", nn_j, q, ref, mask))

    ref32 = jax.random.normal(jax.random.key(2), (32768, 3)) * 2.0
    m32 = jnp.ones(32768, bool)
    nn32 = jax.jit(lambda a, b, m: _nn.nearest_neighbor(a, b, m))
    _ = nn32(q, ref32, m32)
    results.append(measure_stage("odom/brute-NN(2048x32768)", nn32, q, ref32, m32))

    vh = voxelhash.build(ref32, m32, cell_size=0.06)
    vq = jax.jit(lambda v, a: voxelhash.query(v, a))
    _ = vq(vh, q)
    results.append(measure_stage("odom/voxelhash-NN(2048x32768)", vq, vh, q))

    cfg_map = dataclasses.replace(cfg, map_budget=32768)
    state_m = init_state(camera, d0, cfg_map)
    step_m = jax.jit(lambda s, d: odometry_step(s, d, camera, cfg_map))
    _ = step_m(state_m, d1)
    results.append(measure_stage("odom/step-map32k", step_m, state_m, d1))


def main():
    json_out = None
    if "--json" in sys.argv:
        json_out = sys.argv[sys.argv.index("--json") + 1]

    dev = jax.devices()[0]
    peaks = device_peaks(dev)
    print(f"device: {dev.device_kind} ({dev.platform}); peaks {peaks}")
    results = []
    cuboid_stages(results)
    odometry_stages(results)

    print(HEADER)
    for st in results:
        print(st.row())

    if json_out:
        with open(json_out, "w") as f:
            json.dump(
                {
                    "device": dev.device_kind,
                    "peaks": peaks._asdict(),
                    "stages": [dataclasses.asdict(s) for s in results],
                },
                f, indent=1,
            )
        print(f"wrote {json_out}")


if __name__ == "__main__":
    main()
