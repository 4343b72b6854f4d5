"""Command-line entry point (reference layer L7 / LC).

The reference's CLI surface is roslaunch XML + 91 gflags; the engine
keeps the same two-level design (stringly CLI -> typed dataclass
configs, the ``flagsToOpenPose`` pattern) with argparse subcommands:

  python -m perception.cli cuboid   --depth f.png --template t.pcd
  python -m perception.cli objects  --depth f.png --template t.pcd
  python -m perception.cli odometry --tum  /data/rgbd_dataset_freiburg1_xyz
  python -m perception.cli slam     --tum  /data/... [--ate]
  python -m perception.cli bench

Each command prints JSON-lines results (observability-by-metrics in
place of the reference's observability-by-topic).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def _load_depth(path: str, scale: float) -> np.ndarray:
    import cv2

    from perception.geometry.camera import depth_from_u16

    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise SystemExit(f"cannot read depth image {path}")
    if raw.dtype == np.uint16:
        return depth_from_u16(raw, scale)
    return raw.astype(np.float32)


def _camera(args):
    from perception.geometry.camera import PinholeCamera

    if args.camera == "d435-depth":
        return PinholeCamera.d435_depth()
    if args.camera == "d435-color":
        return PinholeCamera.d435_color()
    if args.camera.startswith("tum"):
        from perception.io.tum import tum_camera

        return tum_camera(int(args.camera[-1]) if args.camera[-1].isdigit() else 1)
    raise SystemExit(f"unknown camera model {args.camera}")


def cmd_cuboid(args) -> None:
    import jax
    import jax.numpy as jnp

    from perception.io.pcd import read_pcd
    from perception.io.templates import cuboid_template
    from perception.models.cuboid import (
        CuboidConfig,
        cuboid_pipeline_from_depth,
        template_features,
    )

    camera = _camera(args)
    config = CuboidConfig(
        voxel_size=args.voxel_size,
        ransac_threshold=args.distance_threshold,
        fitness_threshold=args.icp_fitness_score,
    )
    if args.template:
        tmpl = read_pcd(args.template)
    else:
        tmpl = cuboid_template(*config.dims)
    t_raw = jnp.asarray(tmpl)
    t_mask = jnp.ones(len(tmpl), bool)
    t, tn, tm = template_features(t_raw, t_mask, config)

    depth = jnp.asarray(_load_depth(args.depth, args.depth_scale))
    res = cuboid_pipeline_from_depth(
        depth, camera, t, tm, jax.random.key(args.seed), config, template_normals=tn
    )
    print(json.dumps({
        "accepted": bool(res.accepted),
        "fitness": float(res.fitness),
        "pose": np.asarray(res.pose).tolist(),
        "plane": np.asarray(res.plane).tolist(),
        "num_box_points": int(res.num_box_points),
        "bbox": np.asarray(res.bbox).tolist(),
    }))


def cmd_objects(args) -> None:
    import jax
    import jax.numpy as jnp

    from perception.io.pcd import read_pcd
    from perception.models.objects import ObjectConfig, detect_object

    camera = _camera(args)
    tmpl = read_pcd(args.template)
    depth = jnp.asarray(_load_depth(args.depth, args.depth_scale))
    pts, mask = camera.backproject_depth(depth)
    res = detect_object(
        pts, mask, jnp.asarray(tmpl), jnp.ones(len(tmpl), bool),
        jax.random.key(args.seed), ObjectConfig(),
    )
    print(json.dumps({
        "success": bool(res.success),
        "pose": np.asarray(res.pose).tolist(),
        "fitness": float(res.fitness),
        "num_clusters": int(res.num_clusters),
        "cluster_sizes": np.asarray(res.cluster_sizes).tolist(),
        "size_diff": int(res.size_diff),
    }))


def cmd_odometry(args) -> None:
    import jax.numpy as jnp

    from perception.io.tum import TumSequence, sequence_camera, write_trajectory
    from perception.models.slam.odometry import OdometryConfig, init_state, odometry_step
    from perception.utils.metrics import ate
    from perception.utils.profiler import MetricsLog

    seq = TumSequence(args.tum, with_rgb=False)
    camera = sequence_camera(args.tum, args.freiburg)
    cfg = OdometryConfig()
    log = MetricsLog()

    frames = list(range(0, min(len(seq), args.max_frames), args.stride))
    f0 = seq.frame(frames[0])
    state = init_state(camera, jnp.asarray(np.nan_to_num(f0.depth)), cfg)
    poses, gts, ts = [np.eye(4)], [f0.gt_pose], [f0.timestamp]
    for i in frames[1:]:
        fr = seq.frame(i)
        state, diag = odometry_step(state, jnp.asarray(np.nan_to_num(fr.depth)), camera, cfg)
        poses.append(np.asarray(state.pose))
        gts.append(fr.gt_pose)
        ts.append(fr.timestamp)
        log.emit(frame=i, fitness=float(diag.fitness), overlap=float(diag.overlap),
                 promoted=bool(diag.promoted))

    if args.out:
        write_trajectory(args.out, ts, poses)
    if all(g is not None for g in gts):
        r = ate(np.stack(poses), np.stack(gts))
        log.emit(metric="ate_rmse_m", value=r.rmse, frames=len(poses))


def cmd_slam(args) -> None:
    """Full SLAM (odometry + keyframes + loop closure + pose graph):
    over a TUM sequence, or the synthetic revisit benchmark when no
    --tum is given."""
    from perception.utils.profiler import MetricsLog

    log = MetricsLog()
    if args.tum is None:
        from benchmarks.slam_bench import run as run_slam_bench

        out = run_slam_bench(frames=args.max_frames)
        log.emit(**{k: v for k, v in out.items() if np.isscalar(v)})
        return

    import jax.numpy as jnp

    from perception.io.tum import TumSequence, sequence_camera, write_trajectory
    from perception.models.slam.system import SlamConfig, run_slam
    from perception.utils.metrics import ate

    seq = TumSequence(args.tum, with_rgb=True)
    camera = sequence_camera(args.tum, args.freiburg)
    idxs = list(range(0, min(len(seq), args.max_frames), args.stride))
    frames = [seq.frame(i) for i in idxs]
    depths = [np.nan_to_num(f.depth) for f in frames]
    # Keep gray on the 0-255 scale: SlamConfig.fast_threshold (FAST
    # corner contrast) is calibrated for 8-bit intensities.
    grays = [
        f.rgb.mean(-1).astype(np.float32)
        if f.rgb is not None else np.zeros_like(depths[0])
        for f in frames
    ]
    state, poses, diags = run_slam(camera, depths, grays, SlamConfig())
    poses = [np.asarray(T) for T in poses]
    if args.out:
        write_trajectory(args.out, [f.timestamp for f in frames], poses)
    gts = [f.gt_pose for f in frames]
    if all(g is not None for g in gts):
        r = ate(np.stack(poses), np.stack(gts))
        cfg = SlamConfig()
        closures = sum(
            int(d.loop_candidate) >= 0
            and int(d.loop_inliers) >= cfg.lc_min_inliers
            for d in diags
        )
        log.emit(metric="ate_rmse_m", value=r.rmse, frames=len(poses),
                 loop_closures=closures)


def cmd_pose(args) -> None:
    """Multi-person 2-D pose via the Perception facade (wrapper.py),
    with the in-repo trained fixture (or a synthetic scene when no
    --image is given)."""
    import jax

    from perception.models.pose_fixture import (
        FIXTURE_HW,
        FIXTURE_TOPOLOGY,
        fixture_available,
    )
    from perception.utils.profiler import MetricsLog
    from perception.wrapper import (
        Perception,
        WrapperStructInput,
        WrapperStructPose,
    )

    log = MetricsLog()
    if not fixture_available():
        raise SystemExit("trained fixture missing; run tools/train_pose_fixture.py")
    if args.image:
        import cv2

        img = cv2.imread(args.image)[..., ::-1].astype(np.float32) / 255.0
    else:
        from perception.models.pose_data import render_people, sample_skeletons

        scene = sample_skeletons(jax.random.key(args.seed), FIXTURE_HW)
        img = np.asarray(render_people(scene, FIXTURE_HW))

    # --out-json is written once, explicitly, below (a json_dir sink
    # here would duplicate the same data into a derived directory).
    engine = Perception(
        pose=WrapperStructPose(topology=FIXTURE_TOPOLOGY, net_hw=FIXTURE_HW),
        input=WrapperStructInput(source=[img]),
    )
    for datum in engine.exec():
        ppl = datum.people
        n = int(np.asarray(ppl.mask).sum())
        log.emit(people=n,
                 scores=[round(float(s), 3) for s in np.asarray(ppl.score)[:n]])
        if args.out_json:
            from perception.io.savers import save_people_json

            save_people_json(
                args.out_json, np.asarray(ppl.keypoints), np.asarray(ppl.mask)
            )


def cmd_bench(args) -> None:
    import bench

    bench.main()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="perception")
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--camera", default="d435-depth")
    common.add_argument("--depth-scale", type=float, default=0.001,
                        help="meters per depth unit for u16 PNGs (RealSense 0.001, TUM 0.0002)")
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--cpu", action="store_true",
                        help="force the CPU backend (overrides the env default)")

    c = sub.add_parser("cuboid", parents=[common], help="ground-plane seg + template ICP pose")
    c.add_argument("--depth", required=True)
    c.add_argument("--template", default=None, help=".pcd template (default: generated L200 W100 H30)")
    c.add_argument("--voxel-size", type=float, default=0.005)
    c.add_argument("--distance-threshold", type=float, default=0.015)
    c.add_argument("--icp-fitness-score", type=float, default=0.0004)
    c.set_defaults(fn=cmd_cuboid)

    o = sub.add_parser("objects", parents=[common], help="clustering + multi-object ICP service")
    o.add_argument("--depth", required=True)
    o.add_argument("--template", required=True)
    o.set_defaults(fn=cmd_objects)

    d = sub.add_parser("odometry", parents=[common], help="TUM depth odometry + ATE")
    d.add_argument("--tum", required=True, help="TUM sequence directory")
    d.add_argument("--freiburg", type=int, default=1)
    d.add_argument("--max-frames", type=int, default=200)
    d.add_argument("--stride", type=int, default=1)
    d.add_argument("--out", default=None, help="write TUM-format trajectory")
    d.set_defaults(fn=cmd_odometry)

    s = sub.add_parser("slam", parents=[common],
                       help="full SLAM (odometry+loop closure+pose graph) + ATE")
    s.add_argument("--tum", default=None, help="TUM sequence dir (default: synthetic revisit)")
    s.add_argument("--freiburg", type=int, default=1)
    s.add_argument("--max-frames", type=int, default=300)
    s.add_argument("--stride", type=int, default=1)
    s.add_argument("--out", default=None, help="write TUM-format trajectory")
    s.set_defaults(fn=cmd_slam)

    po = sub.add_parser("pose", parents=[common],
                        help="multi-person 2-D pose (trained fixture)")
    po.add_argument("--image", default=None, help="RGB image (default: synthetic scene)")
    po.add_argument("--out-json", default=None, help="write OpenPose-style people JSON")
    po.set_defaults(fn=cmd_pose)

    b = sub.add_parser("bench", help="run the headline benchmark")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    import jax

    from perception.utils.compile_cache import configure_compile_cache

    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")
    configure_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
