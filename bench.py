"""Headline benchmark: cuboid-ICP pipeline frames/s on one GPU at 640x480.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

value      = frames/s of the full jitted pipeline (backproject ->
             passthrough -> voxel -> RANSAC plane -> multi-restart
             template ICP) on one GPU, steady-state.
vs_baseline= value / measured PCL-equivalent CPU frames/s (KD-tree ICP
             harness in benchmarks/cpu_baseline.py — BASELINE.md
             requires the denominator to be measured, not quoted).

Every timed loop runs REPEATS passes and reports the median; per-config
run-to-run spread is recorded in extra so the headline's noise floor is
inspectable. The record names the device it ran on; without a GPU the
script exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

REPEATS = 3


def _timed_fps(dispatch, n_items: int, repeats: int = REPEATS):
    """Median frames/s of `dispatch()` (which enqueues n_items frames
    and blocks); returns (median_fps, spread_pct, per_run)."""
    dispatch()  # full warm pass: the first sweep through the frame set
    #             still pays residual autotuning
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        dispatch()
        dt = time.perf_counter() - t0
        runs.append(n_items / dt)
    med = float(np.median(runs))
    spread = 100.0 * (max(runs) - min(runs)) / med
    return med, spread, [round(r, 2) for r in runs]


def main() -> None:
    import jax
    import jax.numpy as jnp

    from perception.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {jax.devices()}")
    dev = jax.devices()[0]

    from perception.geometry.camera import PinholeCamera
    from perception.models.cuboid import CuboidConfig, cuboid_pipeline_from_depth
    from benchmarks.scene import render_depth_tabletop, benchmark_template
    from benchmarks.cpu_baseline import measure_cpu_fps

    from perception.models.cuboid import template_features

    camera = PinholeCamera.d435_depth()
    template_np = benchmark_template()
    config = CuboidConfig()
    # One-time template preprocessing (downsample to pipeline resolution
    # + normals) — host-side numpy, session-constant.
    template, tnormals, template_mask = template_features(
        template_np, np.ones(len(template_np), bool), config
    )

    frames = [
        render_depth_tabletop(camera, seed=s,
                              cuboid_pose_twist=(0.05, 0.03, 0.80, 0.0, 0.0, 0.3 + 0.05 * s))
        for s in range(8)
    ]

    fn = jax.jit(
        lambda depth, key: cuboid_pipeline_from_depth(
            depth, camera, template, template_mask, key, config,
            template_normals=tnormals,
        )
    )

    # Warmup/compile.
    key = jax.random.key(0)
    res = fn(jnp.asarray(frames[0]), key)
    jax.block_until_ready(res)
    print(f"warmup: accepted={bool(res.accepted)} fitness={float(res.fitness):.6f}",
          file=sys.stderr)

    # Steady-state timing (device-side arrays staged up front — frames
    # AND per-frame keys materialized before the clock starts; the host
    # loop double-buffers naturally because dispatch is async).
    dev_frames = [jnp.asarray(f) for f in frames]
    n_timed = 96
    key_list = [k for k in jax.random.split(key, n_timed)]
    for d in dev_frames + key_list:
        jax.block_until_ready(d)


    def dispatch_b1():
        out = None
        for i in range(n_timed):
            out = fn(dev_frames[i % len(dev_frames)], key_list[i])
        jax.block_until_ready(out)

    fps_b1, spread_b1, runs_b1 = _timed_fps(dispatch_b1, n_timed)
    print(f"gpu: {fps_b1:.2f} frames/s batch-1 (spread {spread_b1:.1f}%, {runs_b1})",
          file=sys.stderr)

    # Frame-batched throughput mode: vmap over blocks of B frames
    # (fps-vs-batch curve; the headline is the best steady-state rate).
    from perception.models.cuboid import cuboid_pipeline_batch

    fps_vs_batch = {1: fps_b1}
    spread_vs_batch = {1: round(spread_b1, 1)}
    for B in (2, 4, 8):
        fn_b = jax.jit(
            lambda depths, keys: cuboid_pipeline_batch(
                depths, camera, template, template_mask, keys, config,
                template_normals=tnormals,
            )
        )
        blocks = [
            jnp.stack([dev_frames[(i * B + j) % len(dev_frames)] for j in range(B)])
            for i in range(4)
        ]
        kblocks = [jax.random.split(jax.random.key(100 + i), B) for i in range(4)]
        out_b = fn_b(blocks[0], kblocks[0])
        jax.block_until_ready(out_b)
        n_blocks = max(2, 96 // B)
        for d in blocks + kblocks:
            jax.block_until_ready(d)

        def dispatch_bB():
            out_b = None
            for i in range(n_blocks):
                out_b = fn_b(blocks[i % 4], kblocks[i % 4])
            jax.block_until_ready(out_b)

        fps_vs_batch[B], spread_b, _ = _timed_fps(dispatch_bB, n_blocks * B)
        spread_vs_batch[B] = round(spread_b, 1)
        print(f"batch {B}: {fps_vs_batch[B]:.2f} frames/s (spread {spread_b:.1f}%)",
              file=sys.stderr)

    best_batch = max(fps_vs_batch, key=fps_vs_batch.get)
    gpu_fps = fps_vs_batch[best_batch]

    cpu_fps, cpu_runs = measure_cpu_fps(frames, camera, template_np)
    print(f"cpu baseline: {cpu_fps:.3f} frames/s (median of {cpu_runs})",
          file=sys.stderr)

    # SLAM accuracy + throughput (BASELINE.md "ATE within bound"): the
    # full system over a 300-frame revisit sweep, in three configs —
    # keyframe+BA (flagship config #4), BA-off ablation, and the dense
    # map-fusion mode at 32k points (the voxel-hash NN regime).
    extra = {
        "cpu_baseline_note": (
            "measured numpy/scipy cKDTree harness (PCL-equivalent), "
            "not PCL itself — see benchmarks/cpu_baseline.py; median of "
            "3 passes over 8 frames"
        ),
        "cpu_baseline_runs": [round(r, 3) for r in cpu_runs],
        "fps_vs_batch": {str(k): round(v, 2) for k, v in fps_vs_batch.items()},
        "fps_spread_pct_vs_batch": {str(k): v for k, v in spread_vs_batch.items()},
        "headline_batch": best_batch,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    try:
        from benchmarks.slam_bench import run as run_slam_bench

        slam = run_slam_bench(frames=300, enable_ba=True)
        for k in ("ate_cm", "slam_fps", "loop_closures",
                  "pose_graph_corrections", "keyframes", "ba_runs",
                  "landmarks", "observations"):
            extra[k] = round(slam[k], 3) if isinstance(slam[k], float) else slam[k]
        extra["slam_frames"] = slam["frames"]
        extra["slam_resolution"] = slam["resolution"]
        print(f"slam(BA): ate={slam['ate_cm']:.2f} cm, {slam['slam_fps']:.1f} fps, "
              f"{slam['loop_closures']} loop closures, {slam['ba_runs']} BA runs",
              file=sys.stderr)

        no_ba = run_slam_bench(frames=300, enable_ba=False)
        extra["ate_cm_no_ba"] = round(no_ba["ate_cm"], 3)
        extra["slam_fps_no_ba"] = round(no_ba["slam_fps"], 3)
        print(f"slam(no BA): ate={no_ba['ate_cm']:.2f} cm, "
              f"{no_ba['slam_fps']:.1f} fps", file=sys.stderr)
    except Exception as e:  # never lose the headline metric
        extra["slam_error"] = repr(e)
        print(f"slam bench failed: {e!r}", file=sys.stderr)

    try:
        from benchmarks.slam_bench import run as run_slam_bench

        mm = run_slam_bench(frames=300, enable_ba=True, map_budget=32768)
        extra["map_mode"] = {
            "ate_cm": round(mm["ate_cm"], 3),
            "slam_fps": round(mm["slam_fps"], 3),
            "map_budget": mm["map_budget"],
            "keyframes": mm["keyframes"],
        }
        print(f"slam(map 32k): ate={mm['ate_cm']:.2f} cm, "
              f"{mm['slam_fps']:.1f} fps", file=sys.stderr)
    except Exception as e:
        extra["map_mode_error"] = repr(e)
        print(f"map-mode bench failed: {e!r}", file=sys.stderr)

    try:
        from benchmarks.tracking_bench import run as run_tracking

        tr = run_tracking(frames=300)
        extra["objects_tracking"] = {
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in tr.items()
        }
        print(f"tracking: {tr['tracking_fps']:.1f} fps, median err "
              f"{tr['median_err_cm']:.2f} cm, latched {tr['latched_pct']:.0f}%, "
              f"warm {tr['warm_pct']:.0f}%", file=sys.stderr)
    except Exception as e:
        extra["objects_tracking_error"] = repr(e)
        print(f"tracking bench failed: {e!r}", file=sys.stderr)

    try:
        from benchmarks.facade_bench import run as run_facade

        fb = run_facade(frames=120)
        extra["facade"] = {
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in fb.items()
        }
        print(f"facade: {fb['facade_fps']:.1f} fps "
              f"({fb['extractors']}, {fb['faces_tracked']} faces, "
              f"{fb['resolution']})", file=sys.stderr)
    except Exception as e:
        extra["facade_error"] = repr(e)
        print(f"facade bench failed: {e!r}", file=sys.stderr)

    try:
        from benchmarks.nn_crossover import measure as nn_measure

        extra["nn_crossover"] = nn_measure(
            sizes=[(4096, 8192), (4096, 32768), (16384, 131072), (307200, 32768)]
        )
    except Exception as e:
        extra["nn_crossover_error"] = repr(e)

    print(json.dumps({
        "metric": "cuboid_icp_frames_per_sec_640x480",
        "value": round(gpu_fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(gpu_fps / cpu_fps, 3),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
