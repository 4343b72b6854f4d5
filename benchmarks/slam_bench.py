"""Driver-visible SLAM benchmark: ATE + throughput over a long revisit
trajectory (BASELINE.md "ATE within bound").

Runs the full keyframe SLAM system (dense ICP odometry + landmark
tracks + sliding-window local BA + loop closure + pose-graph
correction) over a >=300-frame synthetic textured-room sweep with
multiple revisits, and reports:

  ate_cm         RMSE absolute trajectory error vs ground truth (cm)
  slam_fps       full-system frames/s (steady state, excludes render)
  loop_closures  verified loop-closure edges live at the end
  ba_runs        sliding-window bundle-adjust invocations (the BA
                 path must fire on the sweep)

Three configurations are benchmarked by bench.py: keyframe mode with
BA (the flagship config #4), keyframe mode without BA (the ablation),
and dense map-fusion mode at map_budget >= 32768.

Run: python -m benchmarks.slam_bench
"""

from __future__ import annotations

import time

_RENDER_CACHE: dict = {}


def rendered_sequence(frames: int, width: int, height: int):
    """(camera, gt, grays, depths) — cached so the three bench configs
    share one host-side render pass."""
    key = (frames, width, height)
    if key not in _RENDER_CACHE:
        from benchmarks.slam_scene import render_sequence, sweep_trajectory
        from perception.geometry.camera import PinholeCamera

        fx = 307.0 * width / 320.0
        camera = PinholeCamera.from_K(
            [fx, 0, width / 2, 0, fx, height / 2, 0, 0, 1],
            width=width, height=height,
        )
        gt = sweep_trajectory(n=frames)
        grays, depths = render_sequence(camera, gt)
        _RENDER_CACHE[key] = (camera, gt, grays, depths)
    return _RENDER_CACHE[key]


def slam_config(enable_ba: bool = True, map_budget: int = 0,
                map_nn: str = "auto", **odom_overrides):
    """The bench's SlamConfig; ``odom_overrides`` land on OdometryConfig
    (e.g. icp_iterations, point_budget) for map-mode tuning sweeps."""
    from perception.models.slam.odometry import OdometryConfig
    from perception.models.slam.system import SlamConfig

    odom_kw = dict(
        point_budget=2048,
        keyframe_budget=4096,
        icp_iterations=8,
        min_depth=0.1,
        max_depth=6.0,
        normal_max_edge=0.1,
        kf_translation=0.10,
        kf_rotation=0.12,
        map_budget=map_budget,
        map_nn=map_nn,
    )
    odom_kw.update(odom_overrides)
    return SlamConfig(
        odometry=OdometryConfig(**odom_kw),
        max_keyframes=64,
        max_edges=192,
        features_per_kf=256,
        fast_threshold=15.0,
        lc_min_gap=3,
        lc_min_matches=20,
        lc_min_inliers=10,
        enable_ba=enable_ba,
    )


def track(camera, depths, grays, cfg):
    """Run slam_step over the frames on the default device.

    Returns (poses (n, 4, 4) numpy, final state, BA runs, pose-graph
    corrections, seconds of the steady-state loop). The first step is
    run once before the clock starts so compilation is excluded."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from perception.models.slam.system import slam_init, slam_step

    state = slam_init(camera, jnp.asarray(depths[0]), jnp.asarray(grays[0]), cfg)
    key = jax.random.key(0)

    # Warm the compile with one step so timing is steady-state.
    key, sub = jax.random.split(key)
    warm, _ = slam_step(state, jnp.asarray(depths[1]), jnp.asarray(grays[1]),
                        camera, sub, cfg)
    jax.block_until_ready(warm.odom.pose)

    # Stage frames on device up-front (the prefetcher does this in
    # production; here it keeps host decode out of the timed loop), and
    # wait for the uploads before the clock starts.
    dj = [jnp.asarray(d) for d in depths]
    gj = [jnp.asarray(g) for g in grays]
    jax.block_until_ready((dj, gj))

    # Pure async dispatch: corrections and BA run on-device inside
    # slam_step (lax.cond), so the timed loop never syncs on a flag.
    poses = [jnp.eye(4)]
    flags = []
    ba_flags = []
    key = jax.random.key(0)
    t0 = time.perf_counter()
    for d, g in zip(dj[1:], gj[1:]):
        key, sub = jax.random.split(key)
        state, diag = slam_step(state, d, g, camera, sub, cfg)
        poses.append(state.odom.pose)
        flags.append(state.loop_found)
        ba_flags.append(diag.ba_ran)
    jax.block_until_ready(state.odom.pose)
    dt = time.perf_counter() - t0
    n_corrections = int(jnp.sum(jnp.stack(flags)))
    n_ba = int(jnp.sum(jnp.stack(ba_flags)))
    est = np.stack([np.asarray(p) for p in poses])
    return est, state, n_ba, n_corrections, dt


def loop_closures(state) -> int:
    """Verified loop-closure edges live in the final state."""
    import numpy as np

    w = np.asarray(state.edges.weight)
    m = np.asarray(state.edges.mask)
    return int(((w == 2.0) & m).sum())


def run(
    frames: int = 300,
    width: int = 640,
    height: int = 480,
    enable_ba: bool = True,
    map_budget: int = 0,
    map_nn: str = "auto",
    **odom_overrides,
) -> dict:
    import jax.numpy as jnp
    import numpy as np

    from perception.utils.metrics import ate

    camera, gt, grays, depths = rendered_sequence(frames, width, height)
    cfg = slam_config(enable_ba, map_budget, map_nn, **odom_overrides)
    est, state, n_ba, n_corrections, dt = track(camera, depths, grays, cfg)
    res = ate(est, np.stack([np.asarray(T) for T in gt]), align=False)

    return {
        "ate_cm": float(res.rmse * 100.0),
        "slam_fps": (frames - 1) / dt,
        "loop_closures": loop_closures(state),
        "pose_graph_corrections": n_corrections,
        "ba_runs": n_ba,
        "landmarks": int(jnp.sum(state.landmarks.mask)),
        "observations": int(jnp.sum(state.obs.mask)),
        "frames": frames,
        "keyframes": int(state.keyframes.count),
        "resolution": f"{width}x{height}",
        "map_budget": map_budget,
    }


def main() -> None:
    for label, kwargs in (
        ("keyframe+BA", dict(enable_ba=True)),
        ("keyframe, no BA", dict(enable_ba=False)),
        ("map-fusion 32k", dict(enable_ba=True, map_budget=32768)),
    ):
        out = run(**kwargs)
        print(f"--- {label} ---")
        for k, v in out.items():
            print(f"{k}: {v}")


if __name__ == "__main__":
    main()
