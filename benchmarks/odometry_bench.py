"""Odometry throughput benchmark (BASELINE config #3 evidence).

Measures frames/s of the dense point-to-plane odometry step at 640x480
on the current backend. Not the driver headline metric (bench.py is),
but the second number the north star cares about.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from perception.geometry import se3
    from perception.geometry.camera import PinholeCamera
    from perception.models.slam.odometry import (
        OdometryConfig,
        init_state,
        odometry_step,
    )

    cam = PinholeCamera.d435_depth()
    cfg = OdometryConfig()

    # Synthetic room sweep at full 640x480.
    H, W = cam.height, cam.width
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, float)], -1)

    def render(T_wc, seed):
        T = np.asarray(T_wc, np.float64)
        o, d = T[:3, 3], rays @ T[:3, :3].T
        depth = np.full((H, W), np.inf)
        for n, c in [((0, 1.0, 0), 0.9), ((0, -1.0, 0), 0.9), ((0, 0, 1.0), 3.0),
                     ((1.0, 0, 0), 1.5), ((-1.0, 0, 0), 1.5)]:
            n = np.asarray(n)
            denom = d @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (c - o @ n) / denom
            t = np.where((t > 0.1) & (denom != 0), t, np.inf)
            depth = np.minimum(depth, np.where(np.isfinite(t), t * rays[..., 2], np.inf))
        depth[~np.isfinite(depth)] = 0.0
        rng = np.random.RandomState(seed)
        return (depth + rng.randn(H, W) * 0.002).astype(np.float32)

    frames = []
    for i in range(10):
        tw = jnp.asarray([0.01 * i, 0.0, 0.005 * i, 0.0, 0.004 * i, 0.0], jnp.float32)
        frames.append(jnp.asarray(render(np.asarray(se3.se3_exp(tw)), i)))

    for f in frames:
        jax.block_until_ready(f)

    import dataclasses

    # Both target regimes: the default keyframe budget and a 32k one.
    for pt_budget, kf_budget in ((cfg.point_budget, cfg.keyframe_budget),
                                 (8192, 32768)):
        cfg_m = dataclasses.replace(
            cfg, point_budget=pt_budget, keyframe_budget=kf_budget,
        )
        state = init_state(cam, frames[0], cfg_m)
        state, diag = odometry_step(state, frames[1], cam, cfg_m)
        jax.block_until_ready(state)
        print(f"warmup overlap={float(diag.overlap):.2f}", file=sys.stderr)

        n_timed = 40
        t0 = time.perf_counter()
        for i in range(n_timed):
            state, diag = odometry_step(state, frames[i % 10], cam, cfg_m)
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        print(f"odometry: {n_timed / dt:.1f} frames/s "
              f"({dt / n_timed * 1000:.2f} ms/frame) at 640x480, "
              f"budget={pt_budget} pts vs kf {kf_budget}")


if __name__ == "__main__":
    main()
