"""Sweep cuboid-pipeline capacities/restarts on the GPU:
acceptance across all bench scenes (must stay 1.00) + steady-state fps.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def run_variant(name, config, camera, template_np, frames):
    from perception.models.cuboid import cuboid_pipeline_from_depth, template_features

    template, tnormals, tmask = template_features(
        template_np, np.ones(len(template_np), bool), config
    )
    fn = jax.jit(lambda d, k: cuboid_pipeline_from_depth(
        d, camera, template, tmask, k, config, template_normals=tnormals))

    key = jax.random.key(0)
    dev = [jnp.asarray(f) for f in frames]
    acc, fit = [], []
    for i, d in enumerate(dev):
        r = fn(d, jax.random.fold_in(key, i))
        jax.block_until_ready(r)
        acc.append(bool(r.accepted))
        fit.append(float(r.fitness))

    n_timed = 48
    keys = [k for k in jax.random.split(key, n_timed)]
    for x in dev + keys:
        jax.block_until_ready(x)
    t0 = time.perf_counter()
    out = None
    for i in range(n_timed):
        out = fn(dev[i % len(dev)], keys[i])
    jax.block_until_ready(out)
    fps = n_timed / (time.perf_counter() - t0)
    print(f"{name:12s} fps={fps:7.2f}  acc={sum(acc)}/{len(acc)}  "
          f"fitness_max={max(fit):.6f}", flush=True)
    return fps, acc


def main():
    from perception.geometry.camera import PinholeCamera
    from perception.models.cuboid import CuboidConfig
    from benchmarks.scene import render_depth_tabletop, benchmark_template

    camera = PinholeCamera.d435_depth()
    template_np = benchmark_template()
    frames = [
        render_depth_tabletop(camera, seed=s,
                              cuboid_pose_twist=(0.05, 0.03, 0.80, 0.0, 0.0, 0.3 + 0.05 * s))
        for s in range(8)
    ]

    base = CuboidConfig()
    variants = [
        ("base", base),
        ("boxtmpl1k", dataclasses.replace(base, box_capacity=1024, template_capacity=1280)),
        ("restarts4", dataclasses.replace(base, box_capacity=1024, template_capacity=1280,
                                          icp_restarts=4)),
        ("work8k", dataclasses.replace(base, box_capacity=1024, template_capacity=1280,
                                       icp_restarts=4, work_capacity=8192)),
        ("iters14", dataclasses.replace(base, box_capacity=1024, template_capacity=1280,
                                        icp_restarts=4, work_capacity=8192,
                                        icp_max_iterations=14)),
        ("pre32k", dataclasses.replace(base, box_capacity=1024, template_capacity=1280,
                                       icp_restarts=4, work_capacity=8192,
                                       pre_capacity=32768)),
        ("hyp512", dataclasses.replace(base, box_capacity=1024, template_capacity=1280,
                                       icp_restarts=4, work_capacity=8192,
                                       ransac_hypotheses=512)),
    ]
    for name, cfg in variants:
        try:
            run_variant(name, cfg, camera, template_np, frames)
        except Exception as e:  # keep sweeping
            print(f"{name:12s} FAILED: {e}", flush=True)


if __name__ == "__main__":
    main()
