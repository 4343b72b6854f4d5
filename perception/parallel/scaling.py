"""Scaling-efficiency harness (BASELINE.md: >=80% at 2+ hosts).

Measures frames/s of the distributed odometry step at increasing device
counts and reports efficiency = throughput(N) / (N * throughput(1)).
On a multi-GPU host the same harness runs unchanged; in CI it runs on
the virtual CPU mesh to validate the
*sharding structure* (a CPU mesh shares one physical socket, so its
efficiency numbers are structural, not performance, evidence).
"""

from __future__ import annotations

import time
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry import se3
from perception.ops.normals import normals_knn
from perception.parallel.icp_dist import make_distributed_icp_step
from perception.parallel.mesh import frame_sharding, make_mesh


def _make_problem(B, N, M, seed=0):
    key = jax.random.key(seed)
    target = jax.random.uniform(key, (M, 3), minval=-0.3, maxval=0.3)
    target = target.at[: M // 3, 2].set(0.0)
    target = target.at[M // 3 : 2 * M // 3, 1].set(0.0)
    target = target.at[2 * M // 3 :, 0].set(0.0)
    tgt_mask = jnp.ones(M, bool)
    tgt_normals, _ = normals_knn(target, tgt_mask, k=8)
    twists = jax.random.normal(jax.random.key(1), (B, 6)) * 0.02
    Ts = se3.se3_exp(twists)
    sel = jax.random.randint(jax.random.key(2), (B, N), 0, M)
    frames = jax.vmap(lambda T, s: se3.transform_points(se3.inverse(T), target[s]))(Ts, sel)
    masks = jnp.ones((B, N), bool)
    init_T = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))
    return frames, masks, init_T, target, tgt_normals, tgt_mask


def measure_scaling(
    device_counts: List[int],
    frames_per_device: int = 8,
    points: int = 2048,
    map_points: int = 4096,
    iterations: int = 6,
    reps: int = 5,
) -> Dict[int, dict]:
    """Throughput at each device count (weak scaling: B = fpd * n)."""
    results = {}
    for n in device_counts:
        if n > len(jax.devices()):
            continue
        sp = 1
        mesh = make_mesh(dp=n, sp=sp, devices=jax.devices()[:n])
        B = frames_per_device * n
        frames, masks, init_T, tgt, tn, tm = _make_problem(B, points, map_points)
        fs = frame_sharding(mesh)
        frames = jax.device_put(frames, fs)
        masks = jax.device_put(masks, fs)
        step = make_distributed_icp_step(mesh, iterations=iterations)
        out = step(frames, masks, init_T, tgt, tn, tm)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step(frames, masks, init_T, tgt, tn, tm)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        fps = B * reps / dt
        results[n] = {"frames_per_sec": fps, "batch": B}
    base = results.get(device_counts[0], {}).get("frames_per_sec")
    if base:
        n0 = device_counts[0]
        for n, r in results.items():
            r["efficiency"] = r["frames_per_sec"] / (base * n / n0)
    return results


if __name__ == "__main__":
    import json

    counts = [1, 2, 4, 8]
    res = measure_scaling([c for c in counts if c <= len(jax.devices())])
    print(json.dumps(res, indent=2, default=float))
