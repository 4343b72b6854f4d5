"""Pose-graph optimization benchmark at N=256 keyframes (VERDICT r1
item 8): analytic per-edge Jacobian blocks scatter-assembled into the
(6N, 6N) normal system, 10 GN iterations.

Run: python -m benchmarks.pose_graph_bench [N] [E]
"""

from __future__ import annotations

import sys
import time


def run(n_nodes: int = 256, n_edges: int = 768, iterations: int = 10) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from perception.geometry import se3
    from perception.models.slam.backend import PoseGraph, optimize_pose_graph

    rng = np.random.default_rng(0)
    # Ground-truth poses on a loop; noisy odometry chain + loop edges.
    t = np.linspace(0, 2 * np.pi, n_nodes, endpoint=False)
    gt_t = np.stack([np.cos(t), np.sin(t), 0.1 * np.sin(3 * t)], 1)
    gt = np.tile(np.eye(4), (n_nodes, 1, 1))
    gt[:, :3, 3] = gt_t
    gt = jnp.asarray(gt, jnp.float32)

    noise = jnp.asarray(rng.normal(size=(n_nodes, 6)) * 0.03, jnp.float32)
    init = se3.se3_exp(noise) @ gt

    ei = np.arange(n_edges) % (n_nodes - 1)
    ej = ei + 1
    # every 8th edge becomes a random loop edge
    loop = np.arange(0, n_edges, 8)
    ej[loop] = (ei[loop] + rng.integers(2, n_nodes - 1, size=len(loop))) % n_nodes
    ei_j = jnp.asarray(ei, jnp.int32)
    ej_j = jnp.asarray(ej, jnp.int32)
    T_meas = se3.inverse(gt[ei_j]) @ gt[ej_j]

    graph = PoseGraph(
        poses_wc=init, edge_i=ei_j, edge_j=ej_j, edge_T=T_meas,
        edge_weight=jnp.ones(n_edges), edge_mask=ei_j != ej_j,
    )

    opt, c0, c1 = optimize_pose_graph(graph, iterations=iterations)
    jax.block_until_ready(opt)
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        opt, c0, c1 = optimize_pose_graph(graph, iterations=iterations)
    jax.block_until_ready(opt)
    ms = (time.perf_counter() - t0) / reps * 1000.0

    err = jnp.linalg.norm(opt[:, :3, 3] - gt[:, :3, 3], axis=-1)
    return {
        "nodes": n_nodes,
        "edges": n_edges,
        "iterations": iterations,
        "ms_per_solve": round(ms, 2),
        "initial_cost": float(c0),
        "final_cost": float(c1),
        "mean_translation_error_m": float(err.mean()),
    }


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    e = int(sys.argv[2]) if len(sys.argv) > 2 else 768
    for k, v in run(n, e).items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
