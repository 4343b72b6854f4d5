"""Distributed pose-graph tests: edge-sharded GN equals the
single-device solver; async block-Jacobi relaxation converges.
(VERDICT r2 item 7 / BASELINE config #5.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.geometry import se3
from perception.models.slam.backend import PoseGraph, optimize_pose_graph
from perception.parallel.mesh import make_mesh
from perception.parallel.pg_dist import (
    make_async_pose_graph_relaxer,
    make_distributed_pose_graph_step,
)


def ring_graph(key, N=16, E=48, noise=0.02, drift=0.05):
    """Odometry ring + random loop edges, with noisy initial poses."""
    k1, k2, k3 = jax.random.split(key, 3)
    # Ground-truth poses along a circle.
    true = []
    for i in range(N):
        tw = jnp.asarray(
            [np.cos(2 * np.pi * i / N), np.sin(2 * np.pi * i / N), 0.0,
             0.0, 0.0, 2 * np.pi * i / N],
            jnp.float32,
        )
        true.append(se3.se3_exp(tw))
    true = jnp.stack(true)

    ei = list(range(N - 1)) + list(np.random.RandomState(0).randint(0, N - 1, E - (N - 1)))
    ej = [i + 1 for i in range(N - 1)] + [
        (i + 3) % N for i in np.random.RandomState(0).randint(0, N - 1, E - (N - 1))
    ]
    ei = jnp.asarray(ei, jnp.int32)
    ej = jnp.asarray(ej, jnp.int32)
    mask = ei != ej
    Tm = se3.inverse(true[ei]) @ true[ej]

    pert = jax.random.normal(k2, (N, 6)) * drift
    pert = pert.at[0].set(0.0)
    init = true @ se3.se3_exp(pert)
    return PoseGraph(
        poses_wc=init,
        edge_i=ei,
        edge_j=ej,
        edge_T=Tm,
        edge_weight=jnp.ones(ei.shape[0]),
        edge_mask=mask,
    ), true


@pytest.mark.slow
def test_sharded_pose_graph_matches_single_device():
    mesh = make_mesh(dp=4, sp=2, devices=jax.devices()[:8])
    graph, _ = ring_graph(jax.random.key(0), N=12, E=48)

    ref_poses, ref_c0, ref_c1 = optimize_pose_graph(graph, iterations=8)

    step = make_distributed_pose_graph_step(mesh, N=12, iterations=8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    espec = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    sharded = graph._replace(
        edge_i=jax.device_put(graph.edge_i, espec),
        edge_j=jax.device_put(graph.edge_j, espec),
        edge_T=jax.device_put(graph.edge_T, espec),
        edge_weight=jax.device_put(graph.edge_weight, espec),
        edge_mask=jax.device_put(graph.edge_mask, espec),
    )
    poses, c0, c1 = step(sharded)

    np.testing.assert_allclose(np.asarray(c0), np.asarray(ref_c0), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(poses), np.asarray(ref_poses), atol=2e-4)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(ref_c1), rtol=1e-3, atol=1e-7)


@pytest.mark.slow
def test_async_relaxer_reduces_cost_toward_gn():
    mesh = make_mesh(dp=4, sp=2, devices=jax.devices()[:8])
    graph, true = ring_graph(jax.random.key(1), N=16, E=48, drift=0.04)

    relax = make_async_pose_graph_relaxer(mesh, N=16, sweeps=32, exchange=4)
    poses, c0, c1 = relax(graph)

    assert float(c1) < 0.3 * float(c0), (float(c0), float(c1))
    assert bool(jnp.all(jnp.isfinite(poses)))
    # Gauge respected.
    np.testing.assert_allclose(
        np.asarray(poses[0]), np.asarray(graph.poses_wc[0]), atol=1e-5
    )
    # Stale-neighbor sweeps still end near the synchronous optimum.
    gn_poses, _, gn_c1 = optimize_pose_graph(graph, iterations=8)
    assert float(c1) < 10.0 * max(float(gn_c1), 1e-8) + 1e-4
