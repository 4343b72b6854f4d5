"""Distributed pose-graph optimization: edge-sharded GN + async
block-Jacobi relaxation (BASELINE.json config #5: "map-block-partitioned
SLAM with ... pose-graph loop closure over collectives"; north-star
"asynchronous pose-graph relaxation").

Two schemes over a device mesh, both built from
``models/slam/backend.pose_graph_system`` (per-edge residual/Jacobian
blocks — pure sums, so sharding the EDGE axis composes with one psum):

1. ``make_distributed_pose_graph_step`` — exact synchronous GN. Each
   shard assembles its partial (6N, 6N) normal matrix and gradient from
   its edge slice; one ``lax.psum`` over the mesh completes the
   assembly (the structural twin of parallel/ba_dist.py); the dense
   solve runs replicated so every device steps identically. Bitwise
   the same math as ``optimize_pose_graph`` — the dryrun asserts
   sharded == single-device.

2. ``make_async_pose_graph_relaxer`` — asynchronous block-Jacobi: nodes
   are partitioned over devices; each device repeatedly solves ONLY its
   own nodes' 6x6 diagonal blocks against neighbor poses that are
   refreshed by ``jax.lax.ppermute`` ring exchange every ``exchange``
   inner sweeps — between exchanges a device relaxes against STALE
   neighbor estimates, which is exactly the asynchronous-relaxation
   trade (more local progress per byte of collective traffic, geometric-rate
   convergence for the diagonally-dominant graphs SLAM produces).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from perception.geometry import f32, se3
from perception.models.slam.backend import PoseGraph, pose_graph_system


def make_distributed_pose_graph_step(
    mesh: Mesh,
    N: int,
    iterations: int = 10,
    damping: float = 1e-4,
):
    """Edge-sharded GN over ``mesh``. Edge arrays must be sharded on
    axis 0 over all mesh axes (padding edges carry edge_mask=False);
    poses are replicated. Returns a jitted
    ``(graph) -> (poses, c0, c1)``."""
    axes = tuple(mesh.axis_names)

    def step(poses0, ei, ej, Tm, w_in):
        def per_shard(poses0, ei, ej, Tm, w_in):
            Tm_inv = se3.inverse(Tm)
            w = w_in

            def cost(poses):
                Ti = poses[ei]
                Tj = poses[ej]
                r = se3.se3_log(f32.matmul(f32.matmul(Tm_inv, se3.inverse(Ti)), Tj))
                r = r * jnp.sqrt(jnp.maximum(w, 0.0))[:, None]
                num = jax.lax.psum(jnp.sum(r * r), axes)
                den = jax.lax.psum(jnp.sum(w > 0), axes)
                return num / jnp.maximum(den, 1)

            def iteration(poses, _):
                r, Ji, Jj = pose_graph_system(poses, ei, ej, Tm_inv, w)

                Hii = f32.einsum("eai,eaj->eij", Ji, Ji)
                Hij = f32.einsum("eai,eaj->eij", Ji, Jj)
                Hji = Hij.transpose(0, 2, 1)
                Hjj = f32.einsum("eai,eaj->eij", Jj, Jj)
                blocks = jnp.concatenate([Hii, Hij, Hji, Hjj], axis=0)
                keys = jnp.concatenate(
                    [ei * N + ei, ei * N + ej, ej * N + ei, ej * N + ej]
                )
                Hb = jax.ops.segment_sum(blocks, keys, num_segments=N * N)
                gi = -f32.einsum("eai,ea->ei", Ji, r)
                gj = -f32.einsum("eai,ea->ei", Jj, r)
                gb = jax.ops.segment_sum(
                    jnp.concatenate([gi, gj], axis=0),
                    jnp.concatenate([ei, ej]),
                    num_segments=N,
                )
                # The distributed reduction: one psum completes the
                # global normal-equation assembly.
                Hb, gb = jax.lax.psum((Hb, gb), axes)

                H = Hb.reshape(N, N, 6, 6).transpose(0, 2, 1, 3).reshape(6 * N, 6 * N)
                H = H + damping * jnp.eye(6 * N)
                g = gb.reshape(-1)
                H = H.at[:6].set(0.0).at[:, :6].set(0.0)
                H = H.at[jnp.arange(6), jnp.arange(6)].set(1.0)
                g = g.at[:6].set(0.0)
                delta = jnp.linalg.solve(H, g).reshape(N, 6)
                new_poses = f32.matmul(poses, se3.se3_exp(delta))
                better = cost(new_poses) < cost(poses)
                return jnp.where(better, new_poses, poses), None

            c0 = cost(poses0)
            poses, _ = jax.lax.scan(iteration, poses0, None, length=iterations)
            poses = se3.orthonormalize_T(poses)
            return poses, c0, cost(poses)

        espec = P(axes)
        return jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(), espec, espec, espec, espec),
            out_specs=(P(), P(), P()),
        )(poses0, ei, ej, Tm, w_in)

    @jax.jit
    def jitted(graph: PoseGraph) -> Tuple[jax.Array, jax.Array, jax.Array]:
        w = (graph.edge_weight * graph.edge_mask).astype(jnp.float32)
        return step(graph.poses_wc, graph.edge_i, graph.edge_j, graph.edge_T, w)

    return jitted


def make_async_pose_graph_relaxer(
    mesh: Mesh,
    N: int,
    sweeps: int = 24,
    exchange: int = 4,
    damping: float = 1e-3,
):
    """Asynchronous block-Jacobi pose-graph relaxation.

    Nodes are block-partitioned over the mesh's devices (device d owns
    nodes [d*N/D, (d+1)*N/D)); every edge is replicated to both
    endpoint owners' shards by the caller (or just replicated). Each
    inner sweep updates ONLY the owned nodes from their incident edges'
    6x6 diagonal blocks; every ``exchange`` sweeps a ring ``ppermute``
    + psum refreshes the replicated pose table. Between refreshes the
    devices relax against stale neighbors — the async trade.

    Returns jitted ``(graph) -> (poses, c0, c1)``; edge arrays
    REPLICATED, poses replicated.
    """
    devices = mesh.devices.reshape(-1)
    D = devices.shape[0]
    flat = Mesh(devices, ("nodes",))
    own = (N + D - 1) // D  # nodes per device (last shard may pad)

    def relax(poses0, ei, ej, Tm, w):
        def per_shard(poses0, ei, ej, Tm, w):
            d = jax.lax.axis_index("nodes")
            lo = d * own
            owned = (jnp.arange(N) >= lo) & (jnp.arange(N) < lo + own)
            Tm_inv = se3.inverse(Tm)

            def cost(poses):
                Ti = poses[ei]
                Tj = poses[ej]
                r = se3.se3_log(f32.matmul(f32.matmul(Tm_inv, se3.inverse(Ti)), Tj))
                r = r * jnp.sqrt(jnp.maximum(w, 0.0))[:, None]
                return jnp.sum(r * r) / jnp.maximum(jnp.sum(w > 0), 1)

            def sweep(poses, _):
                r, Ji, Jj = pose_graph_system(poses, ei, ej, Tm_inv, w)
                Hii = f32.einsum("eai,eaj->eij", Ji, Ji)
                Hjj = f32.einsum("eai,eaj->eij", Jj, Jj)
                Hd = jax.ops.segment_sum(
                    jnp.concatenate([Hii, Hjj], axis=0),
                    jnp.concatenate([ei, ej]),
                    num_segments=N,
                ) + damping * jnp.eye(6)
                g = jax.ops.segment_sum(
                    jnp.concatenate(
                        [-f32.einsum("eai,ea->ei", Ji, r),
                         -f32.einsum("eai,ea->ei", Jj, r)],
                        axis=0,
                    ),
                    jnp.concatenate([ei, ej]),
                    num_segments=N,
                )
                delta = jnp.linalg.solve(Hd, g[..., None])[..., 0]  # (N, 6)
                # Under-relaxed block-Jacobi step on OWNED nodes only;
                # node 0 stays frozen (gauge).
                upd = owned & (jnp.arange(N) != 0)
                delta = jnp.where(upd[:, None], 0.7 * delta, 0.0)
                return f32.matmul(poses, se3.se3_exp(delta)), None

            def outer(poses, _):
                poses, _ = jax.lax.scan(sweep, poses, None, length=exchange)
                # Refresh: every device contributes its owned block;
                # one psum of masked tables rebuilds the global view
                # (a ring ppermute accumulation would stream the same
                # bytes; psum is the fused form on XLA).
                contrib = jnp.where(owned[:, None, None], poses, 0.0)
                poses = jax.lax.psum(contrib, "nodes")
                # Node 0's owner contributes the frozen gauge pose; on
                # devices where nobody owns a node (N < D*own padding)
                # the psum already handled it. The psum output is
                # replicated (unvarying) — re-mark it varying so the
                # outer scan carry type stays fixed.
                poses = jax.lax.pvary(poses, ("nodes",))
                return se3.orthonormalize_T(poses), None

            c0 = cost(poses0)
            n_outer = max(sweeps // exchange, 1)
            # The owned-mask makes the carry device-varying; mark the
            # replicated initial poses varying so the scan carry type
            # is stable (shard_map vma rule).
            poses0_v = jax.lax.pvary(poses0, ("nodes",))
            poses, _ = jax.lax.scan(outer, poses0_v, None, length=n_outer)
            # One more owned-block psum re-establishes the replicated
            # (unvarying) type for the outputs — values are already
            # identical across devices after the last refresh.
            contrib = jnp.where(owned[:, None, None], poses, 0.0)
            poses = se3.orthonormalize_T(jax.lax.psum(contrib, "nodes"))
            return poses, c0, cost(poses)

        return jax.shard_map(
            per_shard,
            mesh=flat,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=(P(), P(), P()),
        )(poses0, ei, ej, Tm, w)

    @jax.jit
    def jitted(graph: PoseGraph) -> Tuple[jax.Array, jax.Array, jax.Array]:
        w = (graph.edge_weight * graph.edge_mask).astype(jnp.float32)
        return relax(graph.poses_wc, graph.edge_i, graph.edge_j, graph.edge_T, w)

    return jitted
