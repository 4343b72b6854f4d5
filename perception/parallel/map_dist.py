"""Map-block-partitioned dense SLAM odometry (BASELINE.json config #5).

The local fused map — the largest live array in the SLAM system — is
sharded over every device on a 1-D ``mp`` mesh axis; each device owns a
contiguous block of map points/normals. One odometry step then runs as
a single ``shard_map``:

  per GN iteration
    1. every device brute-force NNs the (replicated) source cloud
       against ITS map block (brute-force distance tiles on the shard);
    2. ``lax.pmin`` over ``mp`` finds the global winner distance per
       source point; the owning shard keeps its correspondence, ties
       are weight-split;
    3. each shard builds its local point-to-plane normal-equation
       contribution; ``lax.psum`` reduces the 6x6 system — the same
       collective pattern as the distributed Schur blocks
       (parallel/ba_dist.py);
    4. the tiny solve + SE(3) update run replicated.

This is the whole-system analog of Caffe's per-layer NCCL allreduce
(reference 3rdparty/caffe/src/caffe/parallel.cpp:117-340): the
sequential frame loop stays intact and every frame's heavy work is
data-parallel over the map axis. Used by ``__graft_entry__`` to
dry-run an integrated multi-device SLAM trajectory at headline shapes
and assert equality with the single-device system.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from perception.geometry import f32, se3
from perception.ops import nn as _nn
from perception.ops.icp import _huber_weight


class MapShardedResult(NamedTuple):
    transform: jax.Array   # (4, 4) refined source -> map transform
    fitness: jax.Array     # () mean sq gated correspondence distance
    num_corr: jax.Array    # () int32 gated correspondences


def make_map_sharded_gn(
    mesh,
    iterations: int = 8,
    max_corr_dist: float = 0.25,
    huber_delta: float = 0.02,
    damping: float = 1e-5,
    axis: str = "mp",
):
    """Build the jitted map-sharded point-to-plane GN step.

    Inputs: map arrays sharded over ``axis`` (block-partitioned rows),
    source cloud + init transform replicated. Output replicated.
    """
    max_d2 = max_corr_dist * max_corr_dist

    def _step(map_pts, map_nrm, map_mask, src, src_mask, T0):
        def correspondences(T):
            src_t = se3.transform_points(T, src)
            idx, d2 = _nn.nearest_neighbor(src_t, map_pts, map_mask)
            best = jax.lax.pmin(d2, axis)
            win = d2 <= best
            nwin = jax.lax.psum(win.astype(src.dtype), axis)
            share = win.astype(src.dtype) / jnp.maximum(nwin, 1.0)
            gate = src_mask & (best <= max_d2)
            return src_t, idx, best, gate, share

        def gn_body(T, _):
            src_t, idx, d2, gate, share = correspondences(T)
            q = map_pts[idx]
            nrm = map_nrm[idx]
            r = jnp.sum(nrm * (src_t - q), axis=-1)
            w = (
                gate.astype(src.dtype)
                * share
                * _huber_weight(r, huber_delta)
            )
            J = jnp.concatenate([nrm, jnp.cross(src_t, nrm)], axis=-1)
            Jw = J * w[:, None]
            A = jax.lax.psum(f32.matmul(Jw.T, J), axis)
            b = jax.lax.psum(-(f32.matmul(Jw.T, r)), axis)
            A = A + damping * jnp.eye(6, dtype=src.dtype)
            xi = jnp.linalg.solve(A, b)
            return f32.matmul(se3.se3_exp(xi), T), None

        T, _ = jax.lax.scan(gn_body, T0, None, length=iterations)
        _, _, d2, gate, share = correspondences(T)
        num = jax.lax.psum(jnp.sum(gate * share), axis)
        fit = jax.lax.psum(jnp.sum(jnp.where(gate, d2, 0.0) * share), axis)
        fitness = fit / jnp.maximum(num, 1.0)
        return MapShardedResult(
            transform=T,
            fitness=fitness,
            num_corr=num.astype(jnp.int32),
        )

    sharded = shard_map(
        _step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P(), P()),
        out_specs=P(),
    )
    return jax.jit(sharded)


def map_sharding(mesh, axis: str = "mp"):
    """Sharding for the map arrays (block rows over the map axis)."""
    return NamedSharding(mesh, P(axis))
