"""Distributed bundle adjustment: observation-sharded Schur reduction.

The north-star distributed design (BASELINE.json): "distributed BA via
Schur-complement reduction over psum/all-gather collectives". The
observation set — the O(10^4-10^6) axis — is sharded across every mesh
device; poses and landmarks (small) stay replicated:

  1. each shard computes its partial normal-equation blocks
     (Hpp, Hll, U, bp, bl) from its observation slice —
     ``models/slam/backend.ba_blocks`` unchanged;
  2. one ``lax.psum`` over the whole mesh assembles the global blocks
     (the structural twin of Caffe's per-layer ncclAllReduce,
     ``parallel.cpp:227``, but over Gauss-Newton blocks instead of
     gradients);
  3. landmark elimination + the reduced (6M, 6M) solve run replicated
     (tiny), so every device steps identically — no broadcast needed.

Per-iteration collective volume: M*36 + L*9 + L*M*18 + M*6 + L*3
floats (a few hundred KB for typical local windows) — link noise.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from perception.geometry import f32, se3
from perception.models.slam.backend import (
    BAProblem,
    BAResult,
    ba_blocks,
    ba_schur_solve,
    scale_gauge,
)


def make_distributed_ba_step(
    mesh: Mesh,
    M: int,
    L: int,
    iterations: int = 10,
    damping: float = 1e-3,
    huber_px: float = 3.0,
):
    """Build a jitted distributed BA solver for a fixed (M, L) problem
    size on ``mesh``. Observation arrays must be sharded over all mesh
    axes on axis 0 (padding observations carry obs_mask=False)."""
    axes = tuple(mesh.axis_names)

    def step(poses_wc, landmarks, obs_pose, obs_lm, obs_uv, obs_mask, fx, fy, cx, cy):
        def per_shard(poses_wc, landmarks, obs_pose, obs_lm, obs_uv, obs_mask, fx, fy, cx, cy):
            T_cw0 = se3.inverse(poses_wc)

            def cost(T_cw, lms):
                R = T_cw[obs_pose, :3, :3]
                t = T_cw[obs_pose, :3, 3]
                pc = f32.einsum("oij,oj->oi", R, lms[obs_lm]) + t
                z = jnp.maximum(pc[:, 2], 1e-6)
                u = fx * pc[:, 0] / z + cx
                v = fy * pc[:, 1] / z + cy
                r = jnp.stack([u, v], -1) - obs_uv
                r = jnp.where(obs_mask[:, None], r, 0.0)
                num = jax.lax.psum(jnp.sum(r * r), axes)
                den = jax.lax.psum(jnp.sum(obs_mask), axes)
                return num / jnp.maximum(den, 1)

            def iteration(carry, _):
                T_cw, lms, lam = carry
                blocks = ba_blocks(
                    T_cw, lms, obs_pose, obs_lm, obs_uv, obs_mask,
                    fx, fy, cx, cy, M, L, huber_px,
                )
                # The distributed Schur reduction: one psum of the
                # partial blocks across the whole mesh.
                Hpp, Hll, U, bp, bl = jax.lax.psum(blocks, axes)
                dxi, dX, _ = ba_schur_solve(
                    Hpp, Hll, U, bp, bl, lam, M, L, scale_gauge(T_cw))
                T_new = f32.matmul(se3.se3_exp(dxi), T_cw)
                lms_new = lms + dX
                better = cost(T_new, lms_new) < cost(T_cw, lms)
                return (
                    jnp.where(better, T_new, T_cw),
                    jnp.where(better, lms_new, lms),
                    jnp.where(better, lam * 0.5, lam * 4.0),
                ), None

            c0 = cost(T_cw0, landmarks)
            (T_cw, lms, _), _ = jax.lax.scan(
                iteration, (T_cw0, landmarks, jnp.float32(damping)), None, length=iterations
            )
            return se3.inverse(T_cw), lms, c0, cost(T_cw, lms)

        obs_spec = P(axes)  # axis 0 sharded over the full mesh
        return jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(), P(), obs_spec, obs_spec, obs_spec, obs_spec, P(), P(), P(), P()),
            out_specs=(P(), P(), P(), P()),
        )(poses_wc, landmarks, obs_pose, obs_lm, obs_uv, obs_mask, fx, fy, cx, cy)

    @jax.jit
    def jitted(problem: BAProblem, fx, fy, cx, cy) -> BAResult:
        poses, lms, c0, c1 = step(
            problem.poses_wc, problem.landmarks, problem.obs_pose,
            problem.obs_lm, problem.obs_uv, problem.obs_mask,
            jnp.float32(fx), jnp.float32(fy), jnp.float32(cx), jnp.float32(cy),
        )
        return BAResult(poses_wc=poses, landmarks=lms, initial_cost=c0, final_cost=c1)

    return jitted
