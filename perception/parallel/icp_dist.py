"""Distributed point-to-plane ICP / Gauss-Newton over a (dp, sp) mesh.

The multi-chip "training step" of the SLAM engine: a batch of frames is
sharded over ``dp`` (one frame group per device row) and each frame's
points over ``sp``. One GN iteration per frame:

  1. every sp-shard computes correspondences of its point block against
     the (replicated) local map via the brute-force NN;
  2. each shard accumulates its partial 6x6 normal equations A, b;
  3. ``lax.psum`` over ``sp`` assembles the full system (the collective
     analog of Caffe's per-layer ``ncclAllReduce``,
     ``parallel.cpp:227``) — a 42-float collective per frame per
     iteration, negligible on the card-to-card links;
  4. the 6x6 solve + SE(3) update runs replicated per frame;
  5. a final ``psum`` over ``dp`` reduces fleet-level diagnostics
     (mean residual, correspondence counts).

Built with ``shard_map`` so the collectives are explicit and testable
on a virtual CPU mesh (SURVEY.md §4's fake-backend strategy).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from perception.geometry import f32, se3
from perception.ops import nn as _nn
from perception.ops.icp import _huber_weight


class DistICPResult(NamedTuple):
    transforms: jax.Array     # (B, 4, 4) per-frame refined poses
    mean_residual: jax.Array  # () fleet-mean |r| after the step
    num_corr: jax.Array       # () int32 total gated correspondences


def _gn_iteration(T, pts, mask, target, target_normals, target_mask,
                  max_d2, huber_delta, damping):
    """One GN iteration on a point shard; A/b are psum'd over sp."""
    src_t = se3.transform_points(T, pts)
    idx, d2 = _nn.nearest_neighbor(src_t, target, target_mask)
    q = target[idx]
    n = target_normals[idx]
    gate = mask & (d2 <= max_d2)
    r = jnp.sum(n * (src_t - q), axis=-1)
    w = gate.astype(pts.dtype) * _huber_weight(r, huber_delta)
    J = jnp.concatenate([n, jnp.cross(src_t, n)], axis=-1)
    Jw = J * w[:, None]
    A_local = f32.matmul(Jw.T, J)
    b_local = -(f32.matmul(Jw.T, r))
    # The collective: assemble the frame's full normal equations.
    A = jax.lax.psum(A_local, axis_name="sp")
    b = jax.lax.psum(b_local, axis_name="sp")
    A = A + damping * jnp.eye(6, dtype=A.dtype)
    xi = jnp.linalg.solve(A, b)
    T_new = f32.matmul(se3.se3_exp(xi), T)
    res_sum = jax.lax.psum(jnp.sum(jnp.abs(r) * gate), axis_name="sp")
    cnt = jax.lax.psum(jnp.sum(gate, dtype=jnp.int32), axis_name="sp")
    return T_new, res_sum, cnt


def make_distributed_icp_step(
    mesh: Mesh,
    iterations: int = 8,
    max_correspondence_distance: float = 0.5,
    huber_delta: float = 0.02,
    damping: float = 1e-6,
):
    """Build the jitted multi-chip ICP step for a given mesh.

    Expects: frames (B, N, 3) + masks (B, N) sharded P('dp', 'sp');
    init poses (B, 4, 4) sharded P('dp'); target map (M, 3) + normals +
    mask replicated. B must divide the dp size and N the sp size.
    """
    max_d2 = max_correspondence_distance * max_correspondence_distance

    def step(frames, masks, init_T, target, target_normals, target_mask):
        def per_shard(frames_s, masks_s, T_s, tgt, tgt_n, tgt_m):
            # frames_s: (B/dp, N/sp, 3); T_s: (B/dp, 4, 4) — replicated
            # over sp by the in_spec.
            def one_frame(pts, mask, T0):
                def body(carry, _):
                    T, _, _ = carry
                    T_new, res, cnt = _gn_iteration(
                        T, pts, mask, tgt, tgt_n, tgt_m,
                        max_d2, huber_delta, damping,
                    )
                    return (T_new, res, cnt), None

                # Diagnostics come out of the sp-psum varying over dp
                # only; pcast the init carry to the same varying axes.
                zero = jax.lax.pcast(jnp.float32(0), ("dp",), to="varying")
                (T, res, cnt), _ = jax.lax.scan(
                    body, (T0, zero, zero.astype(jnp.int32)), None, length=iterations
                )
                return T, res, cnt

            T_out, res, cnt = jax.vmap(one_frame)(frames_s, masks_s, T_s)
            # Fleet diagnostics over frames and dp.
            res_tot = jax.lax.psum(jnp.sum(res), axis_name="dp")
            cnt_tot = jax.lax.psum(jnp.sum(cnt), axis_name="dp")
            return T_out, res_tot, cnt_tot

        return jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(
                P("dp", "sp"), P("dp", "sp"), P("dp"),
                P(), P(), P(),
            ),
            out_specs=(P("dp"), P(), P()),
        )(frames, masks, init_T, target, target_normals, target_mask)

    @jax.jit
    def jitted(frames, masks, init_T, target, target_normals, target_mask):
        T, res, cnt = step(frames, masks, init_T, target, target_normals, target_mask)
        mean_res = res / jnp.maximum(cnt.astype(res.dtype), 1.0)
        return DistICPResult(transforms=T, mean_residual=mean_res, num_corr=cnt)

    return jitted
