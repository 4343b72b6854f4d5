"""Perspective-n-Point pose refinement (motion-only bundle adjustment).

BASELINE.json config #4 names "ORB detect+match + PnP + local BA"; the
reference's closest capability is the Ceres reprojection refinement in
``openpose/src/openpose/3d/poseTriangulation.cpp:228-269`` (AutoDiff
reprojection cost + HuberLoss). Design: a fixed-iteration
Gauss-Newton loop (``lax.scan``) over a 6-dof twist with IRLS Huber
weights — every iteration is one batched residual/Jacobian evaluation
plus a 6x6 solve, fully jittable and vmap-able over problems.

Used by the live SLAM system (models/slam/system.py) to refine
loop-closure relative poses by reprojection: the 3D-3D rigid RANSAC fit
gives the initialization, PnP polishes it against the candidate
keyframe's measured pixel coordinates — reprojection error is the right
metric when per-point depth is the noisiest channel (D435 depth noise
grows quadratically with range; pixel noise doesn't).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from perception.geometry import f32, se3


class PnPResult(NamedTuple):
    transform: jax.Array   # (4, 4) maps model-frame points into camera frame
    mean_px_error: jax.Array  # () robust mean reprojection error (pixels)
    num_used: jax.Array    # () int32 observations with positive depth + mask


def _reproject(T, points, uv, mask, fx, fy, cx, cy):
    """Residuals r (N, 2), camera points pc (N, 3), gate (N,)."""
    pc = se3.transform_points(T, points)
    z = jnp.maximum(pc[:, 2], 1e-6)
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    r = jnp.stack([u, v], axis=-1) - uv
    gate = mask & (pc[:, 2] > 1e-2)
    return jnp.where(gate[:, None], r, 0.0), pc, gate


@functools.partial(jax.jit, static_argnames=("iterations",))
def pnp_gn(
    points: jax.Array,
    uv: jax.Array,
    mask: jax.Array,
    fx,
    fy,
    cx,
    cy,
    T_init: jax.Array | None = None,
    iterations: int = 8,
    huber_px: float = 4.0,
    damping: float = 1e-3,
) -> PnPResult:
    """Refine a camera pose from 3D-2D correspondences.

    Args:
      points: (N, 3) model-frame 3-D points.
      uv: (N, 2) measured pixel coordinates in the target camera.
      mask: (N,) valid correspondences.
      T_init: (4, 4) initial model->camera transform (identity if None).

    Returns the refined transform plus the robust mean pixel error over
    the gated correspondences (diagnostic / acceptance signal).
    """
    points = jnp.asarray(points, jnp.float32)
    uv = jnp.asarray(uv, jnp.float32)
    fx = jnp.asarray(fx, jnp.float32)
    fy = jnp.asarray(fy, jnp.float32)
    cx = jnp.asarray(cx, jnp.float32)
    cy = jnp.asarray(cy, jnp.float32)
    T0 = jnp.eye(4, dtype=jnp.float32) if T_init is None else jnp.asarray(T_init, jnp.float32)

    def body(T, _):
        r, pc, gate = _reproject(T, points, uv, mask, fx, fy, cx, cy)
        z = jnp.maximum(pc[:, 2], 1e-6)
        zero = jnp.zeros_like(z)
        # d(u,v)/d(pc): the pinhole projection Jacobian.
        Jproj = jnp.stack(
            [
                jnp.stack([fx / z, zero, -fx * pc[:, 0] / (z * z)], axis=-1),
                jnp.stack([zero, fy / z, -fy * pc[:, 1] / (z * z)], axis=-1),
            ],
            axis=-2,
        )  # (N, 2, 3)
        # Left-multiplicative update T <- exp(xi) T: d pc/d xi = [I | -hat(pc)].
        I3 = jnp.broadcast_to(jnp.eye(3), (points.shape[0], 3, 3))
        dpc = jnp.concatenate([I3, -se3.hat(pc)], axis=-1)  # (N, 3, 6)
        J = f32.einsum("nab,nbc->nac", Jproj, dpc)  # (N, 2, 6)

        rn = jnp.linalg.norm(r, axis=-1)
        w = jnp.where(rn <= huber_px, 1.0, huber_px / jnp.maximum(rn, 1e-9))
        w = w * gate
        Jw = J * w[:, None, None]
        A = f32.einsum("nai,naj->ij", Jw, J) + damping * jnp.eye(6)
        b = -f32.einsum("nai,na->i", Jw, r)
        xi = jnp.linalg.solve(A, b)
        return f32.matmul(se3.se3_exp(xi), T), None

    T, _ = jax.lax.scan(body, T0, None, length=iterations)
    T = se3.orthonormalize_T(T)

    r, _, gate = _reproject(T, points, uv, mask, fx, fy, cx, cy)
    rn = jnp.linalg.norm(r, axis=-1)
    n = jnp.sum(gate, dtype=jnp.int32)
    err = jnp.sum(jnp.where(gate, jnp.minimum(rn, 4.0 * huber_px), 0.0)) / jnp.maximum(
        n.astype(jnp.float32), 1.0
    )
    return PnPResult(transform=T, mean_px_error=err, num_used=n)


@functools.partial(jax.jit, static_argnames=("num_hypotheses", "iterations"))
def pnp_ransac(
    points: jax.Array,
    uv: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    fx,
    fy,
    cx,
    cy,
    threshold_px: float = 4.0,
    num_hypotheses: int = 64,
    min_inliers: int = 8,
    iterations: int = 6,
) -> Tuple[PnPResult, jax.Array, jax.Array]:
    """Robust PnP: batched 4-point GN hypotheses scored by reprojection.

    Every hypothesis runs a short GN from identity on its own minimal
    set (vmap — the batched replacement for sequential P3P+RANSAC), scores
    are inlier counts over all correspondences, and the winner is
    polished on its inliers. Returns (result, inliers (N,), valid ()).
    """
    fxj = jnp.asarray(fx, jnp.float32)
    fyj = jnp.asarray(fy, jnp.float32)
    cxj = jnp.asarray(cx, jnp.float32)
    cyj = jnp.asarray(cy, jnp.float32)

    logits = jnp.where(mask, 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits, shape=(num_hypotheses, 4))

    def solve_min(sel):
        return pnp_gn(
            points[sel], uv[sel], jnp.ones(4, bool), fxj, fyj, cxj, cyj,
            iterations=iterations,
        ).transform

    Ts = jax.vmap(solve_min)(idx)  # (K, 4, 4)

    pc = f32.einsum("kij,nj->kni", Ts[:, :3, :3], points) + Ts[:, None, :3, 3]
    z = jnp.maximum(pc[..., 2], 1e-6)
    u = fxj * pc[..., 0] / z + cxj
    v = fyj * pc[..., 1] / z + cyj
    err = jnp.sqrt((u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2)
    inl = (err <= threshold_px) & mask[None, :] & (pc[..., 2] > 1e-2)
    scores = jnp.sum(inl, axis=1, dtype=jnp.int32)
    best = jnp.argmax(scores)

    res = pnp_gn(
        points, uv, inl[best], fxj, fyj, cxj, cyj,
        T_init=Ts[best], iterations=iterations,
    )
    r, _, gate = _reproject(res.transform, points, uv, mask, fxj, fyj, cxj, cyj)
    inliers = (jnp.linalg.norm(r, axis=-1) <= threshold_px) & gate
    num = jnp.sum(inliers, dtype=jnp.int32)
    return res, inliers, num >= min_inliers
