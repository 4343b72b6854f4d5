"""Multi-view triangulation: batched DLT + Gauss-Newton refinement.

Equivalent of the reference's ``PoseTriangulation``
(``openpose/src/openpose/3d/poseTriangulation.cpp``): DLT via SVD
(``:119-155``) followed by nonlinear reprojection refinement — the
reference uses Ceres AutoDiff + HuberLoss(2.0) with
DENSE_NORMAL_CHOLESKY (``:228-269``); here the same Huber-weighted
least squares runs as a fixed-iteration batched GN (3x3 normal
equations per point), vmapped over all points at once instead of
point-at-a-time Ceres solves.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from perception.geometry import f32


class TriangulationResult(NamedTuple):
    points: jax.Array        # (N, 3) world points
    reproj_error: jax.Array  # (N,) mean reprojection error (px)
    valid: jax.Array         # (N,)


def triangulate_dlt(
    P_matrices: jax.Array,  # (C, 3, 4) projection matrices
    uv: jax.Array,          # (N, C, 2) pixel observations
    mask: jax.Array,        # (N, C) which cameras see each point
) -> jax.Array:
    """Linear DLT: smallest singular vector of the stacked constraint
    matrix A (2C x 4) per point (poseTriangulation.cpp:119-155)."""
    # Rows: u * P[2] - P[0], v * P[2] - P[1], weighted by mask.
    r0 = uv[..., 0:1] * P_matrices[None, :, 2, :] - P_matrices[None, :, 0, :]  # (N, C, 4)
    r1 = uv[..., 1:2] * P_matrices[None, :, 2, :] - P_matrices[None, :, 1, :]
    A = jnp.concatenate([r0, r1], axis=1)  # (N, 2C, 4)
    w = jnp.concatenate([mask, mask], axis=1).astype(A.dtype)[..., None]
    A = A * w
    # Smallest right singular vector via eigh of A^T A (4x4, batched).
    AtA = f32.einsum("nca,ncb->nab", A, A)
    _, V = jnp.linalg.eigh(AtA)
    X = V[..., 0]
    return X[..., :3] / jnp.where(jnp.abs(X[..., 3:]) > 1e-12, X[..., 3:], 1e-12)


@functools.partial(jax.jit, static_argnames=("iterations",))
def triangulate(
    P_matrices: jax.Array,
    uv: jax.Array,
    mask: jax.Array,
    iterations: int = 5,
    huber_px: float = 2.0,
    max_reproj_error: float = 25.0,
) -> TriangulationResult:
    """DLT init + Huber GN refinement, batched over points."""
    X0 = triangulate_dlt(P_matrices, uv, mask)
    wvis = mask.astype(jnp.float32)

    def reproject(X):
        hom = jnp.concatenate([X, jnp.ones_like(X[..., :1])], axis=-1)  # (N, 4)
        proj = f32.einsum("cij,nj->nci", P_matrices, hom)  # (N, C, 3)
        z = proj[..., 2]
        return proj[..., :2] / jnp.maximum(jnp.abs(z[..., None]), 1e-9) * jnp.sign(
            jnp.where(z[..., None] == 0, 1.0, z[..., None])
        ), z

    def gn(X, _):
        pred, z = reproject(X)
        r = (pred - uv) * wvis[..., None]  # (N, C, 2)
        rn = jnp.linalg.norm(r, axis=-1)
        hw = jnp.where(rn <= huber_px, 1.0, huber_px / jnp.maximum(rn, 1e-9)) * wvis
        # Jacobian d(pred)/dX per camera: chain through the projection.
        # pc = P[:, :3] X + P[:, 3]; u = pc0/pc2 -> du/dX = (P0 - u P2)/pc2.
        P3 = P_matrices[:, :, :3]  # (C, 3, 3)
        zsafe = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
        Ju = (P3[None, :, 0, :] - pred[..., 0:1] * P3[None, :, 2, :]) / zsafe[..., None]
        Jv = (P3[None, :, 1, :] - pred[..., 1:2] * P3[None, :, 2, :]) / zsafe[..., None]
        J = jnp.stack([Ju, Jv], axis=2)  # (N, C, 2, 3)
        Jw = J * hw[..., None, None]
        H = f32.einsum("ncai,ncaj->nij", Jw, J) + 1e-6 * jnp.eye(3)[None]
        g = -f32.einsum("ncai,nca->ni", Jw, r)
        dX = jnp.linalg.solve(H, g[..., None])[..., 0]
        return X + dX, None

    X, _ = jax.lax.scan(gn, X0, None, length=iterations)

    pred, z = reproject(X)
    err = jnp.linalg.norm((pred - uv), axis=-1) * wvis
    nviews = jnp.maximum(jnp.sum(wvis, axis=1), 1.0)
    mean_err = jnp.sum(err, axis=1) / nviews
    valid = (jnp.sum(mask, axis=1) >= 2) & (mean_err < max_reproj_error)
    return TriangulationResult(points=X, reproj_error=mean_err, valid=valid)
