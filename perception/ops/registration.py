"""Correspondence-based rigid registration: RANSAC + Umeyama.

The 3D-3D "PnP" of an RGB-D SLAM stack: given matched keypoint pairs
with depth (from ``ops.features`` matching), estimate the rigid motion
robustly. Batched-hypothesis RANSAC in the same fused style as the
plane module: all K minimal (3-point) hypotheses are solved by one
vmapped Kabsch and scored in one masked reduction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from perception.geometry import f32, se3


class RigidFit(NamedTuple):
    transform: jax.Array    # (4, 4) src -> dst
    inliers: jax.Array      # (N,) bool
    num_inliers: jax.Array  # () int32
    valid: jax.Array        # () bool


def _kabsch(src, dst):
    """Rigid src->dst for (n, 3) pairs (unweighted)."""
    cs, cd = src.mean(axis=0), dst.mean(axis=0)
    H = f32.matmul((src - cs).T, dst - cd)
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(f32.matmul(Vt.T, U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], H.dtype)).at[2, 2].set(det)
    R = f32.matmul(f32.matmul(Vt.T, D), U.T)
    return se3.make_T(R, cd - f32.matmul(R, cs))


@functools.partial(jax.jit, static_argnames=("num_hypotheses",))
def ransac_rigid(
    src: jax.Array,
    dst: jax.Array,
    mask: jax.Array,
    key: jax.Array,
    threshold: float = 0.03,
    num_hypotheses: int = 256,
    min_inliers: int = 6,
) -> RigidFit:
    """Robust rigid fit over matched 3-D pairs (N, 3)+(N, 3)."""
    logits = jnp.where(mask, 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits, shape=(num_hypotheses, 3))
    tri_src = src[idx]  # (K, 3, 3)
    tri_dst = dst[idx]

    Ts = jax.vmap(_kabsch)(tri_src, tri_dst)  # (K, 4, 4)

    # Score: one einsum applies all K transforms to all N points.
    moved = f32.einsum("kij,nj->kni", Ts[:, :3, :3], src) + Ts[:, None, :3, 3]
    d2 = jnp.sum((moved - dst[None]) ** 2, axis=-1)  # (K, N)
    inl = (d2 <= threshold * threshold) & mask[None, :]
    scores = jnp.sum(inl, axis=1, dtype=jnp.int32)

    # Degenerate (collinear/repeated) triplets -> near-singular H; flag
    # by checking the rotation is orthonormal-ish.
    RtR = f32.einsum("kji,kjl->kil", Ts[:, :3, :3], Ts[:, :3, :3])
    ortho = jnp.abs(RtR - jnp.eye(3)[None]).max(axis=(1, 2)) < 1e-3
    scores = jnp.where(ortho, scores, -1)

    best = jnp.argmax(scores)
    T_best = Ts[best]

    # Refit on the best hypothesis' inliers (weighted Umeyama).
    w = inl[best].astype(src.dtype)
    wsum = jnp.maximum(w.sum(), 3.0)
    cs = (src * w[:, None]).sum(0) / wsum
    cd = (dst * w[:, None]).sum(0) / wsum
    H = f32.matmul(((src - cs) * w[:, None]).T, dst - cd)
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(f32.matmul(Vt.T, U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], H.dtype)).at[2, 2].set(det)
    R = f32.matmul(f32.matmul(Vt.T, D), U.T)
    T = se3.make_T(R, cd - f32.matmul(R, cs))

    moved = f32.matmul(src, T[:3, :3].T) + T[:3, 3]
    inliers = (jnp.sum((moved - dst) ** 2, axis=-1) <= threshold * threshold) & mask
    num = jnp.sum(inliers, dtype=jnp.int32)
    return RigidFit(
        transform=T,
        inliers=inliers,
        num_inliers=num,
        valid=(num >= min_inliers) & (scores[best] >= 3),
    )
