"""Surface-normal estimation for masked clouds and depth images.

Covers the capability of ``pcl::NormalEstimation`` (used implicitly by
the reference's planar models) two ways:

  * ``normals_knn`` — generic clouds: PCA over k nearest neighbors
    (smallest eigenvector of the local scatter), batched over all
    points; the kNN comes from the brute-force search.
  * ``normals_from_depth`` — organized depth images: cross product of
    image-space tangents (central differences), the O(HW) fast path a
    RealSense/TUM frame should always use.

Normals are oriented toward the viewpoint (camera origin by default),
matching PCL's ``flipNormalTowardsViewpoint``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from perception.geometry import f32
from perception.ops import nn as _nn


def _orient(normals: jax.Array, points: jax.Array, viewpoint) -> jax.Array:
    vp = jnp.asarray(viewpoint, points.dtype)
    to_vp = vp - points
    flip = jnp.sum(normals * to_vp, axis=-1, keepdims=True) < 0
    return jnp.where(flip, -normals, normals)


@functools.partial(jax.jit, static_argnames=("k",))
def normals_knn(
    points: jax.Array,
    mask: jax.Array,
    k: int = 16,
    viewpoint=(0.0, 0.0, 0.0),
) -> Tuple[jax.Array, jax.Array]:
    """Per-point unit normals via local PCA: (N, 3) -> (N, 3), (N,) valid.

    A normal is valid when at least 3 true neighbors were found within
    the kNN set (invalid refs are parked at the sentinel and excluded
    by distance).
    """
    idx, d2 = _nn.knn(points, points, mask, k=k)
    neigh = points[idx]  # (N, k, 3)
    w = (d2 < 1.0e6).astype(points.dtype)  # sentinel hits excluded
    count = jnp.sum(w, axis=-1, keepdims=True)
    mean = jnp.sum(neigh * w[..., None], axis=-2, keepdims=True) / jnp.maximum(count[..., None], 1.0)
    centered = (neigh - mean) * w[..., None]
    cov = f32.einsum("nki,nkj->nij", centered, centered)
    evals, evecs = jnp.linalg.eigh(cov)
    normals = evecs[..., 0]  # smallest eigenvector
    normals = normals / jnp.maximum(jnp.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
    normals = _orient(normals, points, viewpoint)
    valid = mask & (count[..., 0] >= 3)
    return normals, valid


def normals_from_depth(
    points_hw3: jax.Array,
    valid_hw: jax.Array,
    viewpoint=(0.0, 0.0, 0.0),
    max_edge: float = 0.05,
) -> Tuple[jax.Array, jax.Array]:
    """Normals for an organized cloud (H, W, 3) via tangent cross product.

    ``max_edge`` rejects tangents spanning a depth discontinuity (in
    meters) so normals don't smear across object boundaries.
    """
    p = points_hw3
    # Central differences with edge replication.
    du = jnp.concatenate([p[:, 1:2] - p[:, 0:1], (p[:, 2:] - p[:, :-2]) * 0.5, p[:, -1:] - p[:, -2:-1]], axis=1)
    dv = jnp.concatenate([p[1:2] - p[0:1], (p[2:] - p[:-2]) * 0.5, p[-1:] - p[-2:-1]], axis=0)
    n = jnp.cross(du, dv)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    n = _orient(n, p, viewpoint)

    # Validity: center + both neighbors valid, tangents short (no jump).
    v = valid_hw
    v_l = jnp.concatenate([v[:, :1], v[:, :-1]], axis=1)
    v_r = jnp.concatenate([v[:, 1:], v[:, -1:]], axis=1)
    v_u = jnp.concatenate([v[:1], v[:-1]], axis=0)
    v_d = jnp.concatenate([v[1:], v[-1:]], axis=0)
    ok_len = (jnp.linalg.norm(du, axis=-1) < max_edge) & (jnp.linalg.norm(dv, axis=-1) < max_edge)
    valid = v & v_l & v_r & v_u & v_d & ok_len & (norm[..., 0] > 1e-12)
    return n, valid
