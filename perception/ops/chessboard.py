"""In-house chessboard corner detection + grid ordering.

Capability parity with the reference's own grid-pattern machinery
(``openpose/src/openpose/calibration/gridPatternFunctions.cpp``, 572 LoC:
corner detection, ordering, outer-corner refinement) without delegating
to ``cv2.findChessboardCorners``.

Design:
  * **Saddle response** (device, jnp): a steerable ring filter — sample a
    16-point ring around every pixel (via ``jnp.roll`` shifts, one fused
    elementwise reduction), project onto the cos(2φ)/sin(2φ)
    harmonics (strong at X-corners for *any* board rotation) and subtract
    the cos(φ)/sin(φ) energy (strong at edges). This is the ChESS-style
    detector expressed as 16 shifted adds — no gather, no conv.
  * **NMS + subpixel** (device): 5×5 local-max, quadratic peak refine —
    shares the heatmap NMS idiom of ``ops/heatmap.py``.
  * **Lattice ordering** (host, numpy): greedy BFS over candidate corners
    assigning integer (i, j) lattice coordinates using locally estimated
    step vectors — the perspective-tolerant equivalent of the reference's
    ordering pass. Returns corners row-major, left-to-right, like
    ``detect_chessboard``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def saddle_response(gray: jax.Array, radius: int = 4, samples: int = 16) -> jax.Array:
    """(H, W) image -> (H, W) X-corner (saddle) response, rotation
    invariant. Pure shifts + elementwise math; jit friendly."""
    img = jnp.asarray(gray, jnp.float32)
    img = img / jnp.maximum(jnp.max(jnp.abs(img)), 1e-6)
    phis = 2.0 * np.pi * np.arange(samples) / samples
    a = jnp.zeros_like(img)
    b = jnp.zeros_like(img)
    c = jnp.zeros_like(img)
    d = jnp.zeros_like(img)
    mean = jnp.zeros_like(img)
    for phi in phis:
        dy = int(round(radius * np.sin(phi)))
        dx = int(round(radius * np.cos(phi)))
        s = jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))
        a = a + s * np.cos(2 * phi)
        b = b + s * np.sin(2 * phi)
        c = c + s * np.cos(phi)
        d = d + s * np.sin(phi)
        mean = mean + s
    saddle = a * a + b * b
    edge = c * c + d * d
    resp = saddle - edge
    return jnp.maximum(resp, 0.0)


def find_corner_candidates(
    gray: jax.Array,
    max_corners: int,
    radius: int = 4,
    nms_window: int = 5,
    rel_threshold: float = 0.2,
) -> Tuple[jax.Array, jax.Array]:
    """Detect up to ``max_corners`` saddle points. Returns
    ((max_corners, 2) float (u, v) subpixel coords, (max_corners,) bool
    mask), fixed capacity — jittable."""
    resp = saddle_response(gray, radius=radius)
    h, w = resp.shape
    # Local max over the NMS window with lexicographic tie-break (same
    # idiom as ops/heatmap.nms_heatmap): strictly beat raster-earlier
    # neighbors, >= raster-later ones, so a flat plateau yields exactly
    # one peak.
    pad = nms_window // 2
    padded = jnp.pad(resp, pad, constant_values=-jnp.inf)
    is_peak = jnp.ones_like(resp, bool)
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            if dy == 0 and dx == 0:
                continue
            nb = jax.lax.dynamic_slice(padded, (pad + dy, pad + dx), (h, w))
            if (dy, dx) < (0, 0):
                is_peak &= resp > nb
            else:
                is_peak &= resp >= nb
    # Kill the border band where the ring wraps around.
    bb = radius + 1
    vv, uu = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    interior = (vv >= bb) & (vv < h - bb) & (uu >= bb) & (uu < w - bb)
    is_peak &= (resp > rel_threshold * jnp.max(resp)) & interior
    score = jnp.where(is_peak, resp, -jnp.inf).reshape(-1)
    top = jax.lax.top_k(score, max_corners)
    idx = top[1]
    vals = top[0]
    pv = idx // w
    pu = idx % w

    # Gradient-orthogonality subpixel refinement (the cornerSubPix
    # normal-equation solve): at a saddle, every window gradient g(q) is
    # orthogonal to (q - p), so p = (Σ g gᵀ)⁻¹ Σ g gᵀ q. Exact even when
    # the integer peak sits a pixel or two off on a response plateau.
    img = jnp.asarray(gray, jnp.float32)
    gx = jnp.zeros_like(img).at[:, 1:-1].set(0.5 * (img[:, 2:] - img[:, :-2]))
    gy = jnp.zeros_like(img).at[1:-1, :].set(0.5 * (img[2:, :] - img[:-2, :]))
    r = radius + 2
    win = 2 * r + 1
    offs = jnp.arange(-r, r + 1, dtype=jnp.float32)
    wy, wx = jnp.meshgrid(offs, offs, indexing="ij")
    gauss = jnp.exp(-(wx**2 + wy**2) / (2.0 * (0.6 * r) ** 2))

    def refine(y0, x0):
        yc = jnp.clip(y0, r, h - 1 - r)
        xc = jnp.clip(x0, r, w - 1 - r)
        gxs = jax.lax.dynamic_slice(gx, (yc - r, xc - r), (win, win))
        gys = jax.lax.dynamic_slice(gy, (yc - r, xc - r), (win, win))
        a = jnp.sum(gauss * gxs * gxs)
        b = jnp.sum(gauss * gxs * gys)
        c = jnp.sum(gauss * gys * gys)
        bx = jnp.sum(gauss * (gxs * gxs * wx + gxs * gys * wy))
        by = jnp.sum(gauss * (gxs * gys * wx + gys * gys * wy))
        det = a * c - b * b
        ox = jnp.where(det > 1e-12, (c * bx - b * by) / det, 0.0)
        oy = jnp.where(det > 1e-12, (a * by - b * bx) / det, 0.0)
        lim = jnp.asarray(r, jnp.float32)
        ok = (jnp.abs(ox) < lim) & (jnp.abs(oy) < lim)
        return (jnp.where(ok, xc + ox, x0.astype(jnp.float32)),
                jnp.where(ok, yc + oy, y0.astype(jnp.float32)))

    ux, uy = jax.vmap(refine)(pv, pu)
    uv = jnp.stack([ux, uy], axis=-1)
    return uv, jnp.isfinite(vals)


def order_grid(
    candidates: np.ndarray, rows: int, cols: int, tol: float = 0.35
) -> Optional[np.ndarray]:
    """Assign lattice coordinates to candidate corners by greedy BFS with
    locally estimated step vectors; return (rows*cols, 2) corners
    row-major (left-to-right, top-to-bottom in image space) or None.

    Host-side numpy — ordering is sequential by nature (the reference's
    ordering pass is too); it runs once per calibration view on ≤ a few
    hundred points."""
    pts = np.asarray(candidates, np.float64)
    n = len(pts)
    if n < rows * cols:
        return None

    # kNN table.
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    knn = np.argsort(d2, axis=1)[:, :8]

    def try_seed(seed: int) -> Optional[np.ndarray]:
        # Step vectors from the seed's nearest neighbors: u = nearest,
        # v = most perpendicular with similar length.
        u = pts[knn[seed, 0]] - pts[seed]
        ul = np.linalg.norm(u)
        v = None
        for cand in knn[seed, 1:]:
            w = pts[cand] - pts[seed]
            wl = np.linalg.norm(w)
            if wl > 1.6 * ul or wl < 0.6 * ul:
                continue
            cosang = abs(u @ w) / (ul * wl)
            if cosang < 0.35:
                v = w
                break
        if v is None:
            return None

        coords = {seed: (0, 0)}
        claimed = {(0, 0): seed}
        queue = [seed]
        steps = {seed: (u.copy(), v.copy())}
        while queue:
            i = queue.pop()
            ui, vi = steps[i]
            ci = np.array(coords[i])
            for dvec, dij in ((ui, (1, 0)), (-ui, (-1, 0)), (vi, (0, 1)), (-vi, (0, -1))):
                tgt = tuple(ci + dij)
                if tgt in claimed:
                    continue
                pred = pts[i] + dvec
                j = int(np.argmin(((pts - pred) ** 2).sum(-1)))
                if j in coords:
                    continue
                err = np.linalg.norm(pts[j] - pred)
                if err > tol * np.linalg.norm(dvec):
                    continue
                coords[j] = tgt
                claimed[tgt] = j
                # Local step update: the actual delta along this axis.
                delta = pts[j] - pts[i]
                if dij[0] != 0:
                    steps[j] = (delta * dij[0], vi)
                else:
                    steps[j] = (ui, delta * dij[1])
                queue.append(j)

        if len(coords) < rows * cols:
            return None
        ij = np.array([coords[k] for k in coords])
        ids = np.array(list(coords))
        imin, jmin = ij.min(axis=0)
        ij = ij - (imin, jmin)
        ispan, jspan = ij.max(axis=0) + 1
        # Accept either orientation of the board.
        if (ispan, jspan) == (cols, rows):
            pass
        elif (ispan, jspan) == (rows, cols):
            ij = ij[:, ::-1]
            ispan, jspan = jspan, ispan
        else:
            return None
        grid = np.full((jspan, ispan, 2), np.nan)
        for (gi, gj), k in zip(ij, ids):
            grid[gj, gi] = pts[k]
        if np.isnan(grid).any():
            return None
        # Canonical orientation: rows scan top-to-bottom, cols left-to-right.
        row_dir = grid[0, -1] - grid[0, 0]
        col_dir = grid[-1, 0] - grid[0, 0]
        if abs(row_dir[0]) < abs(row_dir[1]):  # rows should advance in u
            grid = grid.transpose(1, 0, 2)
            row_dir = grid[0, -1] - grid[0, 0]
            col_dir = grid[-1, 0] - grid[0, 0]
            if grid.shape[:2] != (rows, cols):
                return None
        if grid.shape[:2] != (rows, cols):
            return None
        if row_dir[0] < 0:
            grid = grid[:, ::-1]
        if col_dir[1] < 0:
            grid = grid[::-1]
        return grid.reshape(-1, 2).astype(np.float32)

    center = np.argmin(((pts - pts.mean(0)) ** 2).sum(-1))
    for seed in [int(center)] + list(np.argsort(d2[center])[: min(6, n)]):
        out = try_seed(int(seed))
        if out is not None:
            return out
    return None


def detect_chessboard_native(
    gray: np.ndarray, rows: int, cols: int, radius: int = 4
) -> Optional[np.ndarray]:
    """Full in-house detection: saddle response + NMS on device, lattice
    ordering on host. Same contract as ``calibration.detect_chessboard``
    (returns (rows*cols, 2) row-major corners or None)."""
    need = rows * cols
    cap = need + max(need // 2, 8)
    uv, mask = jax.jit(
        find_corner_candidates, static_argnums=(1, 2)
    )(jnp.asarray(gray, jnp.float32), cap, radius)
    cand = np.asarray(uv)[np.asarray(mask)]
    if len(cand) < need:
        return None
    return order_grid(cand, rows, cols)
