"""Synthetic multi-person skeleton scenes + CMU-style training targets.

The reference's pose CNN ships as a downloaded .caffemodel
(``netCaffe.cpp:142-169``); a zero-egress build can't fetch weights, so
this module provides the *capability proof* instead: render stick-figure
people with a distinct color per limb class, produce the matching
ground-truth part heatmaps and part-affinity fields (the training
targets of the CMU two-branch architecture), train ``models/pose.PoseNet``
on them, and verify ``extract_people`` recovers the ground-truth
skeletons from raw images (see ``tools/train_pose_fixture.py`` and
``tests/test_pose_e2e.py``).

Everything is jittable with fixed shapes: ``n_people`` is a static
capacity with a per-person validity mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from perception.models.pose import MPI_15_PAIRS, MPI_15_PARTS

# Canonical MPI_15 skeleton in a unit box (x right, y down), roughly
# anatomical: head above neck, chest center, symmetric arms/legs.
_CANONICAL_MPI15 = np.array(
    [
        [0.50, 0.08],  # Head
        [0.50, 0.22],  # Neck
        [0.36, 0.24],  # RShoulder
        [0.30, 0.42],  # RElbow
        [0.27, 0.60],  # RWrist
        [0.64, 0.24],  # LShoulder
        [0.70, 0.42],  # LElbow
        [0.73, 0.60],  # LWrist
        [0.42, 0.55],  # RHip
        [0.40, 0.75],  # RKnee
        [0.39, 0.95],  # RAnkle
        [0.58, 0.55],  # LHip
        [0.60, 0.75],  # LKnee
        [0.61, 0.95],  # LAnkle
        [0.50, 0.38],  # Chest
    ],
    np.float32,
)

# One distinct color per limb class so parts are visually identifiable
# (the synthetic analog of natural-image appearance cues).
_LIMB_COLORS = np.array(
    [
        (0.95, 0.25, 0.25), (0.95, 0.60, 0.20), (0.90, 0.90, 0.25),
        (0.55, 0.90, 0.25), (0.25, 0.90, 0.40), (0.25, 0.90, 0.85),
        (0.25, 0.60, 0.95), (0.30, 0.30, 0.95), (0.60, 0.25, 0.95),
        (0.90, 0.25, 0.90), (0.95, 0.40, 0.60), (0.70, 0.80, 0.95),
        (0.95, 0.80, 0.60), (0.60, 0.95, 0.75),
    ],
    np.float32,
)


class SkeletonScene(NamedTuple):
    joints: jax.Array   # (N, P, 2) xy pixel coords
    valid: jax.Array    # (N,) bool — person slot in use


def sample_skeletons(
    key: jax.Array,
    hw: Tuple[int, int],
    n_people: int = 2,
    min_people: int = 1,
    scale_range: Tuple[float, float] = (0.45, 0.75),
    jitter: float = 0.02,
) -> SkeletonScene:
    """Random placements of the canonical skeleton: per-person scale,
    rotation, translation, and per-joint jitter, kept inside the frame."""
    H, W = hw
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    P = _CANONICAL_MPI15.shape[0]

    scale = jax.random.uniform(
        k1, (n_people, 1, 1), minval=scale_range[0], maxval=scale_range[1]
    ) * min(H, W)
    theta = jax.random.uniform(k2, (n_people,), minval=-0.25, maxval=0.25)
    c, s = jnp.cos(theta), jnp.sin(theta)
    rot = jnp.stack(
        [jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2
    )  # (N, 2, 2)

    base = jnp.asarray(_CANONICAL_MPI15) - 0.5  # centered
    pts = jnp.einsum("nij,pj->npi", rot, base) * scale  # (N, P, 2)

    # Translation keeps the skeleton bounding box inside the frame.
    span = scale[:, 0, 0]  # ~height of the figure
    tx = jax.random.uniform(
        k3, (n_people,), minval=0.55 * span, maxval=W - 0.55 * span
    )
    ty = jax.random.uniform(
        k4, (n_people,), minval=0.55 * span, maxval=H - 0.55 * span
    )
    pts = pts + jnp.stack([tx, ty], -1)[:, None, :]

    pts = pts + jax.random.normal(k5, (n_people, P, 2)) * jitter * scale
    pts = jnp.clip(pts, 2.0, jnp.array([W - 3.0, H - 3.0]))

    n_valid = jax.random.randint(k6, (), min_people, n_people + 1)
    valid = jnp.arange(n_people) < n_valid
    return SkeletonScene(joints=pts.astype(jnp.float32), valid=valid)


def _capsule_dist(px, a, b):
    """Distance from pixel grid px (H, W, 2) to segment a-b (2,)."""
    ab = b - a
    denom = jnp.maximum(jnp.dot(ab, ab), 1e-8)
    t = jnp.clip(((px - a) * ab).sum(-1) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return jnp.linalg.norm(px - proj, axis=-1)


@functools.partial(jax.jit, static_argnames=("hw",))
def render_people(scene: SkeletonScene, hw: Tuple[int, int],
                  limb_width: float = 2.5) -> jax.Array:
    """Stick-figure RGB render: colored capsules per limb, white joint
    dots, mid-gray background. (H, W, 3) float in [0, 1]."""
    H, W = hw
    yy, xx = jnp.mgrid[0:H, 0:W]
    px = jnp.stack([xx, yy], -1).astype(jnp.float32)  # (H, W, 2)
    pairs = jnp.asarray(MPI_15_PAIRS)
    colors = jnp.asarray(_LIMB_COLORS)

    def person(joints, valid):
        def limb(l):
            a = joints[pairs[l, 0]]
            b = joints[pairs[l, 1]]
            d = _capsule_dist(px, a, b)
            alpha = jnp.clip(1.0 - (d - limb_width) / 1.5, 0.0, 1.0)
            return alpha[..., None] * colors[l]  # (H, W, 3)

        limbs = jax.vmap(limb)(jnp.arange(pairs.shape[0]))
        img = limbs.max(0)
        # joint dots
        dj = jnp.linalg.norm(px[None] - joints[:, None, None, :], axis=-1)
        dots = jnp.clip(1.0 - (dj.min(0) - 1.5) / 1.0, 0.0, 1.0)
        img = jnp.maximum(img, dots[..., None])
        return img * valid

    rendered = jax.vmap(person)(scene.joints, scene.valid)  # (N, H, W, 3)
    fg = rendered.max(0)
    bg = jnp.full((H, W, 3), 0.12, jnp.float32)
    return jnp.clip(bg + fg, 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("map_hw", "stride"))
def make_targets(
    scene: SkeletonScene,
    map_hw: Tuple[int, int],
    stride: int = 8,
    sigma: float = 1.2,
    paf_width: float = 0.8,
) -> Tuple[jax.Array, jax.Array]:
    """CMU two-branch training targets at map resolution.

    Returns (paf (h, w, 2L), heatmap (h, w, P+1)): part heatmaps are the
    max-over-people Gaussian, PAFs the averaged unit limb direction
    inside each limb capsule, background = 1 - max(parts).
    """
    h, w = map_hw
    yy, xx = jnp.mgrid[0:h, 0:w]
    px = jnp.stack([xx, yy], -1).astype(jnp.float32)  # (h, w, 2)
    joints_m = scene.joints / stride  # map-space coords
    pairs = jnp.asarray(MPI_15_PAIRS)
    P = joints_m.shape[1]
    L = pairs.shape[0]

    # Heatmaps: (N, P, h, w) gaussians -> max over people.
    d2 = ((px[None, None] - joints_m[:, :, None, None, :]) ** 2).sum(-1)
    g = jnp.exp(-d2 / (2.0 * sigma**2)) * scene.valid[:, None, None, None]
    hm = g.max(0)  # (P, h, w)
    background = jnp.clip(1.0 - hm.max(0), 0.0, 1.0)
    heatmap = jnp.concatenate([hm, background[None]], 0)

    # PAFs: per limb, averaged unit direction within the capsule.
    def person_paf(joints, valid):
        def limb(l):
            a = joints[pairs[l, 0]]
            b = joints[pairs[l, 1]]
            d = _capsule_dist(px, a, b)
            inside = (d < paf_width) & valid
            u = (b - a) / jnp.maximum(jnp.linalg.norm(b - a), 1e-6)
            vec = inside[..., None] * u
            return vec, inside

        return jax.vmap(limb)(jnp.arange(L))  # (L, h, w, 2), (L, h, w)

    vecs, masks = jax.vmap(person_paf)(joints_m, scene.valid)
    cnt = jnp.maximum(masks.sum(0), 1)[..., None]
    paf = vecs.sum(0) / cnt  # (L, h, w, 2)
    paf = jnp.transpose(paf, (1, 2, 0, 3)).reshape(h, w, 2 * L)
    heatmap = jnp.transpose(heatmap, (1, 2, 0))  # (h, w, P+1)
    return paf, heatmap


def make_batch(key: jax.Array, batch: int, hw: Tuple[int, int],
               n_people: int = 2, stride: int = 8,
               pixel_noise: float = 0.0):
    """One jitted training batch: images + targets.

    ``pixel_noise`` > 0 adds per-scene Gaussian noise with a random
    level in [0, pixel_noise] (fraction of full scale) — the robustness
    augmentation for the held-out noise families (FIXTURES.md)."""
    keys = jax.random.split(key, batch)
    scenes = jax.vmap(lambda k: sample_skeletons(k, hw, n_people))(keys)
    images = jax.vmap(lambda s: render_people(s, hw))(scenes)
    if pixel_noise > 0.0:
        # images are unit-scale ([0, 1]); noise level is a fraction of
        # full scale, matching tools/fixtures_robustness.py's families.
        nk = jax.random.fold_in(key, 7)
        lvl = jax.random.uniform(nk, (batch, 1, 1, 1)) * pixel_noise
        images = jnp.clip(
            images + jax.random.normal(jax.random.fold_in(nk, 1), images.shape) * lvl,
            0.0, 1.0,
        )
    map_hw = (hw[0] // stride, hw[1] // stride)
    pafs, hms = jax.vmap(lambda s: make_targets(s, map_hw, stride))(scenes)
    return {"image": images, "paf": pafs, "heatmap": hms, "scene": scenes}
