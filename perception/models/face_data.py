"""Synthetic face scenes + training targets for the face fixture.

The reference wraps trained CLNF/MTCNN models that produce 68 landmarks,
gaze, and action units from raw images
(``openface2_ros/src/openface2_ros.cpp:145-196, 308-441``). A
zero-egress build cannot download those weights, so — exactly as
``models/pose_data.py`` did for the pose CNN (VERDICT r2 item 3: "repeat
it for the face stack") — this module provides the capability proof:

  * a rigid 70-point canonical 3-D face model whose anchor landmarks
    coincide with ``models/face.PNP_MODEL_POINTS`` (so head-pose PnP on
    detected landmarks is consistent by construction);
  * random scene sampling: head pose (yaw/pitch/roll + translation),
    projection through a pinhole camera, and an AU02 (brow raiser)
    deformation channel that lifts the brow landmarks;
  * an analytic grayscale renderer (bright skin disc, dark brows / eye
    rings / pupils / nose / mouth) that the classical
    ``face_detect.detect_faces`` contrast detector fires on;
  * crop-space Gaussian heatmap targets for ``FaceLandmarkNet`` and
    AU-intensity targets for ``ActionUnitHead``.

Everything is jittable with fixed shapes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry import se3
from perception.models.face import AU_NAMES, NUM_FACE_LANDMARKS


def _build_canonical() -> np.ndarray:
    """70 landmarks (m), head frame: x right, y down, z forward.

    Anchors match face.PNP_MODEL_POINTS: 30 nose tip (0,0,0),
    8 chin (0,.066,-.013), 36/45 eye outer corners (∓.045,-.034,-.027),
    48/54 mouth corners (∓.029,.033,-.024).
    """
    L = np.zeros((NUM_FACE_LANDMARKS, 3), np.float32)

    # Jaw 0-16: ellipse arc ear -> chin -> ear.
    t = np.linspace(-np.pi * 0.92, -np.pi * 0.08, 17)  # right ear to left ear
    L[0:17, 0] = 0.072 * np.cos(t + np.pi / 2 * 0)  # placeholder, set below
    jaw_x = 0.072 * np.sin(np.linspace(-np.pi / 2, np.pi / 2, 17))
    jaw_y = 0.066 * np.cos(np.linspace(-np.pi / 2, np.pi / 2, 17) * 0.9) \
        + 0.0  # max at chin center
    # shape: ears high (y ~ -0.01), chin low (y = 0.066)
    s = np.linspace(-1.0, 1.0, 17)
    L[0:17, 0] = 0.075 * s
    L[0:17, 1] = 0.066 - 0.076 * s * s * 0 + (0.066 + 0.01) * (np.abs(s) ** 1.6) * -1 + 0.0
    L[0:17, 1] = 0.066 - 0.076 * (np.abs(s) ** 1.5)
    L[0:17, 2] = -0.013 - 0.047 * s * s
    L[8] = (0.0, 0.066, -0.013)  # chin anchor exactly

    # Brows 17-21 (right, x<0), 22-26 (left).
    bx = np.linspace(-0.055, -0.013, 5)
    L[17:22, 0] = bx
    L[17:22, 1] = -0.048 - 0.004 * np.sin(np.linspace(0, np.pi, 5))
    L[17:22, 2] = -0.022
    L[22:27, 0] = -bx[::-1]
    L[22:27, 1] = L[17:22, 1][::-1]
    L[22:27, 2] = -0.022

    # Nose bridge 27-30 + nostril base 31-35.
    L[27:31, 0] = 0.0
    L[27:31, 1] = np.linspace(-0.033, 0.0, 4)
    L[27:31, 2] = np.linspace(-0.018, 0.0, 4)
    L[30] = (0.0, 0.0, 0.0)  # nose tip anchor
    L[31:36, 0] = np.linspace(-0.018, 0.018, 5)
    L[31:36, 1] = 0.012
    L[31:36, 2] = -0.008

    # Eyes: hexagon rings. Right 36-41 (x<0), left 42-47.
    def eye_ring(cx_, outer_first):
        ex = np.array([-0.0135, -0.0075, 0.0025, 0.0135, 0.0045, -0.0055])
        ey = np.array([0.0, -0.005, -0.0055, 0.0, 0.005, 0.0055])
        ring = np.stack([cx_ + ex, -0.034 + ey, np.full(6, -0.026)], axis=1)
        if not outer_first:
            # mirror horizontally: inner corner first for the left eye
            ring[:, 0] = 2 * cx_ - ring[:, 0]
        return ring

    L[36:42] = eye_ring(-0.0315, True)
    L[36] = (-0.045, -0.034, -0.027)  # right outer anchor
    L[39] = (-0.018, -0.034, -0.026)  # right inner
    L[42:48] = eye_ring(0.0315, False)
    L[42] = (0.018, -0.034, -0.026)   # left inner
    L[45] = (0.045, -0.034, -0.027)   # left outer anchor

    # Mouth: outer ellipse 48-59 (corner-first, counterclockwise over
    # the top), inner 60-67.
    a_out = np.linspace(np.pi, -np.pi, 12, endpoint=False)
    L[48:60, 0] = 0.029 * np.cos(a_out)
    L[48:60, 1] = 0.033 + 0.011 * -np.sin(a_out)
    L[48:60, 2] = -0.024 + 0.002 * np.cos(a_out)
    L[48] = (-0.029, 0.033, -0.024)  # right corner anchor
    L[54] = (0.029, 0.033, -0.024)   # left corner anchor
    a_in = np.linspace(np.pi, -np.pi, 8, endpoint=False)
    L[60:68, 0] = 0.020 * np.cos(a_in)
    L[60:68, 1] = 0.033 + 0.005 * -np.sin(a_in)
    L[60:68, 2] = -0.023

    # Pupils 68 (right), 69 (left).
    L[68] = (-0.0315, -0.034, -0.024)
    L[69] = (0.0315, -0.034, -0.024)
    return L


CANONICAL_FACE_3D = _build_canonical()
BROW_IDS = np.arange(17, 27)

# Polyline segment groups for rendering (consecutive-index chains).
_CHAINS = [
    list(range(0, 17)),            # jaw
    list(range(17, 22)),           # right brow
    list(range(22, 27)),           # left brow
    list(range(27, 31)),           # nose bridge
    list(range(31, 36)),           # nostril base
    list(range(36, 42)) + [36],    # right eye ring (closed)
    list(range(42, 48)) + [42],    # left eye ring (closed)
    list(range(48, 60)) + [48],    # outer mouth (closed)
]


class FaceScene(NamedTuple):
    pose: jax.Array        # (4, 4) camera <- head
    landmarks2d: jax.Array # (70, 2) projected pixels
    landmarks3d: jax.Array # (70, 3) camera-frame points
    au02: jax.Array        # () brow-raise in [0, 1]


def deformed_model(au02) -> jax.Array:
    """Canonical model with the AU02 brow raise applied: brows translate
    up (−y, head frame) by up to 9 mm."""
    base = jnp.asarray(CANONICAL_FACE_3D)
    lift = jnp.zeros((NUM_FACE_LANDMARKS, 3)).at[jnp.asarray(BROW_IDS), 1].set(-0.009)
    return base + au02 * lift


def sample_face(
    key: jax.Array,
    hw: Tuple[int, int],
    fx: float,
    fy: float,
    rot_range: float = 0.30,
    z_range: Tuple[float, float] = (0.45, 0.75),
) -> FaceScene:
    """Random head pose + AU02 state, projected into an (H, W) image."""
    H, W = hw
    cx, cy = W / 2.0, H / 2.0
    k1, k2, k3, k4 = jax.random.split(key, 4)
    rot = jax.random.uniform(k1, (3,), minval=-rot_range, maxval=rot_range)
    z = jax.random.uniform(k2, (), minval=z_range[0], maxval=z_range[1])
    # Keep the face inside the frame: the model spans ~±0.08 m.
    margin = 0.085
    lim_x = (W / 2.0 - 8.0) / fx * z - margin
    lim_y = (H / 2.0 - 8.0) / fy * z - margin
    txy = jax.random.uniform(k3, (2,), minval=-1.0, maxval=1.0) * jnp.array(
        [jnp.maximum(lim_x, 0.0), jnp.maximum(lim_y, 0.0)]
    )
    au02 = jnp.where(
        jax.random.bernoulli(k4, 0.5),
        jax.random.uniform(jax.random.fold_in(k4, 1), (), minval=0.6, maxval=1.0),
        jax.random.uniform(jax.random.fold_in(k4, 2), (), minval=0.0, maxval=0.15),
    )
    # The subject FACES the camera: head +z (out of the face) must point
    # back toward the camera, so the base rotation flips about y; the
    # random rotation is a small wobble on top. Without the flip, gaze
    # rays — which run along the face's forward axis — would point away
    # from the camera for every scene.
    R_face_camera = se3.so3_exp(jnp.asarray([0.0, jnp.pi, 0.0]))
    T = se3.make_T(
        se3.so3_exp(rot) @ R_face_camera, jnp.concatenate([txy, z[None]])
    )
    model = deformed_model(au02)
    pc = se3.transform_points(T, model)
    zc = jnp.maximum(pc[:, 2], 1e-6)
    uv = jnp.stack([fx * pc[:, 0] / zc + cx, fy * pc[:, 1] / zc + cy], axis=-1)
    return FaceScene(pose=T, landmarks2d=uv, landmarks3d=pc, au02=au02)


def _seg_dist(px, a, b):
    ab = b - a
    denom = jnp.maximum(jnp.dot(ab, ab), 1e-8)
    t = jnp.clip(((px - a) * ab).sum(-1) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return jnp.linalg.norm(px - proj, axis=-1)


def _face_layers(lm: jax.Array, px: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """One face's (skin, dark) fields in [0, 1] over the pixel grid —
    shared by the single- and multi-face renderers."""
    # Face scale in pixels (eye-corner distance) drives stroke widths.
    eye_span = jnp.linalg.norm(lm[45] - lm[36])
    stroke = jnp.clip(eye_span * 0.05, 0.8, 4.0)

    # Skin: soft ellipse over the jaw/brow extent.
    face_pts = lm
    c = jnp.mean(face_pts, axis=0)
    spread = jnp.sqrt(jnp.mean(jnp.sum((face_pts - c) ** 2, axis=-1)))
    d_face = jnp.linalg.norm(px - c, axis=-1)
    skin = jnp.clip(1.0 - (d_face - 1.55 * spread) / (0.35 * spread), 0.0, 1.0)

    # Dark feature strokes along the chains.
    dmin = jnp.full(px.shape[:-1], 1e9)
    for chain in _CHAINS:
        for i in range(len(chain) - 1):
            dmin = jnp.minimum(dmin, _seg_dist(px, lm[chain[i]], lm[chain[i + 1]]))
    line = jnp.clip(1.0 - (dmin - stroke) / 1.2, 0.0, 1.0)

    # Eye sockets + pupils: filled dark discs (the detector's strongest
    # cue is dark eye regions against bright cheeks).
    r_eye = jnp.clip(eye_span * 0.085, 1.5, 8.0)
    d_re = jnp.linalg.norm(px - lm[68], axis=-1)
    d_le = jnp.linalg.norm(px - lm[69], axis=-1)
    sockets = jnp.clip(1.0 - (jnp.minimum(d_re, d_le) - r_eye) / 1.5, 0.0, 1.0)

    dark = jnp.maximum(line * 0.85, sockets)
    return skin, dark


def _compose(skin: jax.Array, dark: jax.Array, hw: Tuple[int, int], key):
    img = (40.0 + 160.0 * skin) * (1.0 - 0.8 * dark)  # bg 40, skin to 200
    if key is not None:
        img = img + jax.random.normal(key, hw) * 2.0
    return jnp.clip(img, 0.0, 255.0)


@functools.partial(jax.jit, static_argnames=("hw",))
def render_face(scene: FaceScene, hw: Tuple[int, int], key=None) -> jax.Array:
    """Grayscale (H, W) float in [0, 255]: bright skin, dark features —
    the contrast structure ``detect_faces`` scores (eyes darker than
    cheeks/forehead, dark mouth, bright bridge)."""
    H, W = hw
    yy, xx = jnp.mgrid[0:H, 0:W]
    px = jnp.stack([xx, yy], -1).astype(jnp.float32)
    skin, dark = _face_layers(scene.landmarks2d, px)
    return _compose(skin, dark, hw, key)


@functools.partial(jax.jit, static_argnames=("hw",))
def render_faces(scenes: FaceScene, hw: Tuple[int, int], key=None) -> jax.Array:
    """Multi-face render: ``scenes`` is a stacked FaceScene pytree with
    a leading face axis. Per-pixel max-composite of the face layers —
    exact for spatially disjoint faces (the multi-face e2e scenario,
    openface2_ros.cpp:174-183)."""
    H, W = hw
    yy, xx = jnp.mgrid[0:H, 0:W]
    px = jnp.stack([xx, yy], -1).astype(jnp.float32)
    skins, darks = jax.vmap(lambda lm: _face_layers(lm, px))(scenes.landmarks2d)
    return _compose(jnp.max(skins, axis=0), jnp.max(darks, axis=0), hw, key)


def sample_face_at(
    key: jax.Array,
    hw: Tuple[int, int],
    fx: float,
    fy: float,
    txy: Tuple[float, float],
    z: float,
    rot_range: float = 0.15,
    au02=None,
) -> FaceScene:
    """A face at an EXPLICIT position (meters, camera frame) — the
    controlled placement used to build disjoint multi-face scenes."""
    H, W = hw
    cx, cy = W / 2.0, H / 2.0
    k1, k4 = jax.random.split(key)
    rot = jax.random.uniform(k1, (3,), minval=-rot_range, maxval=rot_range)
    if au02 is None:
        au02 = jnp.where(
            jax.random.bernoulli(k4, 0.5),
            jax.random.uniform(jax.random.fold_in(k4, 1), (), minval=0.6, maxval=1.0),
            jax.random.uniform(jax.random.fold_in(k4, 2), (), minval=0.0, maxval=0.15),
        )
    else:
        au02 = jnp.asarray(au02, jnp.float32)
    R_face_camera = se3.so3_exp(jnp.asarray([0.0, jnp.pi, 0.0]))
    T = se3.make_T(
        se3.so3_exp(rot) @ R_face_camera,
        jnp.asarray([txy[0], txy[1], z], jnp.float32),
    )
    model = deformed_model(au02)
    pc = se3.transform_points(T, model)
    zc = jnp.maximum(pc[:, 2], 1e-6)
    uv = jnp.stack([fx * pc[:, 0] / zc + cx, fy * pc[:, 1] / zc + cy], axis=-1)
    return FaceScene(pose=T, landmarks2d=uv, landmarks3d=pc, au02=au02)


def landmark_heatmap_targets(
    uv_crop: jax.Array, map_hw: Tuple[int, int], stride: int = 4, sigma: float = 1.0
) -> jax.Array:
    """(h, w, 70) Gaussian targets from crop-space landmark pixels."""
    h, w = map_hw
    yy, xx = jnp.mgrid[0:h, 0:w]
    px = jnp.stack([xx, yy], -1).astype(jnp.float32)
    m = uv_crop / stride - 0.5
    d2 = ((px[None] - m[:, None, None, :]) ** 2).sum(-1)  # (70, h, w)
    return jnp.transpose(jnp.exp(-d2 / (2.0 * sigma * sigma)), (1, 2, 0))


def crop_box_from_landmarks(uv: jax.Array, margin: float = 1.35) -> jax.Array:
    """Square crop box around the landmark extent (x1, y1, x2, y2)."""
    lo = jnp.min(uv, axis=0)
    hi = jnp.max(uv, axis=0)
    c = 0.5 * (lo + hi)
    half = 0.5 * jnp.max(hi - lo) * margin
    return jnp.concatenate([c - half, c + half])


def detector_targets(
    box: jax.Array, map_hw: Tuple[int, int], stride: int = 4, sigma: float = 2.0
):
    """Center-heatmap + log-size targets for ``FaceDetectorNet``.

    Returns (heat (h, w), logsize (h, w), weight (h, w)): heat is a
    Gaussian at the box center, logsize = log(box_side / stride)
    regressed only near the center (weight = heat)."""
    h, w = map_hw
    yy, xx = jnp.mgrid[0:h, 0:w]
    px = jnp.stack([xx, yy], -1).astype(jnp.float32)
    c = 0.5 * (box[:2] + box[2:]) / stride - 0.5
    d2 = ((px - c) ** 2).sum(-1)
    heat = jnp.exp(-d2 / (2.0 * sigma * sigma))
    logsize = jnp.log(jnp.maximum((box[2] - box[0]) / stride, 1e-3))
    return heat, jnp.full((h, w), logsize), heat


@functools.partial(
    jax.jit, static_argnames=("batch", "hw", "crop", "rot_range", "pixel_noise")
)
def make_face_batch(
    key: jax.Array,
    batch: int,
    hw: Tuple[int, int] = (128, 128),
    crop: int = 96,
    fx: float = 300.0,
    rot_range: float = 0.30,
    pixel_noise: float = 0.0,
) -> dict:
    """Training batch: full images, GT-box crops, heatmap targets, AU
    targets, and the scenes (for evaluation).

    ``rot_range`` widens the head-rotation distribution and
    ``pixel_noise`` adds per-scene Gaussian noise with a random level
    in [0, pixel_noise] (fraction of 255) — robustness augmentation for
    the held-out FIXTURES.md families (tilted heads broke the AU02
    gate at 0.45 rad on the r4 fixture)."""
    from perception.models.hand import crop_image

    keys = jax.random.split(key, batch)

    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        scene = sample_face(k1, hw, fx, fx, rot_range=rot_range)
        img = render_face(scene, hw, key=k2)
        if pixel_noise > 0.0:
            nk = jax.random.fold_in(k2, 7)
            lvl = jax.random.uniform(nk, ()) * pixel_noise
            img = jnp.clip(
                img + jax.random.normal(jax.random.fold_in(nk, 1), img.shape)
                * lvl * 255.0,
                0.0, 255.0,
            )
        box = crop_box_from_landmarks(scene.landmarks2d)
        det_heat, det_size, det_w = detector_targets(box, (hw[0] // 4, hw[1] // 4))
        # Box augmentation: at inference the crop comes from the face
        # DETECTOR, whose boxes differ from the GT-landmark box in
        # scale and centering — train across that variation.
        half = 0.5 * (box[2] - box[0])
        c = 0.5 * (box[:2] + box[2:])
        js = jax.random.uniform(k3, (3,), minval=-1.0, maxval=1.0)
        half = half * (1.0 + 0.15 * js[0])
        c = c + js[1:] * 0.10 * half
        box = jnp.concatenate([c - half, c + half])
        patch = crop_image(img, box, crop)  # (crop, crop)
        # Landmarks in crop pixels.
        sx = crop / (box[2] - box[0])
        uv_crop = (scene.landmarks2d - box[:2]) * sx
        maps = landmark_heatmap_targets(uv_crop, (crop // 4, crop // 4))
        au = jnp.zeros(len(AU_NAMES)).at[AU_NAMES.index("AU02")].set(
            5.0 * scene.au02
        )
        return img, patch, maps, uv_crop, au, det_heat, det_size, det_w, scene

    (img, patch, maps, uv_crop, au, det_heat, det_size, det_w, scenes) = (
        jax.vmap(one)(keys)
    )
    return {
        "image": img,
        "crop": patch[..., None] / 255.0,
        "heatmaps": maps,
        "uv_crop": uv_crop,
        "au": au,
        "det_heat": det_heat,
        "det_size": det_size,
        "det_weight": det_w,
        "scene": scenes,
    }
