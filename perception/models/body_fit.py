"""Articulated total-body model fitting (joint-angle estimation).

The reference fits the CMU **Adam** body model to triangulated OpenPose
keypoints via the external ``Adam_FastFit`` solver
(``openpose/src/openpose/3d/jointAngleEstimation.cpp:313-360``, with the
OpenPose→Adam joint mapping at ``:114``). Adam itself is a proprietary
asset, so this module rebuilds the *capability* with fixed shapes:

  * a differentiable **kinematic tree** — per-joint axis-angle rotations
    and learnable bone lengths over a BODY_25-shaped skeleton, posed by
    forward kinematics (`lax.scan` over a topologically sorted tree, so
    the whole chain stays inside one jitted graph);
  * a **Levenberg–Marquardt fit** of (global SE(3) twist, joint angles,
    bone scale) to observed 3-D keypoints, with Huber robust weights and
    angle regularization — the Adam_FastFit role, but expressed as pure
    jnp autodiff (`jax.jacfwd` through the FK) instead of hand-coded
    Ceres residual blocks;
  * everything batched: `fit_body` is vmap-able over people, so a crowd
    solves as one matmul-friendly batch.

Conventions: angles are per-joint axis-angle (3,) in the parent frame;
joint j's frame = parent's frame ∘ Rot(angles[j]) then offset by
``bone_dirs[j] * bone_lengths[j] * scale`` in the parent frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry import se3

# --- default skeleton (BODY_25-compatible subset, 15 joints) ---------------
# Topologically ordered: parent index < joint index; joint 0 is the root
# (MidHip in BODY_25 numbering). "OP index" maps each skeleton joint to
# the BODY_25 keypoint it corresponds to (jointAngleEstimation.cpp:114's
# OP→Adam mapping, re-derived for the public BODY_25 naming).

BODY15_NAMES = [
    "MidHip", "Neck", "Nose",           # 0 1 2   spine chain
    "RHip", "RKnee", "RAnkle",          # 3 4 5
    "LHip", "LKnee", "LAnkle",          # 6 7 8
    "RShoulder", "RElbow", "RWrist",    # 9 10 11
    "LShoulder", "LElbow", "LWrist",    # 12 13 14
]

BODY15_PARENTS = np.array([-1, 0, 1, 0, 3, 4, 0, 6, 7, 1, 9, 10, 1, 12, 13], np.int32)

# Rest-pose bone directions (unit, in the parent joint frame) and lengths
# (meters) of an average adult; lengths get a fitted global scale.
BODY15_BONE_DIRS = np.array(
    [
        [0, 0, 0],        # root (unused)
        [0, -1, 0],       # MidHip -> Neck
        [0, -1, 0],       # Neck -> Nose
        [-1, 0, 0],       # MidHip -> RHip
        [0, 1, 0],        # RHip -> RKnee
        [0, 1, 0],        # RKnee -> RAnkle
        [1, 0, 0],        # MidHip -> LHip
        [0, 1, 0],        # LHip -> LKnee
        [0, 1, 0],        # LKnee -> LAnkle
        [-1, 0, 0],       # Neck -> RShoulder
        [0, 1, 0],        # RShoulder -> RElbow
        [0, 1, 0],        # RElbow -> RWrist
        [1, 0, 0],        # Neck -> LShoulder
        [0, 1, 0],        # LShoulder -> LElbow
        [0, 1, 0],        # LElbow -> LWrist
    ],
    np.float32,
)

BODY15_BONE_LENGTHS = np.array(
    [0.0, 0.50, 0.18, 0.11, 0.42, 0.42, 0.11, 0.42, 0.42,
     0.17, 0.30, 0.26, 0.17, 0.30, 0.26],
    np.float32,
)

# BODY_25 keypoint index observed for each skeleton joint.
BODY15_TO_BODY25 = np.array([8, 1, 0, 9, 10, 11, 12, 13, 14, 2, 3, 4, 5, 6, 7], np.int32)


class BodyModel(NamedTuple):
    """Static skeleton description (host constants, closed over by jit)."""

    parents: np.ndarray       # (J,) int32, parents[0] == -1
    bone_dirs: np.ndarray     # (J, 3) unit directions in parent frame
    bone_lengths: np.ndarray  # (J,) meters

    @classmethod
    def body15(cls) -> "BodyModel":
        return cls(BODY15_PARENTS, BODY15_BONE_DIRS, BODY15_BONE_LENGTHS)


class BodyFitResult(NamedTuple):
    root_T: jax.Array        # (4, 4) world-from-root
    angles: jax.Array        # (J, 3) axis-angle per joint
    scale: jax.Array         # () global bone-length scale
    joints: jax.Array        # (J, 3) posed joint positions (world)
    residual: jax.Array      # () final mean robust residual (m)


def forward_kinematics(
    model: BodyModel,
    root_T: jax.Array,       # (4, 4)
    angles: jax.Array,       # (J, 3)
    scale: jax.Array = 1.0,  # ()
) -> jax.Array:
    """Pose the skeleton: world positions (J, 3) of every joint.

    The tree is topologically sorted, so a `lax.scan` over joints with a
    gather of the already-computed parent pose keeps FK inside one
    compiled loop (J is small; this is latency-code feeding the GN fit,
    not a throughput kernel)."""
    J = model.parents.shape[0]
    parents = jnp.asarray(model.parents)
    dirs = jnp.asarray(model.bone_dirs)
    lens = jnp.asarray(model.bone_lengths) * scale

    Rs = jax.vmap(se3.so3_exp)(angles)  # (J, 3, 3) local joint rotations

    R0 = root_T[:3, :3] @ Rs[0]
    t0 = root_T[:3, 3]

    def step(carry, j):
        R_acc, t_acc = carry  # (J, 3, 3), (J, 3) filled up to j-1
        p = parents[j]
        Rp = R_acc[p]
        tp = t_acc[p]
        tj = tp + Rp @ (dirs[j] * lens[j])
        Rj = Rp @ Rs[j]
        R_acc = R_acc.at[j].set(Rj)
        t_acc = t_acc.at[j].set(tj)
        return (R_acc, t_acc), None

    R_acc = jnp.zeros((J, 3, 3), root_T.dtype).at[0].set(R0)
    t_acc = jnp.zeros((J, 3), root_T.dtype).at[0].set(t0)
    (R_acc, t_acc), _ = jax.lax.scan(step, (R_acc, t_acc), jnp.arange(1, J))
    return t_acc


def _pack(twist, angles, log_scale):
    return jnp.concatenate([twist, angles.reshape(-1), log_scale[None]])


def _unpack(theta, J):
    return theta[:6], theta[6 : 6 + 3 * J].reshape(J, 3), theta[6 + 3 * J]


def fit_body(
    observed: jax.Array,             # (J, 3) world keypoint positions
    obs_mask: jax.Array,             # (J,) bool
    model: Optional[BodyModel] = None,
    iterations: int = 30,
    huber_delta: float = 0.10,
    angle_weight: float = 1e-3,
    damping: float = 1e-3,
    fit_scale: bool = True,
) -> BodyFitResult:
    """LM fit of root pose + joint angles (+ log bone scale) to observed
    3-D joints — the Adam_FastFit capability
    (jointAngleEstimation.cpp:313-360) as one jittable solve.

    ``observed`` rows are ordered like the model's joints; map BODY_25
    keypoints through :data:`BODY15_TO_BODY25` first (see
    :func:`fit_body_from_body25`). Missing joints are masked."""
    model = model or BodyModel.body15()
    J = model.parents.shape[0]
    dtype = observed.dtype

    # Initialization: root at the observed root joint, identity pose.
    root0 = jnp.where(obs_mask[0], observed[0], jnp.zeros(3, dtype))
    theta0 = _pack(
        jnp.concatenate([root0, jnp.zeros(3, dtype)]),
        jnp.zeros((J, 3), dtype),
        jnp.zeros((), dtype),
    )

    w_mask = obs_mask.astype(dtype)

    def residuals(theta):
        twist, angles, log_s = _unpack(theta, J)
        scale = jnp.exp(log_s) if fit_scale else jnp.asarray(1.0, dtype)
        T = se3.se3_exp(twist)
        joints = forward_kinematics(model, T, angles, scale)
        r = (joints - observed) * w_mask[:, None]
        # Huber weights on the 3-D error norm.
        n = jnp.linalg.norm(r, axis=-1)
        w = jnp.where(n > huber_delta, jnp.sqrt(huber_delta / jnp.maximum(n, 1e-9)), 1.0)
        r = (r * w[:, None]).reshape(-1)
        # Angle prior keeps unobserved chains at rest.
        return jnp.concatenate([r, angle_weight * angles.reshape(-1)])

    def lm_step(carry, _):
        theta, lam = carry
        r = residuals(theta)
        Jac = jax.jacfwd(residuals)(theta)
        H = Jac.T @ Jac
        g = Jac.T @ r
        H = H + lam * jnp.diag(jnp.diag(H) + 1e-8)
        delta = jnp.linalg.solve(H, -g)
        theta_new = theta + delta
        better = jnp.sum(residuals(theta_new) ** 2) < jnp.sum(r**2)
        theta = jnp.where(better, theta_new, theta)
        lam = jnp.where(better, jnp.maximum(lam * 0.5, 1e-6), jnp.minimum(lam * 4.0, 1e3))
        return (theta, lam), None

    (theta, _), _ = jax.lax.scan(lm_step, (theta0, jnp.asarray(damping, dtype)), None,
                                 length=iterations)

    twist, angles, log_s = _unpack(theta, J)
    scale = jnp.exp(log_s) if fit_scale else jnp.asarray(1.0, dtype)
    T = se3.se3_exp(twist)
    joints = forward_kinematics(model, T, angles, scale)
    err = jnp.linalg.norm((joints - observed), axis=-1)
    denom = jnp.maximum(jnp.sum(w_mask), 1.0)
    return BodyFitResult(T, angles, scale, joints, jnp.sum(err * w_mask) / denom)


def fit_body_from_body25(
    keypoints3d: jax.Array,   # (25, 3) triangulated BODY_25 keypoints
    confidence: jax.Array,    # (25,)
    conf_threshold: float = 0.05,
    **kwargs,
) -> BodyFitResult:
    """Convenience wrapper: gather the BODY_25 keypoints the skeleton
    observes (the OP→model joint mapping, jointAngleEstimation.cpp:114)
    and fit. vmap over the leading axis for multi-person batches."""
    sel = jnp.asarray(BODY15_TO_BODY25)
    obs = keypoints3d[sel]
    mask = confidence[sel] > conf_threshold
    return fit_body(obs, mask, **kwargs)
