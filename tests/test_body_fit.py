"""Body-model fitting: FK correctness + LM recovery of a synthetic pose."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.geometry import se3
from perception.models.body_fit import (
    BODY15_TO_BODY25,
    BodyModel,
    fit_body,
    fit_body_from_body25,
    forward_kinematics,
)


class TestForwardKinematics:
    def test_rest_pose_geometry(self):
        model = BodyModel.body15()
        joints = np.asarray(
            forward_kinematics(model, jnp.eye(4), jnp.zeros((15, 3)), 1.0)
        )
        # Root at origin; neck straight up (-y) by the hip-neck length.
        assert np.allclose(joints[0], 0)
        assert np.allclose(joints[1], [0, -0.50, 0], atol=1e-6)
        # Legs: knees below hips by the thigh length.
        assert joints[4][1] == pytest.approx(joints[3][1] + 0.42)
        # Left/right symmetry about x=0.
        assert joints[3][0] == pytest.approx(-joints[6][0])
        assert joints[9][0] == pytest.approx(-joints[12][0])

    def test_root_transform_moves_everything(self):
        model = BodyModel.body15()
        T = se3.se3_exp(jnp.asarray([0.3, -0.1, 0.9, 0.2, -0.1, 0.4]))
        j0 = forward_kinematics(model, jnp.eye(4), jnp.zeros((15, 3)), 1.0)
        j1 = forward_kinematics(model, T, jnp.zeros((15, 3)), 1.0)
        assert np.allclose(np.asarray(j1), np.asarray(se3.transform_points(T, j0)), atol=1e-5)

    def test_elbow_bend_is_local(self):
        model = BodyModel.body15()
        angles = jnp.zeros((15, 3)).at[10].set(jnp.asarray([jnp.pi / 2, 0, 0]))  # RElbow
        j = np.asarray(forward_kinematics(model, jnp.eye(4), angles, 1.0))
        j_rest = np.asarray(forward_kinematics(model, jnp.eye(4), jnp.zeros((15, 3)), 1.0))
        # Everything except the wrist downstream of RElbow unchanged.
        moved = np.linalg.norm(j - j_rest, axis=-1) > 1e-6
        assert moved.sum() == 1 and moved[11]
        # Wrist still forearm-length from elbow.
        assert np.linalg.norm(j[11] - j[10]) == pytest.approx(0.26, abs=1e-5)

    def test_scale(self):
        model = BodyModel.body15()
        j1 = np.asarray(forward_kinematics(model, jnp.eye(4), jnp.zeros((15, 3)), 1.0))
        j2 = np.asarray(forward_kinematics(model, jnp.eye(4), jnp.zeros((15, 3)), 1.2))
        assert np.allclose(j2, 1.2 * j1, atol=1e-6)


class TestFitBody:
    def _synthetic(self, seed=0, scale=1.05):
        model = BodyModel.body15()
        rng = np.random.default_rng(seed)
        angles = np.zeros((15, 3), np.float32)
        # Bend elbows/knees plausibly.
        for j in (4, 7, 10, 13):
            angles[j] = rng.uniform(-0.5, 0.5, 3)
        twist = np.array([0.2, -0.3, 1.1, 0.1, 0.3, -0.2], np.float32)
        T = se3.se3_exp(jnp.asarray(twist))
        joints = forward_kinematics(model, T, jnp.asarray(angles), scale)
        return T, angles, scale, joints

    def test_recovers_pose(self):
        T, angles, scale, joints = self._synthetic()
        res = jax.jit(lambda o, m: fit_body(o, m, iterations=40))(
            joints, jnp.ones(15, bool)
        )
        assert float(res.residual) < 0.01
        assert np.allclose(np.asarray(res.joints), np.asarray(joints), atol=0.02)
        assert float(res.scale) == pytest.approx(scale, abs=0.05)

    def test_handles_missing_joints(self):
        T, angles, scale, joints = self._synthetic(seed=3)
        mask = jnp.ones(15, bool).at[5].set(False).at[14].set(False)
        res = fit_body(joints, mask, iterations=40)
        vis = np.asarray(mask)
        err = np.linalg.norm(np.asarray(res.joints) - np.asarray(joints), axis=-1)
        assert err[vis].max() < 0.03

    def test_body25_wrapper_and_vmap(self):
        T, angles, scale, joints = self._synthetic(seed=5)
        kp25 = jnp.zeros((25, 3)).at[jnp.asarray(BODY15_TO_BODY25)].set(joints)
        conf = jnp.zeros(25).at[jnp.asarray(BODY15_TO_BODY25)].set(0.9)
        batch_fit = jax.vmap(lambda k, c: fit_body_from_body25(k, c, iterations=30))
        res = batch_fit(jnp.stack([kp25, kp25]), jnp.stack([conf, conf]))
        assert res.joints.shape == (2, 15, 3)
        assert float(res.residual[0]) < 0.02


def test_render_body_model_draws_capsules():
    """GuiAdam-equivalent render: the posed kinematic tree rasterizes
    to a non-trivial image with limbs covering many pixels."""
    import numpy as np

    from perception.models.body_fit import BodyModel, forward_kinematics
    from perception.models.viz import render_body_model

    import jax.numpy as jnp

    model = BodyModel.body15()
    joints = np.asarray(
        forward_kinematics(
            model, jnp.eye(4), jnp.zeros((len(model.parents), 3)), 1.0
        )
    )
    img = render_body_model(joints, model.parents, size=(240, 320))
    assert img.shape == (240, 320, 3)
    lit = (img != 16).any(axis=-1).sum()
    assert lit > 2000, lit  # limbs cover a substantial area
