"""Central-difference gradient checker — the Caffe GradientChecker
pattern (``include/caffe/test/test_gradient_check_util.hpp:19``: every
layer's analytic backward validated against finite differences) applied
to this framework's differentiable surfaces: autodiff grads of the
training loss, FK, and reprojection residuals are checked against
numerical derivatives in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# x64 scoped per-test (the suite default is f32; flipping the global
# flag would change dtype promotion for every other test in-process).
from jax import enable_x64


@pytest.fixture(autouse=True)
def _x64_scope():
    with enable_x64():
        yield


def numerical_grad(f, x, eps=1e-6):
    """Central differences on a flat f64 vector."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    flat = x.ravel()
    gf = g.ravel()
    for i in range(flat.size):
        xp = flat.copy(); xp[i] += eps
        xm = flat.copy(); xm[i] -= eps
        gf[i] = (float(f(xp.reshape(x.shape))) - float(f(xm.reshape(x.shape)))) / (2 * eps)
    return g


def check_grad(f, x, rtol=1e-4, atol=1e-6):
    auto = np.asarray(jax.grad(f)(jnp.asarray(x, jnp.float64)))
    num = numerical_grad(f, x)
    np.testing.assert_allclose(auto, num, rtol=rtol, atol=atol)


class TestGradCheck:
    def test_se3_exp_transform(self):
        from perception.geometry import se3

        pts = jnp.asarray(np.random.default_rng(0).normal(size=(7, 3)))

        def f(xi):
            T = se3.se3_exp(xi)
            return jnp.sum(se3.transform_points(T, pts) ** 2)

        check_grad(f, np.array([0.1, -0.2, 0.3, 0.05, -0.02, 0.4]))

    @pytest.mark.slow
    def test_body_fk(self):
        from perception.models.body_fit import BodyModel, forward_kinematics

        model = BodyModel.body15()
        target = jnp.asarray(np.random.default_rng(1).normal(size=(15, 3)))

        def f(angles):
            j = forward_kinematics(model, jnp.eye(4, dtype=jnp.float64),
                                   angles.reshape(15, 3), 1.0)
            return jnp.sum((j - target) ** 2)

        angles0 = 0.1 * np.random.default_rng(2).normal(size=(45,))
        check_grad(lambda a: f(a), angles0, rtol=5e-4)

    def test_reprojection_residual(self):
        # Pinhole projection grad wrt the 3-D point (the BA residual core).
        from perception.geometry.camera import PinholeCamera

        cam = PinholeCamera.d435_color()
        obs = jnp.asarray([300.0, 200.0], jnp.float64)

        def f(p):
            uv = cam.project(p)
            return jnp.sum((uv - obs) ** 2)

        check_grad(f, np.array([0.1, -0.05, 0.9]), rtol=5e-4)

    @pytest.mark.slow  # ~11 s on the 2-core CI host (CI-budget triage, r5)
    def test_pose_loss_params(self):
        # A tiny conv net's loss vs finite differences on a weight slice
        # — the literal Caffe layer-check, via the training loss.
        import flax.linen as nn
        from perception.models.train import pose_loss

        class Tiny(nn.Module):
            @nn.compact
            def __call__(self, x):
                h = nn.Conv(4, (3, 3), dtype=jnp.float64)(x)
                h = nn.relu(h)
                paf = nn.Conv(2, (1, 1), dtype=jnp.float64)(h)
                hm = nn.Conv(3, (1, 1), dtype=jnp.float64)(h)
                return paf, hm

        net = Tiny()
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.normal(size=(1, 8, 8, 3)))
        params = net.init(jax.random.key(0), x)
        batch = {
            "image": x,
            "paf": jnp.asarray(rng.normal(size=(1, 8, 8, 2))),
            "heatmap": jnp.asarray(rng.normal(size=(1, 8, 8, 3))),
        }
        flat, unravel = jax.flatten_util.ravel_pytree(params)

        def f(theta):
            return pose_loss(net.apply, unravel(jnp.asarray(theta)), batch)

        theta0 = np.asarray(flat, np.float64)
        # Check a slice of weights (full check is O(P) evals).
        idx = np.linspace(0, theta0.size - 1, 25).astype(int)
        auto = np.asarray(jax.grad(f)(jnp.asarray(theta0)))[idx]
        eps = 1e-6
        num = np.zeros(len(idx))
        for k, i in enumerate(idx):
            tp = theta0.copy(); tp[i] += eps
            tm = theta0.copy(); tm[i] -= eps
            num[k] = (float(f(tp)) - float(f(tm))) / (2 * eps)
        np.testing.assert_allclose(auto, num, rtol=1e-4, atol=1e-7)
