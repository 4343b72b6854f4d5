import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import NamedSharding, PartitionSpec as P

from perception.models.slam.backend import bundle_adjust
from perception.parallel.ba_dist import make_distributed_ba_step
from perception.parallel.mesh import make_mesh

from test_backend import FX, FY, CX, CY, make_ba_problem


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(dp=4, sp=2)


def pad_problem(problem, multiple=8):
    """Pad observations so the count divides the device count."""
    O = problem.obs_uv.shape[0]
    pad = (-O) % multiple
    if pad == 0:
        return problem
    return problem._replace(
        obs_pose=jnp.pad(problem.obs_pose, (0, pad)),
        obs_lm=jnp.pad(problem.obs_lm, (0, pad)),
        obs_uv=jnp.pad(problem.obs_uv, ((0, pad), (0, 0))),
        obs_mask=jnp.pad(problem.obs_mask, (0, pad)),
    )


def _shard(problem, mesh):
    spec = NamedSharding(mesh, P(("dp", "sp")))
    return problem._replace(
        obs_pose=jax.device_put(problem.obs_pose, spec),
        obs_lm=jax.device_put(problem.obs_lm, spec),
        obs_uv=jax.device_put(problem.obs_uv, spec),
        obs_mask=jax.device_put(problem.obs_mask, spec),
    )


def test_distributed_single_iteration_matches(mesh):
    # One GN iteration: the psum'd blocks must equal the single-device
    # segment sums to float tolerance (before LM branching can amplify
    # summation-order noise).
    problem, _, _ = make_ba_problem(M=4, L=40, seed=5)
    problem = pad_problem(problem)
    res_single = bundle_adjust(problem, FX, FY, CX, CY, iterations=1)
    step = make_distributed_ba_step(mesh, 4, 40, iterations=1)
    res_dist = step(_shard(problem, mesh), FX, FY, CX, CY)
    # f32 summation-order differences (psum of shard partials vs one
    # segment_sum) pass through the 24x24 Schur solve; ~mm-level noise
    # is the float floor here, not an algorithmic divergence.
    np.testing.assert_allclose(
        np.asarray(res_dist.poses_wc), np.asarray(res_single.poses_wc), atol=5e-3
    )
    np.testing.assert_allclose(
        float(res_dist.initial_cost), float(res_single.initial_cost), rtol=1e-4
    )


def test_distributed_ba_matches_single_device(mesh):
    # Full LM runs: summation order differs between the psum'd shards
    # and the single-device reduction, and the accept/reject branch
    # amplifies ULP noise — require matching quality, not bit equality.
    problem, gt_poses, gt_lms = make_ba_problem(M=4, L=40, seed=5)
    problem = pad_problem(problem)
    res_single = bundle_adjust(problem, FX, FY, CX, CY, iterations=8)
    step = make_distributed_ba_step(mesh, 4, 40, iterations=8)
    res_dist = step(_shard(problem, mesh), FX, FY, CX, CY)
    np.testing.assert_allclose(
        np.asarray(res_dist.poses_wc), np.asarray(res_single.poses_wc), atol=0.05
    )
    assert float(res_dist.final_cost) < float(res_single.initial_cost) * 0.1


def test_distributed_ba_reduces_cost(mesh):
    problem, _, _ = make_ba_problem(M=4, L=40, seed=6)
    problem = pad_problem(problem)
    step = make_distributed_ba_step(mesh, 4, 40, iterations=10)
    res = step(_shard(problem, mesh), FX, FY, CX, CY)
    assert float(res.final_cost) < float(res.initial_cost) * 0.1
