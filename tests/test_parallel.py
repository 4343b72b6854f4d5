import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.geometry import se3
from perception.parallel.mesh import make_mesh, frame_sharding, replicated
from perception.parallel.icp_dist import make_distributed_icp_step
from perception.ops.normals import normals_knn


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(dp=4, sp=2)


def structured_cloud(key, n):
    pts = jax.random.uniform(key, (n, 3), minval=-0.3, maxval=0.3)
    third = n // 3
    pts = pts.at[:third, 2].set(0.0)
    pts = pts.at[third : 2 * third, 1].set(0.0)
    pts = pts.at[2 * third :, 0].set(0.0)
    return pts


def test_mesh_shapes():
    m = make_mesh(dp=4, sp=2)
    assert m.shape == {"dp": 4, "sp": 2}
    with pytest.raises(ValueError):
        make_mesh(dp=3, sp=2)


@pytest.mark.slow
def test_distributed_icp_recovers_poses(mesh):
    B, N = 8, 1024  # B divisible by dp=4, N by sp=2
    target = structured_cloud(jax.random.key(0), 2048)
    tgt_mask = jnp.ones(2048, bool)
    tgt_normals, _ = normals_knn(target, tgt_mask, k=10)

    twists = jax.random.normal(jax.random.key(1), (B, 6)) * jnp.array(
        [0.03, 0.03, 0.03, 0.05, 0.05, 0.05]
    )
    Ts = se3.se3_exp(twists)  # (B, 4, 4) frame poses to recover
    # Each frame samples N points of the target and moves them by T^-1.
    keys = jax.random.split(jax.random.key(2), B)
    frames = []
    for b in range(B):
        sel = jax.random.randint(keys[b], (N,), 0, 2048)
        frames.append(se3.transform_points(se3.inverse(Ts[b]), target[sel]))
    frames = jnp.stack(frames)
    masks = jnp.ones((B, N), bool)
    init_T = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))

    step = make_distributed_icp_step(mesh, iterations=10)
    fs = frame_sharding(mesh)
    frames = jax.device_put(frames, fs)
    masks = jax.device_put(masks, fs)
    res = step(frames, masks, init_T, target, tgt_normals, tgt_mask)

    assert res.transforms.shape == (B, 4, 4)
    for b in range(B):
        err = se3.se3_log(res.transforms[b] @ se3.inverse(Ts[b]))
        assert float(jnp.linalg.norm(err)) < 5e-3, f"frame {b}"
    assert float(res.mean_residual) < 1e-3
    assert int(res.num_corr) == B * N


def test_distributed_matches_single_device(mesh):
    # The sharded computation must equal the same math on one device.
    B, N = 4, 512
    target = structured_cloud(jax.random.key(3), 1024)
    tgt_mask = jnp.ones(1024, bool)
    tgt_normals, _ = normals_knn(target, tgt_mask, k=10)
    twists = jax.random.normal(jax.random.key(4), (B, 6)) * 0.02
    Ts = se3.se3_exp(twists)
    frames = jnp.stack(
        [se3.transform_points(se3.inverse(Ts[b]), target[:N]) for b in range(B)]
    )
    masks = jnp.ones((B, N), bool)
    init_T = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))

    step = make_distributed_icp_step(mesh, iterations=5)
    res_mesh = step(
        jax.device_put(frames, frame_sharding(mesh)),
        jax.device_put(masks, frame_sharding(mesh)),
        init_T, target, tgt_normals, tgt_mask,
    )

    mesh1 = make_mesh(dp=1, sp=1, devices=jax.devices()[:1])
    step1 = make_distributed_icp_step(mesh1, iterations=5)
    res_one = step1(frames, masks, init_T, target, tgt_normals, tgt_mask)

    np.testing.assert_allclose(
        np.asarray(res_mesh.transforms), np.asarray(res_one.transforms), atol=2e-5
    )
