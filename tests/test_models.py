import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.geometry import se3
from perception.geometry.camera import PinholeCamera
from perception.io.templates import cuboid_template
from perception.models.cuboid import (
    CuboidConfig,
    cuboid_pipeline_step,
    segment_ground_plane,
)
from perception.models.objects import ObjectConfig, detect_object
from perception.models.surface_frame import estimate_surface_frame


def tabletop_scene(key_seed=0, obj_twists=((0.08, 0.04, 0.83, 0.0, 0.0, 0.4),),
                   template_dims=(0.2, 0.1, 0.03), n_table=15000, noise=0.0015):
    rng = np.random.RandomState(key_seed)
    table = np.stack(
        [rng.uniform(-0.35, 0.35, n_table), rng.uniform(-0.3, 0.3, n_table), np.full(n_table, 0.85)], 1
    )
    tmpl = cuboid_template(*template_dims, density=0.004)
    objs, gts = [], []
    for tw in obj_twists:
        T = np.asarray(se3.se3_exp(jnp.asarray(tw, jnp.float32)))
        objs.append(tmpl @ T[:3, :3].T + T[:3, 3])
        gts.append(T)
    cloud = np.concatenate([table] + objs).astype(np.float32)
    cloud += rng.randn(*cloud.shape) * noise
    return jnp.asarray(cloud), jnp.ones(len(cloud), bool), jnp.asarray(tmpl), gts


def pose_errors(pose, gt):
    pose, gt = np.asarray(pose), np.asarray(gt)
    dt = np.linalg.norm(pose[:3, 3] - gt[:3, 3])
    dR = np.degrees(np.arccos(np.clip((np.trace(pose[:3, :3].T @ gt[:3, :3]) - 1) / 2, -1, 1)))
    return dt, dR


def test_segment_ground_plane():
    pts, mask, tmpl, gts = tabletop_scene()
    fit, dpts, box_mask = segment_ground_plane(pts, mask, jax.random.key(0))
    assert bool(fit.valid)
    c = np.asarray(fit.coefficients)
    c = c if c[2] > 0 else -c
    np.testing.assert_allclose(c[2], 1.0, atol=0.01)
    np.testing.assert_allclose(-c[3], 0.85, atol=0.01)
    # The off-plane points are the object.
    assert 100 < int(box_mask.sum()) < 3000


def test_cuboid_pipeline_recovers_pose():
    pts, mask, tmpl, gts = tabletop_scene()
    tm = jnp.ones(len(tmpl), bool)
    res = cuboid_pipeline_step(pts, mask, tmpl, tm, jax.random.key(1))
    assert bool(res.accepted)
    dt, dR = pose_errors(res.pose, gts[0])
    # Cuboid symmetry: 180-deg yaw flips are pose-equivalent for the
    # 3-face template's bbox; accept either by checking bbox overlap.
    assert float(res.fitness) < 4e-4
    assert dt < 0.015
    assert res.bbox.shape == (8, 3)
    # bbox center should sit at the pose translation.
    np.testing.assert_allclose(np.asarray(res.bbox).mean(0), np.asarray(res.pose)[:3, 3], atol=1e-5)


def test_cuboid_pipeline_rejects_empty_scene():
    # Table only, no object: plane seg leaves nothing -> not accepted.
    rng = np.random.RandomState(3)
    n = 8000
    table = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.25, 0.25, n), np.full(n, 0.85)], 1)
    pts = jnp.asarray(table + rng.randn(n, 3) * 0.001, jnp.float32)
    mask = jnp.ones(n, bool)
    tmpl = jnp.asarray(cuboid_template(0.2, 0.1, 0.03, 0.004))
    tm = jnp.ones(len(tmpl), bool)
    res = cuboid_pipeline_step(pts, mask, tmpl, tm, jax.random.key(4))
    assert not bool(res.accepted)


def test_cuboid_pipeline_jits():
    pts, mask, tmpl, gts = tabletop_scene()
    tm = jnp.ones(len(tmpl), bool)
    f = jax.jit(lambda p, m, t, tmk, k: cuboid_pipeline_step(p, m, t, tmk, k))
    res = f(pts, mask, tmpl, tm, jax.random.key(1))
    assert bool(res.accepted)


def test_surface_frame_orthonormal():
    pts, mask, tmpl, gts = tabletop_scene()
    fit, dpts, box_mask = segment_ground_plane(pts, mask, jax.random.key(0))
    gn = fit.coefficients[:3]
    sf = estimate_surface_frame(dpts, box_mask, gn, jax.random.key(5))
    R = np.asarray(sf.pose)[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert np.linalg.det(R) > 0.99  # right-handed
    # Origin near the object centroid (gt xy ~ (0.08, 0.04), z ~ 0.82).
    origin = np.asarray(sf.pose)[:3, 3]
    assert abs(origin[0] - 0.08) < 0.05 and abs(origin[1] - 0.04) < 0.05


@pytest.mark.slow
def test_detect_object_finds_cluster():
    # Objects 4 cm above the table so plane removal doesn't eat their
    # bottom faces (which would shrink clusters vs the template count —
    # the same effect the reference sees with its 1 cm RANSAC band).
    pts, mask, tmpl, gts = tabletop_scene(
        obj_twists=((0.08, 0.04, 0.81, 0.0, 0.0, 0.4), (-0.15, -0.1, 0.81, 0.0, 0.0, -0.5))
    )
    tm = jnp.ones(len(tmpl), bool)
    cfg = ObjectConfig(voxel_size=0.005, cluster_min_size=100, size_gate=400, table_z_cut=0.845)
    res = detect_object(pts, mask, tmpl, tm, jax.random.key(6), cfg)
    assert int(res.num_clusters) == 2
    assert bool(res.success)
    assert float(res.fitness) < 1e-3
    # Winning pose lands on one of the two ground truths.
    dts = [pose_errors(res.pose, g)[0] for g in gts]
    assert min(dts) < 0.08


@pytest.mark.slow
def test_detect_object_fails_on_size_gate():
    pts, mask, tmpl, gts = tabletop_scene()
    tm = jnp.ones(len(tmpl), bool)
    # Absurdly tight gate -> no cluster matches the template size.
    cfg = ObjectConfig(voxel_size=0.005, cluster_min_size=100, size_gate=1, table_z_cut=0.845)
    res = detect_object(pts, mask, tmpl, tm, jax.random.key(7), cfg)
    assert not bool(res.success)
    assert int(res.cluster_id) == -1


@pytest.mark.slow  # ~10-13 s on the 2-core CI host (CI-budget triage, r5)
def test_pcl_parity_mode_switch():
    """CuboidConfig.pcl_parity() — one switch to reference budgets
    (5000-iter p2p ICP with eps early-exit, exact CC clustering) — must
    recover the same pose as the fast path on a clean scene."""
    pts, mask, tmpl, gts = tabletop_scene()
    tm = jnp.ones(len(tmpl), bool)
    cfg = CuboidConfig.pcl_parity()
    assert cfg.icp_mode == "p2p" and cfg.icp_max_iterations == 5000
    res = cuboid_pipeline_step(pts, mask, tmpl, tm, jax.random.key(1), cfg)
    assert bool(res.accepted)
    assert float(res.fitness) < 4e-4
    dt, _ = pose_errors(res.pose, gts[0])
    assert dt < 0.015
