"""Multi-object service robustness harness (VERDICT #9).

Cluttered 4-class synthetic tabletop with exact GT poses carried through
the reference's transforms.txt protocol; asserts per-class pose recovery
(chamfer between the template under the estimated vs GT pose — the
symmetry-safe error) and the <size-gate winner semantics at matched
voxel resolution (``object_pose_detection.cpp:415-429``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.clutter_scene import (
    OBJECT_CLASSES,
    captured_template,
    render_depth_clutter,
    standard_clutter_poses,
)
from perception.geometry.camera import PinholeCamera
from perception.io.gt_transforms import load_gt_transforms, save_gt_transforms
from perception.models.objects import ObjectConfig, detect_object

# Long e2e sweeps: run with `-m slow` (core suite excludes them).
pytestmark = pytest.mark.slow


def _half_camera() -> PinholeCamera:
    cam = dataclasses.replace(
        PinholeCamera.d435_depth(),
        fx=PinholeCamera.d435_depth().fx / 2,
        fy=PinholeCamera.d435_depth().fy / 2,
        cx=(PinholeCamera.d435_depth().cx) / 2,
        cy=(PinholeCamera.d435_depth().cy) / 2,
        width=320,
        height=240,
    )
    return cam


# CPU-feasible capacities; min cluster size and the winner gate scaled
# to the 4 mm voxel / half-res camera (the reference's 200-point floor
# and 250-point gate assume its 1 mm leaf at 640x480). The gate must
# also absorb viewpoint self-occlusion between the capture pose and the
# scene pose (worst observed: the L-shaped clamp at ~88 points).
_CFG = ObjectConfig(
    cluster_min_size=12,
    cluster_capacity=1024,
    ransac_hypotheses=256,
    icp_restarts=3,
    icp_max_iterations=40,
    size_gate=120,
)


def _chamfer_cm(template, est_pose, gt_pose) -> float:
    from scipy.spatial import cKDTree

    tp = np.asarray(template)
    a = tp @ np.asarray(est_pose)[:3, :3].T + np.asarray(est_pose)[:3, 3]
    b = tp @ np.asarray(gt_pose)[:3, :3].T + np.asarray(gt_pose)[:3, 3]
    return float(cKDTree(b).query(a)[0].mean() * 100.0)


@pytest.fixture(scope="module")
def clutter():
    cam = _half_camera()
    poses = standard_clutter_poses()
    depth = render_depth_clutter(cam, poses, seed=3)
    pts, mask = cam.backproject_depth(jnp.asarray(depth))
    return cam, poses, pts, mask


@pytest.fixture(scope="module")
def gt_via_protocol(clutter, tmp_path_factory):
    """GT poses written and re-read through the transforms.txt protocol
    — the harness consumes what the file format preserves."""
    _, poses, _, _ = clutter
    path = tmp_path_factory.mktemp("gt") / "transforms.txt"
    save_gt_transforms(path, poses)
    return load_gt_transforms(path)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(OBJECT_CLASSES))
def test_per_class_pose_recovery(clutter, gt_via_protocol, name):
    cam, _, pts, mask = clutter
    # Captured templates, the reference's workflow: the .pcd the service
    # loads is a sensor capture of the object, so cluster and template
    # are like-for-like partial views (both for ICP overlap and for the
    # point-count winner gate).
    tmpl = jnp.asarray(captured_template(name, cam))
    tm = jnp.ones(len(tmpl), bool)
    res = detect_object(pts, mask, tmpl, tm, jax.random.key(0), _CFG)
    assert bool(res.success), (
        f"{name}: success=False size_diff={int(res.size_diff)} "
        f"nclusters={int(res.num_clusters)}"
    )
    err = _chamfer_cm(tmpl, res.pose, gt_via_protocol[name])
    assert err < 1.0, f"{name}: chamfer {err:.2f} cm"


@pytest.mark.slow
def test_size_gate_rejects_absent_class(clutter):
    """A template whose size matches no cluster must fail the <gate
    winner semantics, not return a bogus pose."""
    _, _, pts, mask = clutter
    # A big plate: far larger than any clutter cluster.
    from perception.io.templates import box_surface_template

    tmpl = jnp.asarray(box_surface_template((0.3, 0.3, 0.02), 0.003))
    tm = jnp.ones(len(tmpl), bool)
    res = detect_object(pts, mask, tmpl, tm, jax.random.key(0), _CFG)
    assert not bool(res.success)
    assert int(res.cluster_id) == -1


@pytest.mark.slow
def test_clusters_found_matches_scene(clutter):
    cam, _, pts, mask = clutter
    tmpl = jnp.asarray(captured_template("eraser", cam))
    tm = jnp.ones(len(tmpl), bool)
    res = detect_object(pts, mask, tmpl, tm, jax.random.key(0), _CFG)
    # 4 objects on the table -> 4 clusters (clamp may split at worst).
    assert 4 <= int(res.num_clusters) <= 6
