import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception.geometry import se3
from perception.models.slam.backend import (
    BAProblem,
    PoseGraph,
    _proj_residuals,
    bundle_adjust,
    optimize_pose_graph,
    scale_gauge,
)

FX, FY, CX, CY = 525.0, 525.0, 319.5, 239.5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_ba_problem(M=4, L=60, noise_px=0.3, pose_noise=0.02, lm_noise=0.02, seed=0):
    rng = np.random.RandomState(seed)
    # Landmarks in front of the cameras.
    lms = np.stack([rng.uniform(-1, 1, L), rng.uniform(-0.8, 0.8, L), rng.uniform(2.0, 4.0, L)], 1)
    # Cameras translated along x, looking +z.
    poses = []
    for k in range(M):
        tw = np.array([0.3 * k, 0.0, 0.0, 0.0, 0.02 * k, 0.0], np.float32)
        poses.append(np.asarray(se3.se3_exp(jnp.asarray(tw))))
    poses = np.stack(poses)

    obs_pose, obs_lm, obs_uv = [], [], []
    for k in range(M):
        T_cw = np.linalg.inv(poses[k])
        pc = lms @ T_cw[:3, :3].T + T_cw[:3, 3]
        u = FX * pc[:, 0] / pc[:, 2] + CX
        v = FY * pc[:, 1] / pc[:, 2] + CY
        vis = (pc[:, 2] > 0.1) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
        for l in np.where(vis)[0]:
            obs_pose.append(k)
            obs_lm.append(l)
            obs_uv.append([u[l] + rng.randn() * noise_px, v[l] + rng.randn() * noise_px])
    O = len(obs_pose)

    # Perturb initial guesses (pose 0 stays exact = gauge anchor).
    poses_init = poses.copy()
    for k in range(1, M):
        pert = np.asarray(se3.se3_exp(jnp.asarray(rng.randn(6) * pose_noise, jnp.float32)))
        poses_init[k] = poses[k] @ pert
    lms_init = lms + rng.randn(L, 3) * lm_noise

    problem = BAProblem(
        poses_wc=jnp.asarray(poses_init, jnp.float32),
        landmarks=jnp.asarray(lms_init, jnp.float32),
        obs_pose=jnp.asarray(obs_pose, jnp.int32),
        obs_lm=jnp.asarray(obs_lm, jnp.int32),
        obs_uv=jnp.asarray(obs_uv, jnp.float32),
        obs_mask=jnp.ones(O, bool),
    )
    return problem, poses, lms


def test_ba_reduces_cost_and_recovers_poses():
    problem, gt_poses, gt_lms = make_ba_problem()
    res = bundle_adjust(problem, FX, FY, CX, CY, iterations=12)
    assert float(res.final_cost) < float(res.initial_cost) * 0.05
    assert float(res.final_cost) < 1.0  # ~ sub-pixel residual
    est = np.asarray(res.poses_wc)
    for k in range(len(gt_poses)):
        dt = np.linalg.norm(est[k][:3, 3] - gt_poses[k][:3, 3])
        assert dt < 0.02, f"pose {k}: {dt}"


def test_ba_noise_free_exact():
    problem, gt_poses, gt_lms = make_ba_problem(noise_px=0.0, seed=1)
    res = bundle_adjust(problem, FX, FY, CX, CY, iterations=15)
    assert float(res.final_cost) < 1e-4


def test_ba_respects_obs_mask():
    problem, gt_poses, gt_lms = make_ba_problem(seed=2)
    # Corrupt half the observations but mask them out: result unchanged-ish.
    O = problem.obs_uv.shape[0]
    bad_uv = problem.obs_uv.at[: O // 2].add(500.0)
    masked = problem._replace(obs_uv=bad_uv, obs_mask=jnp.arange(O) >= O // 2)
    res = bundle_adjust(masked, FX, FY, CX, CY, iterations=12)
    assert float(res.final_cost) < 2.0


def _window_problem(depth=False):
    sys.path.insert(0, REPO)
    import __graft_entry__

    return __graft_entry__.ba_window_problem(depth=depth)


def test_scale_gauge_is_a_flat_direction():
    # Move the window off the origin so camera 0's centre and rotation
    # are not trivial, then scale the world about that centre: moving
    # each camera along scale_gauge and each landmark away from the
    # centre by the same factor must leave every residual unchanged.
    problem, cam = _window_problem()
    A = np.asarray(se3.se3_exp(jnp.asarray([0.4, -0.3, 0.2, 0.1, -0.2, 0.3], jnp.float32)))
    poses = np.einsum("ij,kjl->kil", A, np.asarray(problem.poses_wc))
    lms = np.asarray(problem.landmarks) @ A[:3, :3].T + A[:3, 3]
    T_cw = se3.inverse(jnp.asarray(poses))
    g = np.asarray(scale_gauge(T_cw))
    assert np.abs(g[0]).max() < 1e-5 and np.abs(g[:, 3:]).max() == 0.0
    s = 0.05
    T_s = np.array(T_cw)
    T_s[:, :3, 3] += s * g[:, :3]
    C0 = poses[0, :3, 3]
    lms_s = lms + s * (lms - C0)
    args = (problem.obs_pose, problem.obs_lm, problem.obs_uv, problem.obs_mask) + cam
    r0, _, _ = _proj_residuals(T_cw, jnp.asarray(lms), *args)
    r1, _, _ = _proj_residuals(jnp.asarray(T_s), jnp.asarray(lms_s), *args)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r0), atol=2e-3)
    # A direction that is not the gauge moves the residuals.
    T_s[1, :3, 3] += 0.01
    r2, _, _ = _proj_residuals(jnp.asarray(T_s), jnp.asarray(lms_s), *args)
    assert np.abs(np.asarray(r2) - np.asarray(r0)).max() > 0.5


@pytest.mark.parametrize("depth", [False, True], ids=["reprojection", "depth"])
def test_ba_window_converges_in_float32(depth):
    # The observations are exact: a float64 LM ends near 5e-11 px^2.
    # Without depth rows the scale is free, and before it was fixed the
    # float32 solve put rounding noise along it and stalled near 1e-2.
    problem, cam = _window_problem(depth)
    res = bundle_adjust(problem, *cam, iterations=4)
    assert float(res.initial_cost) > 5.0
    assert float(res.final_cost) < 1e-4
    err = np.abs(np.asarray(res.poses_wc) - np.asarray(problem.poses_wc)).max()
    assert err < 1e-4, err


def make_loop_graph(N=12, drift=0.02, seed=0):
    """Circle trajectory with drifting odometry + one loop closure."""
    rng = np.random.RandomState(seed)
    gt = []
    for k in range(N):
        ang = 2 * np.pi * k / N
        tw = np.array([np.cos(ang), np.sin(ang), 0.0, 0.0, 0.0, ang], np.float32)
        gt.append(np.asarray(se3.se3_exp(jnp.asarray(tw))))
    gt = np.stack(gt)

    # Odometry edges with drift; loop edge exact.
    ei, ej, eT = [], [], []
    poses_init = [gt[0]]
    for k in range(N - 1):
        rel = np.linalg.inv(gt[k]) @ gt[k + 1]
        noisy = rel @ np.asarray(se3.se3_exp(jnp.asarray(rng.randn(6) * drift, jnp.float32)))
        ei.append(k); ej.append(k + 1); eT.append(noisy)
        poses_init.append(poses_init[-1] @ noisy)
    # Loop closure N-1 -> 0, measured exactly.
    ei.append(N - 1); ej.append(0)
    eT.append(np.linalg.inv(gt[N - 1]) @ gt[0])

    graph = PoseGraph(
        poses_wc=jnp.asarray(np.stack(poses_init), jnp.float32),
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        edge_T=jnp.asarray(np.stack(eT), jnp.float32),
        edge_weight=jnp.ones(len(ei)),
        edge_mask=jnp.ones(len(ei), bool),
    )
    return graph, gt


def test_pose_graph_closes_loop():
    graph, gt = make_loop_graph()
    opt, c0, c1 = optimize_pose_graph(graph, iterations=15)
    assert float(c1) < float(c0) * 0.2
    # The loop-closure discrepancy must shrink.
    est = np.asarray(opt)
    before = np.asarray(graph.poses_wc)
    gap_before = np.linalg.norm((np.linalg.inv(before[-1]) @ before[0])[:3, 3] -
                                 (np.linalg.inv(gt[-1]) @ gt[0])[:3, 3])
    gap_after = np.linalg.norm((np.linalg.inv(est[-1]) @ est[0])[:3, 3] -
                                (np.linalg.inv(gt[-1]) @ gt[0])[:3, 3])
    assert gap_after < gap_before * 0.5


@pytest.mark.slow
def test_pose_graph_scales_to_256_nodes():
    # VERDICT r1 item 8: per-edge Jacobian blocks + scatter assembly
    # must handle N=256 (the old dense jacfwd materialized (6E, 6N)).
    graph, gt = make_loop_graph(N=256, drift=0.01, seed=3)
    opt, c0, c1 = optimize_pose_graph(graph, iterations=8)
    assert float(c1) < float(c0) * 0.2
    est = np.asarray(opt)
    gap = np.linalg.norm((np.linalg.inv(est[-1]) @ est[0])[:3, 3] -
                         (np.linalg.inv(gt[-1]) @ gt[0])[:3, 3])
    before = np.asarray(graph.poses_wc)
    gap_before = np.linalg.norm((np.linalg.inv(before[-1]) @ before[0])[:3, 3] -
                                 (np.linalg.inv(gt[-1]) @ gt[0])[:3, 3])
    assert gap < gap_before * 0.5


@pytest.mark.slow  # ~10-12 s on the 2-core CI host (CI-budget triage, r5)
def test_pose_graph_masked_edges_ignored():
    # A corrupted-but-masked edge must not move the solution.
    graph, gt = make_loop_graph(seed=4)
    E = graph.edge_i.shape[0]
    bad = PoseGraph(
        poses_wc=graph.poses_wc,
        edge_i=jnp.concatenate([graph.edge_i, jnp.asarray([0], jnp.int32)]),
        edge_j=jnp.concatenate([graph.edge_j, jnp.asarray([5], jnp.int32)]),
        edge_T=jnp.concatenate([graph.edge_T, jnp.eye(4)[None] * 1.0]),
        edge_weight=jnp.concatenate([graph.edge_weight, jnp.asarray([100.0])]),
        edge_mask=jnp.concatenate([graph.edge_mask, jnp.asarray([False])]),
    )
    opt_a, _, _ = optimize_pose_graph(graph, iterations=8)
    opt_b, _, _ = optimize_pose_graph(bad, iterations=8)
    np.testing.assert_allclose(np.asarray(opt_a), np.asarray(opt_b), atol=1e-5)


@pytest.mark.slow  # ~10-13 s on the 2-core CI host (CI-budget triage, r5)
def test_pose_graph_perfect_edges_noop():
    graph, gt = make_loop_graph(drift=0.0)
    opt, c0, c1 = optimize_pose_graph(graph, iterations=5)
    assert float(c0) < 1e-8
    np.testing.assert_allclose(np.asarray(opt), np.asarray(graph.poses_wc), atol=1e-4)
