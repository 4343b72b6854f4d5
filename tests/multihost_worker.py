"""Worker program for the 2-process CPU-mesh multi-host test.

Run as:  python multihost_worker.py <process_id> <num_processes> <port> <n_local>

Every process executes this same SPMD program (the multi-host contract):
it joins the distributed runtime via ``perception.parallel.multihost``,
builds ONE global (dp=num_processes, sp=n_local) mesh spanning all
processes, and runs the distributed ICP and BA steps with the
observation/frame data sharded across processes — the live equivalent of
the reference's NCCL worker fleet (``caffe/src/caffe/parallel.cpp:328``),
except the "hosts" are OS processes holding virtual CPU devices
(SURVEY.md §4(e)). Each process independently computes a single-device
reference on a private 1x1 mesh and asserts the cross-process result
matches, then prints machine-readable OK lines that
``tests/test_multihost.py`` checks.
"""

import os
import sys


def main() -> None:
    process_id, num_processes = int(sys.argv[1]), int(sys.argv[2])
    port, n_local = sys.argv[3], int(sys.argv[4])

    # The fleet runs on virtual CPU devices: pin the backend before the
    # first jax backend touch (never a second process on a GPU).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_local}"
    ).strip()
    import jax

    from perception.parallel import multihost

    multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
        local_device_count=n_local,
    )
    assert jax.process_index() == process_id
    assert jax.local_device_count() == n_local
    assert jax.device_count() == num_processes * n_local
    print(
        f"proc {process_id}: joined fleet "
        f"({jax.process_count()} processes x {n_local} devices)",
        flush=True,
    )

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from perception.geometry import se3
    from perception.ops.normals import normals_knn
    from perception.parallel.ba_dist import make_distributed_ba_step
    from perception.parallel.icp_dist import make_distributed_icp_step

    mesh = multihost.global_mesh(sp=n_local)
    assert mesh.shape == {"dp": num_processes, "sp": n_local}
    # Private single-device mesh for the per-process reference run.
    mesh1 = Mesh(
        np.asarray(jax.local_devices()[:1]).reshape(1, 1), axis_names=("dp", "sp")
    )

    # ---- distributed point-to-plane ICP, frames sharded across hosts ----
    B, N, M = 2 * num_processes, 1024, 2048
    rng = np.random.default_rng(7)  # identical data in every process
    target = rng.uniform(-0.3, 0.3, (M, 3)).astype(np.float32)
    target[: M // 3, 2] = 0.0
    target[M // 3 : 2 * M // 3, 1] = 0.0
    target[2 * M // 3 :, 0] = 0.0
    tgt_mask = np.ones(M, bool)
    tgt_normals = np.asarray(normals_knn(jnp.asarray(target), jnp.asarray(tgt_mask), k=10)[0])

    twists = (rng.standard_normal((B, 6)) * [0.02, 0.02, 0.02, 0.04, 0.04, 0.04]).astype(
        np.float32
    )
    Ts = np.asarray(se3.se3_exp(jnp.asarray(twists)))
    frames = np.stack(
        [
            np.asarray(
                se3.transform_points(
                    se3.inverse(jnp.asarray(Ts[b])),
                    jnp.asarray(target[rng.integers(0, M, N)]),
                )
            )
            for b in range(B)
        ]
    )
    masks = np.ones((B, N), bool)
    init_T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4))

    # Single-device reference (full data, private mesh — no cross-process
    # traffic).
    ref = make_distributed_icp_step(mesh1, iterations=6)(
        frames, masks, init_T, target, tgt_normals, tgt_mask
    )
    ref_T = np.asarray(ref.transforms)

    # Global run: each process contributes only ITS dp-rows of the batch.
    rows = slice(process_id * (B // num_processes), (process_id + 1) * (B // num_processes))
    g_frames = multihost.shard_host_data(mesh, P("dp", "sp"), frames[rows], (B, N, 3))
    g_masks = multihost.shard_host_data(mesh, P("dp", "sp"), masks[rows], (B, N))
    g_init = multihost.shard_host_data(mesh, P("dp"), init_T[rows], (B, 4, 4))
    g_target = multihost.replicate_host_data(mesh, target)
    g_normals = multihost.replicate_host_data(mesh, tgt_normals)
    g_tmask = multihost.replicate_host_data(mesh, tgt_mask)

    res = make_distributed_icp_step(mesh, iterations=6)(
        g_frames, g_masks, g_init, g_target, g_normals, g_tmask
    )
    # Replicate the dp-sharded transforms so every process can read them.
    gather = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))
    T_global = np.asarray(gather(res.transforms))
    err = float(np.max(np.abs(T_global - ref_T)))
    gt_err = float(np.max(np.abs(T_global - Ts)))
    assert err < 1e-4, f"sharded != single: {err}"
    assert gt_err < 0.01, f"ICP did not recover poses: {gt_err}"
    print(
        f"proc {process_id}: MULTIHOST ICP OK B={B} N={N} "
        f"err={err:.2e} gt_err={gt_err:.2e} corr={int(res.num_corr)}",
        flush=True,
    )

    # ---- distributed BA, observations sharded across the whole fleet ----
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_backend import FX, FY, CX, CY, make_ba_problem

    Mp, L = 4, 40
    problem, _, _ = make_ba_problem(M=Mp, L=L, seed=5)
    O = problem.obs_uv.shape[0]
    pad = (-O) % jax.device_count()
    if pad:
        problem = problem._replace(
            obs_pose=jnp.pad(problem.obs_pose, (0, pad)),
            obs_lm=jnp.pad(problem.obs_lm, (0, pad)),
            obs_uv=jnp.pad(problem.obs_uv, ((0, pad), (0, 0))),
            obs_mask=jnp.pad(problem.obs_mask, (0, pad)),
        )
    O = problem.obs_uv.shape[0]

    ref_ba = make_distributed_ba_step(mesh1, Mp, L, iterations=8)(problem, FX, FY, CX, CY)

    def shard_obs(x):
        x = np.asarray(x)
        loc = x[process_id * (O // num_processes) : (process_id + 1) * (O // num_processes)]
        return multihost.shard_host_data(mesh, P(("dp", "sp")), loc, x.shape)

    g_problem = problem._replace(
        poses_wc=multihost.replicate_host_data(mesh, np.asarray(problem.poses_wc)),
        landmarks=multihost.replicate_host_data(mesh, np.asarray(problem.landmarks)),
        obs_pose=shard_obs(problem.obs_pose),
        obs_lm=shard_obs(problem.obs_lm),
        obs_uv=shard_obs(problem.obs_uv),
        obs_mask=shard_obs(problem.obs_mask),
    )
    res_ba = make_distributed_ba_step(mesh, Mp, L, iterations=8)(g_problem, FX, FY, CX, CY)
    pose_err = float(np.max(np.abs(np.asarray(res_ba.poses_wc) - np.asarray(ref_ba.poses_wc))))
    c0, c1 = float(res_ba.initial_cost), float(res_ba.final_cost)
    # f32 psum summation-order noise through the Schur solve + LM
    # accept/reject branch — same tolerance as tests/test_ba_dist.py.
    assert pose_err < 0.05, f"BA sharded != single: {pose_err}"
    assert c1 < 0.1 * c0, f"BA did not reduce cost: {c0} -> {c1}"
    print(
        f"proc {process_id}: MULTIHOST BA OK O={O} err={pose_err:.2e} "
        f"cost={c0:.4f}->{c1:.6f}",
        flush=True,
    )

    multihost.sync("done")
    print(f"proc {process_id}: DONE", flush=True)


if __name__ == "__main__":
    main()
