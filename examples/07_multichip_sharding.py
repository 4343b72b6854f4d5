"""Example 07 — multi-device sharding on a virtual device mesh.

The distributed runtime (no reference equivalent — Caffe's NCCL was
single-host data-parallel only): a (dp, sp) `jax.sharding.Mesh`, frames
sharded over dp and points over sp, point-to-plane GN-ICP with the 6x6
normal equations psum-reduced over the mesh under `shard_map`. Runs on
8 virtual CPU devices here; the identical code runs over the cards of
a multi-GPU host.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples._common import setup_backend  # noqa: E402

setup_backend()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from perception.geometry import se3  # noqa: E402
from perception.ops.normals import normals_knn  # noqa: E402
from perception.parallel.icp_dist import make_distributed_icp_step  # noqa: E402
from perception.parallel.mesh import frame_sharding, make_mesh  # noqa: E402


def main() -> None:
    n = len(jax.devices())
    sp = 2 if n % 2 == 0 else 1
    dp = n // sp
    mesh = make_mesh(dp=dp, sp=sp, devices=jax.devices()[: dp * sp])
    print(f"mesh: {dp} x {sp} over {dp * sp} {jax.devices()[0].platform} devices")

    B, N, M = 2 * dp, 128 * sp, 256
    target = jax.random.uniform(jax.random.key(0), (M, 3), minval=-0.3, maxval=0.3)
    target = target.at[: M // 2, 2].set(0.0).at[M // 2:, 1].set(0.0)
    tgt_mask = jnp.ones(M, bool)
    tgt_normals, _ = normals_knn(target, tgt_mask, k=8)

    # B frames = the target seen under random small motions.
    twists = jax.random.normal(jax.random.key(1), (B, 6)) * 0.02
    Ts = se3.se3_exp(twists)
    sel = jax.random.randint(jax.random.key(2), (B, N), 0, M)
    frames = jax.vmap(lambda T, s: se3.transform_points(se3.inverse(T), target[s]))(Ts, sel)

    step = make_distributed_icp_step(mesh, iterations=6)
    fs = frame_sharding(mesh)
    res = step(
        jax.device_put(frames, fs),
        jax.device_put(jnp.ones((B, N), bool), fs),
        jnp.broadcast_to(jnp.eye(4), (B, 4, 4)),
        target, tgt_normals, tgt_mask,
    )
    jax.block_until_ready(res)

    err = jnp.max(jnp.abs(res.transforms - Ts))
    print(f"{B} frames x {N} points: mean residual "
          f"{float(res.mean_residual):.2e}, max pose error {float(err):.2e}")
    assert float(err) < 5e-3


if __name__ == "__main__":
    main()
