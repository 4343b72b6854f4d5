"""Nearest-neighbor crossover: brute force vs voxel-hash grid.

North-star evidence for "batched voxel-hash NN-gather kernels replacing
PCL's KD-tree" (reference KD-tree use:
cuboid_detection/src/iterative_closest_point.cpp:170-178). Two hash
timings per shape:

  hash_warm — queries pre-sorted into cell order (``sort=False``): the
      production ICP regime, where the source cloud is sorted once per
      frame (ops/voxelhash.sort_by_cell) and every Gauss-Newton
      iteration queries in that layout.
  hash_cold — shuffled queries with the coherence sort inside the
      timed call (worst case: no reusable order).

Agreement is INDEX-EXACT against a float64 scipy cKDTree oracle,
restricted to queries whose true NN is within the hash radius (the
structure's contract). Timing uses benchmarks.timing.bench_ms.

Run: python -m benchmarks.nn_crossover
"""

from __future__ import annotations

import numpy as np

from benchmarks.timing import bench_ms

DEFAULT_SIZES = [(4096, 8192), (4096, 32768), (4096, 131072),
                 (16384, 131072), (307200, 32768), (307200, 131072)]


def _cloud(rng, m):
    """Surface-like cloud (2-D manifold in 3-D) with a dense Gaussian
    center — realistic density plus the r3 stress case."""
    ref = rng.randn(m, 3).astype(np.float32)
    ref[:, 2] = 0.2 * np.sin(ref[:, 0] * 3) * np.cos(ref[:, 1] * 3)
    return ref


def measure(sizes=None, iters=10) -> list:
    import jax
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from perception.ops import nn as _nn
    from perception.ops import voxelhash

    rng = np.random.RandomState(0)
    radius = 0.06
    rows = []
    for nq, m in sizes or DEFAULT_SIZES:
        ref = _cloud(rng, m)
        q = ref[rng.randint(0, m, nq)] + rng.randn(nq, 3).astype(np.float32) * 0.01
        refj, qj = jnp.asarray(ref), jnp.asarray(q)
        mask = jnp.ones(m, bool)

        brute = jax.jit(lambda a, b, c: _nn.nearest_neighbor(a, b, c))
        t_brute = bench_ms(brute, qj, refj, mask, iters=iters)

        vh = voxelhash.build(refj, mask, cell_size=radius)
        cold = jax.jit(lambda v, a: voxelhash.query(v, a, sort=True))
        t_cold = bench_ms(cold, vh, qj, iters=iters)

        q_sorted, order_q = voxelhash.sort_by_cell(vh, qj)
        warm = jax.jit(lambda v, a: voxelhash.query(v, a, sort=False))
        t_warm = bench_ms(warm, vh, q_sorted, iters=iters)

        # Index-exact agreement vs f64 KD-tree oracle.
        tree = cKDTree(ref.astype(np.float64))
        od, oi = tree.query(q.astype(np.float64))
        in_r = od <= radius

        hi, hd = cold(vh, qj)
        order = np.asarray(vh.order)
        agree_cold = float(np.mean(order[np.asarray(hi)][in_r] == oi[in_r]))

        wi, wd = warm(vh, q_sorted)
        oq = np.asarray(order_q)
        # Agreement restricted to in-radius queries, in sorted layout.
        in_r_s = od[oq] <= radius
        agree_warm = float(np.mean(
            (order[np.asarray(wi)] == oi[oq])[in_r_s]))

        rows.append({
            "nq": nq, "m": m,
            "brute_ms": round(t_brute, 3),
            "hash_warm_ms": round(t_warm, 3),
            "hash_cold_ms": round(t_cold, 3),
            "speedup_warm": round(t_brute / t_warm, 2),
            "speedup_cold": round(t_brute / t_cold, 2),
            "agree_pct": round(agree_warm * 100, 1),
            "agree_cold_pct": round(agree_cold * 100, 1),
        })
    return rows


def main() -> None:
    rows = measure()
    print(f"{'Nq':>8} {'M':>8} {'brute':>9} {'hash_warm':>10} {'hash_cold':>10} "
          f"{'x_warm':>7} {'x_cold':>7} {'agree':>7}")
    for r in rows:
        print(f"{r['nq']:>8} {r['m']:>8} {r['brute_ms']:>8.2f}m "
              f"{r['hash_warm_ms']:>9.2f}m {r['hash_cold_ms']:>9.2f}m "
              f"{r['speedup_warm']:>6.2f}x {r['speedup_cold']:>6.2f}x "
              f"{r['agree_pct']:>6.1f}%")


if __name__ == "__main__":
    main()
