import numpy as np, jax, jax.numpy as jnp
from benchmarks.timing import bench_ms
from perception.ops import voxelhash
from scipy.spatial import cKDTree

rng = np.random.RandomState(0)
m, nq = 32768, 307200
ref = rng.randn(m, 3).astype(np.float32)
ref[:, 2] = 0.2 * np.sin(ref[:, 0] * 3) * np.cos(ref[:, 1] * 3)
q = ref[rng.randint(0, m, nq)] + rng.randn(nq, 3).astype(np.float32) * 0.01
vh = voxelhash.build(jnp.asarray(ref), jnp.ones(m, bool), 0.06)
qj = jnp.asarray(q)
cold = jax.jit(lambda v, a: voxelhash.query(v, a, sort=True))
print(f"cold new: {bench_ms(cold, vh, qj, iters=10):.2f} ms")
idx, d2 = cold(vh, qj)
od, oi = cKDTree(ref.astype(np.float64)).query(q.astype(np.float64))
in_r = od <= 0.06
agree = np.mean(np.asarray(vh.order)[np.asarray(idx)][in_r] == oi[in_r])
print(f"agree: {agree*100:.1f}%")
