import numpy as np, jax, jax.numpy as jnp
from benchmarks.timing import bench_ms
from perception.ops import voxelhash

rng = np.random.RandomState(0)
m, nq = 32768, 307200
ref = rng.randn(m, 3).astype(np.float32)
ref[:, 2] = 0.2 * np.sin(ref[:, 0] * 3) * np.cos(ref[:, 1] * 3)
q = ref[rng.randint(0, m, nq)] + rng.randn(nq, 3).astype(np.float32) * 0.01
vh = voxelhash.build(jnp.asarray(ref), jnp.ones(m, bool), 0.06)
qj = jnp.asarray(q)

cold = jax.jit(lambda v, a: voxelhash.query(v, a, sort=True))
print(f"cold current: {bench_ms(cold, vh, qj, iters=10):.2f} ms")

# components
def sort2(v, a):
    cid = voxelhash._cell_ids(a, v.origin, v.cell_size, v.dims)
    _, o = jax.lax.sort((cid, jnp.arange(nq, dtype=jnp.int32)), num_keys=1)
    return a[o]
print(f"sort2 + rowgather: {bench_ms(jax.jit(sort2), vh, qj, iters=10):.2f} ms")

def sort5(v, a):
    cid = voxelhash._cell_ids(a, v.origin, v.cell_size, v.dims)
    _, x, y, z, o = jax.lax.sort(
        (cid, a[:, 0], a[:, 1], a[:, 2], jnp.arange(nq, dtype=jnp.int32)),
        num_keys=1)
    return jnp.stack([x, y, z], -1), o
print(f"sort5 (no gather): {bench_ms(jax.jit(sort5), vh, qj, iters=10):.2f} ms")

def unsort(v, a):
    o = jnp.arange(nq, dtype=jnp.int32)
    inv = jnp.zeros(nq, jnp.int32).at[o].set(o)
    idx = jnp.arange(nq, dtype=jnp.int32)
    return idx[inv], a[:, 0][inv]
print(f"unsort part: {bench_ms(jax.jit(unsort), vh, qj, iters=10):.2f} ms")
